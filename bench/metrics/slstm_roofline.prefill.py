"""The sLSTM scan kernel's share of its bound in a prefill: the least time
its launches in the traced window could take (each launch's operations at
the FP32 rate or its bytes at the memory's rate, whichever is larger:
``bench/counts/slstm.py``; a prefill keeps only the final state) over the
time they took, in percent."""
from bench.counts import slstm


def read(rec):
    if rec["kind"] != "prefill":
        return None
    fwd = [v for k, v in rec["kernels"].items() if "slstm_forward" in k]
    took = sum(s for _, s in fwd)
    if took <= 0:
        return None
    run, t, peaks = rec["run"], rec["traffic"], rec["peaks"]
    B, S, d, H = t["batch"], t["seq_len"], run["d_model"], run["n_heads"]
    bound = slstm.bound_s(slstm.ops(B, S, d, H), slstm.bytes_forward(B, S, d, H, False), peaks)
    return 100.0 * sum(c for c, _ in fwd) * bound / took
