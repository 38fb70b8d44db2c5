"""The sLSTM scan kernels' share of their bound in training: the least
time their launches in the traced window could take (each launch's
operations at the FP32 rate or its bytes at the memory's rate, whichever
is larger: ``bench/counts/slstm.py``; the forward keeps every step's state
for the backward) over the time they took, in percent."""
from bench.counts import slstm


def read(rec):
    if rec["kind"] != "train":
        return None
    fwd = [v for k, v in rec["kernels"].items() if "slstm_forward" in k]
    bwd = [v for k, v in rec["kernels"].items() if "slstm_backward" in k]
    took = sum(s for _, s in fwd + bwd)
    if took <= 0:
        return None
    run, t, peaks = rec["run"], rec["traffic"], rec["peaks"]
    B, S, d, H = t["batch"], t["seq_len"], run["d_model"], run["n_heads"]
    ops = slstm.ops(B, S, d, H)
    bound = (sum(c for c, _ in fwd) * slstm.bound_s(ops, slstm.bytes_forward(B, S, d, H, True), peaks)
             + sum(c for c, _ in bwd) * slstm.bound_s(ops, slstm.bytes_backward(B, S, d, H), peaks))
    return 100.0 * bound / took
