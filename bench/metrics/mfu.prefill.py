"""The whole prefill's share of the card's bf16 peak: the model's
operations a request (``prefill_flops`` of the configuration's count: 2 N T
without the table, the last position's unembedding and attention's
quadratic term) times the traced requests, over the traced window's
seconds and 989 TFLOP/s, in percent."""


def read(rec):
    if rec["kind"] != "prefill" or rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    t = rec["traffic"]
    flops = rec["model_counts"].prefill_flops(rec["run"], t["batch"], t["seq_len"])
    return 100.0 * flops * rec["steps"] / (rec["window_s"] * rec["peaks"]["bf16_flops"])
