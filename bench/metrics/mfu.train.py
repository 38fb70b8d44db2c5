"""The whole training step's share of the card's bf16 peak: the model's
operations a step (``train_flops`` of the configuration's count: 6 N T
with the tied table once, plus three times attention's quadratic term)
times the traced steps, over the traced window's seconds and 989 TFLOP/s,
in percent."""


def read(rec):
    if rec["kind"] != "train" or rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    t = rec["traffic"]
    flops = rec["model_counts"].train_flops(rec["run"], t["batch"], t["seq_len"])
    return 100.0 * flops * rec["steps"] / (rec["window_s"] * rec["peaks"]["bf16_flops"])
