"""The benchmark's counts against hand values, and the readers' shares."""
import pytest

import bench_smoke as S
from bench.counts import lm, slstm
from bench.harness.peaks import PEAKS

XL = S.MAN.config("xlstm350m")["run"]
PHI = S.MAN.config("phi4mini")["run"]


def test_slstm_at_the_prefill_shape():
    ops = slstm.ops(8, 2048, 1024, 4)
    assert ops == 2 * 8 * 4 * 256 * 1024 * 2048 == 34_359_738_368  # 34.4 GFLOP
    fwd = slstm.bytes_forward(8, 2048, 1024, 4, save=False)
    assert fwd == 4 * (8 * 2048 * 4096 + 4 * 1024 * 256 + 4 * 8 * 1024 + 8 * 2048 * 1024
                       + 3 * 8 * 1024)
    bound = slstm.bound_s(ops, fwd, PEAKS)
    assert bound == ops / 67e12 and bound == pytest.approx(0.513e-3, rel=1e-3)
    # the bound is the operations' either way, and in training too
    for b in (slstm.bytes_forward(8, 2048, 1024, 4, save=True),
              slstm.bytes_backward(8, 2048, 1024, 4)):
        assert b / PEAKS["hbm_bytes_s"] < ops / PEAKS["fp32_flops"]


def test_phi4_mini_prefill_counts_the_table_once():
    layer = 3072 * 3072 * 2 + 2 * 3072 * 1024 + 3 * 3072 * 8192
    assert layer == 100_663_296
    body = 32 * layer
    attn = 32 * 2 * 2 * 4 * 24 * 128 * (2048 * 2049 // 2)
    want = 2 * body * 4 * 2048 + 2 * 200064 * 3072 * 4 + attn
    assert lm.prefill_flops(PHI, 4, 2048) == want
    assert want == pytest.approx(56.08e12, rel=1e-3)
    # 2 N T with the table at every position counts ~10 TF more at 4 x 2048
    with_table = 2 * (body + 200064 * 3072) * 4 * 2048 + attn
    assert with_table - want == pytest.approx(10.07e12, rel=1e-3)


def test_training_counts():
    phi = 32 * 100_663_296 + 200064 * 3072
    attn = 32 * 2 * 2 * 2 * 24 * 128 * (2048 * 2049 // 2)
    assert lm.train_flops(PHI, 2, 2048) == 6 * phi * 2 * 2048 + 3 * attn
    mlstm = 1024 * 4096 + 3 * 2048 * 2048 + 1024 * 8 + 2048 * 1024
    sl = 1024 * 4096 + 4 * 256 * 1024 + 1024 * 1024
    xl = 12 * (mlstm + sl) + 50304 * 1024
    assert lm.matrix_params(XL) == xl == 353_599_488
    assert lm.train_flops(XL, 8, 2048) == 6 * xl * 8 * 2048  # attention-free
    assert lm.prefill_flops(XL, 8, 2048) == 2 * (xl - 50304 * 1024) * 8 * 2048 \
        + 2 * 50304 * 1024 * 8


def _record(kind, run, traffic, kernels, window_s, busy_s, steps):
    return {"kind": kind, "run": run, "traffic": traffic, "kernels": kernels,
            "window_s": window_s, "busy_s": busy_s, "steps": steps, "peaks": PEAKS,
            "model_counts": lm, "ops": kernels, "gaps": []}


def test_the_readers_at_hand_values():
    t = S.MAN.traffic("train.b8s2048")
    k = {"slstm_forward_kernel(FwdArgs)": [24, 24 * 6.2e-3],
         "slstm_backward_kernel(BwdArgs)": [12, 12 * 6.9e-3], "gemm": [100, 0.3]}
    rec = _record("train", XL, t, k, 0.9, 0.75, 1)
    share = S.MAN.reader("slstm_roofline.train")(rec)
    assert share == pytest.approx(100 * 36 * 0.5128e-3 / (24 * 6.2e-3 + 12 * 6.9e-3), rel=1e-3)
    mfu = S.MAN.reader("mfu.train")(rec)
    assert mfu == pytest.approx(100 * lm.train_flops(XL, 8, 2048) / (0.9 * 989e12))
    assert 0 < mfu < 100 and 0 < share < 100
    assert S.MAN.reader("idle_share.train")(rec) == pytest.approx(100 * (1 - 0.75 / 0.9))
    assert S.MAN.reader("kernels_per_step.train")(rec) == 136
    assert S.MAN.reader("slstm_roofline.prefill")(rec) is None  # another kind


def test_a_reader_with_nothing_to_read_returns_nothing():
    t = S.MAN.traffic("prefill.b4s2048")
    rec = _record("prefill", PHI, t, {}, 0.5, 0.0, 1)
    for name in ("mfu.prefill", "idle_share.prefill", "kernels_per_step.prefill",
                 "slstm_roofline.prefill"):
        assert S.MAN.reader(name)(rec) is None
