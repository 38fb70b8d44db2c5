"""Port's RG-LRU scan module vs the JAX package's oracle, on the CPU.

On CPU tensors ``repro_torch.kernels.rglru_scan.rglru_scan`` runs its plain
torch version; it must agree with ``repro.kernels.ref.rglru_scan_ref`` (the
sequential ``lax.scan`` oracle, x64 off as JAX defaults) within atol 1e-5 /
rtol 1e-4, the tolerance of the JAX package's own kernel test
(``tests/test_kernels.py``). The Pallas kernel itself does not run under the
installed jax (its body calls ``pl.load``), so the oracle is the reference.
The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro_torch.kernels import KernelError, _build
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from torch_threads import one_thread

one_thread()

ATOL, RTOL = 1e-5, 1e-4


def operands(B, S, D, seed=0):
    """As the JAX property test draws them: a = sigmoid(N), b = N, h0 = N."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D))))
    b = rng.standard_normal((B, S, D))
    h0 = rng.standard_normal((B, D))
    return (x.astype(np.float32) for x in (a, b, h0))


def oracle(a, b, h0):
    return np.asarray(ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(h0)))


# the JAX test's range (B 1-3, S 64-256, D 32-256), then a ragged D, S = 1
@pytest.mark.parametrize("B,S,D", [(1, 64, 32), (2, 128, 64), (3, 192, 128),
                                   (2, 256, 256), (3, 64, 256), (2, 64, 96),
                                   (1, 128, 40), (2, 1, 64), (1, 1, 1)])
def test_plain_matches_jax_oracle(B, S, D):
    a, b, h0 = operands(B, S, D, seed=B * 100 + S + D)
    got = rg.rglru_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), oracle(a, b, h0), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B,S,D", [(2, 128, 64), (1, 64, 96)])
def test_bf16_inputs_store_bf16_of_the_float32_state(B, S, D):
    """bf16 a and b: the state is float32 and each h_t is stored in bf16, so
    the output is the oracle's float32 recurrence (on the same bf16 values)
    rounded to bf16."""
    a, b, h0 = operands(B, S, D, seed=7)
    ta, tb = (torch.from_numpy(x).bfloat16() for x in (a, b))
    got = rg.rglru_scan(ta, tb, torch.from_numpy(h0))
    assert got.dtype == torch.bfloat16
    want = torch.tensor(oracle(ta.float().numpy(), tb.float().numpy(), h0))
    np.testing.assert_allclose(got.float().numpy(), want.bfloat16().float().numpy(),
                               atol=ATOL, rtol=RTOL)


def test_ops_wrapper_is_the_kernel_wrapper_with_a_zero_state():
    """``kernels.ops.rglru_scan`` is what the model calls; from h0 = 0 it
    matches the oracle as well."""
    a, b, _ = operands(2, 64, 128, seed=3)
    h0 = np.zeros((2, 128), np.float32)
    assert ops.rglru_scan is rg.rglru_scan
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), oracle(a, b, h0), atol=ATOL, rtol=RTOL)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    a, b, h0 = (torch.from_numpy(x) for x in operands(2, 33, 40, seed=1))
    before = rg.rglru_scan.launches
    got = rg.rglru_scan(a, b, h0)
    torch.testing.assert_close(got, rg.rglru_scan_plain(a, b, h0), atol=0, rtol=0)
    assert rg.rglru_scan.launches == before


def test_other_devices_raise():
    a = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rg.rglru_scan(a, a, torch.empty((1, 8), device="meta"))


@pytest.mark.parametrize("bad", ("shape", "h0_shape", "dtype", "mixed", "rank",
                                 "empty", "int_h0"))
def test_wrapper_rejects_malformed_operands(bad):
    a, b, h0 = (torch.from_numpy(x) for x in operands(2, 8, 16))
    if bad == "shape":
        b = b[:, :4]
    elif bad == "h0_shape":
        h0 = h0[:1]
    elif bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.bfloat16()
    elif bad == "rank":
        a, b = a[0], b[0]
    elif bad == "empty":
        a, b = a[:, :0], b[:, :0]
    else:
        h0 = h0.long()
    with pytest.raises((TypeError, ValueError)):
        rg.rglru_scan(a, b, h0)


def test_load_without_nvcc_raises_kernel_error(monkeypatch, tmp_path):
    import shutil
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setattr(rg, "_LIB", None)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(KernelError, match="nvcc not found"):
        rg.load()


# ---------------------------------------------------------------------------
# the two kernels' route rule, the build's sources, what the CUDA branch
# refuses, and chip_smoke.py's phase 10 rehearsed on the CPU
# ---------------------------------------------------------------------------

BASE = 0x7F0000000000


@pytest.mark.parametrize("dtype,D,offset,want", [
    (torch.float32, 2560, 0, rg.TMA),      # the model's width
    (torch.bfloat16, 2560, 0, rg.TMA),
    (torch.float32, 2564, 0, rg.TMA),      # D % 4 == 0 is a 16-byte row
    (torch.float32, 32, 0, rg.TMA),
    (torch.float32, 97, 0, rg.DIRECT),     # rows TMA cannot stride
    (torch.float32, 2562, 0, rg.DIRECT),
    (torch.bfloat16, 2564, 0, rg.DIRECT),  # bf16 needs D % 8 == 0
    (torch.bfloat16, 100, 0, rg.DIRECT),
    (torch.float32, 2560, 4, rg.DIRECT),   # a view one element in
    (torch.bfloat16, 2560, 2, rg.DIRECT),
    (torch.float32, 2560, 8, rg.DIRECT),
])
def test_route_goes_by_dtype_width_and_alignment(dtype, D, offset, want):
    """The TMA kernels take rows of D elements that are a multiple of 16
    bytes at 16-byte aligned addresses; everything else takes the direct
    kernels. Only the second operand is offset here: one misaligned operand
    is enough."""
    ptrs = (BASE, BASE + 0x100000 + offset, BASE + 0x200000)
    assert rg._route(dtype, D, ptrs) == want


def test_a_view_into_its_buffer_takes_the_direct_route():
    buf = torch.zeros(2 * 8 * 256 + 1)
    view = buf[1:].view(2, 8, 256)
    whole = torch.zeros(2, 8, 256)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    assert rg._route(view.dtype, 256, (whole.data_ptr(), view.data_ptr())) == rg.DIRECT
    assert rg._route(whole.dtype, 256, (whole.data_ptr(),)) == rg.TMA


def test_the_library_is_keyed_by_the_hopper_header_too(tmp_path):
    """``rglru_scan.cu`` includes ``hopper.cuh`` (TMA, mbarriers, the tensor
    map encoder): an edit to the header must rebuild the library."""
    import shutil

    assert [os.path.basename(p) for p in _build.sources("rglru_scan")] == [
        "rglru_scan.cu", "hopper.cuh"]
    for name in ("rglru_scan.cu", "hopper.cuh"):
        shutil.copy(os.path.join(_build.SRC_DIR, name), tmp_path / name)
    before = _build.digest("rglru_scan", str(tmp_path))
    assert before == _build.digest("rglru_scan")
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.digest("rglru_scan", str(tmp_path)) != before


@pytest.mark.parametrize("op,names", [("rglru_scan", ("a", "b")),
                                      ("rglru_scan_backward", ("a", "h", "h0", "dh"))])
def test_cuda_branch_refuses_non_contiguous_operands(op, names):
    """The check the CUDA branch of each wrapper makes before either route:
    every operand contiguous."""
    shapes = {"h0": (2, 16)}
    for bad in names:
        operands = {n: torch.zeros(shapes.get(n, (2, 8, 16))) for n in names}
        operands[bad] = operands[bad].t().contiguous().t() if bad == "h0" else \
            torch.zeros(2, 16, 8).transpose(1, 2)
        assert not operands[bad].is_contiguous()
        with pytest.raises(ValueError, match=f"{bad} must be contiguous"):
            rg._check_kernel_operands(op, **operands)
    rg._check_kernel_operands(op, **{n: torch.zeros(shapes.get(n, (2, 8, 16)))
                                     for n in names})


def test_cuda_branch_refuses_more_than_65535_rows():
    a = torch.zeros((65536, 1, 4))
    with pytest.raises(ValueError, match="B <= 65535, got 65536"):
        rg._check_kernel_operands("rglru_scan", a=a, b=a)
    rg._check_kernel_operands("rglru_scan", a=a[:65535], b=a[:65535])


def counting_plain_versions(monkeypatch):
    """The CPU stands in for the card: each plain version counts as a launch
    of its wrapper, on the route ``_route`` names for its operands (or, for
    ``_launch`` / ``_launch_backward``, the route asked for)."""
    fwd, bwd = rg.rglru_scan_plain, rg.rglru_scan_backward_plain

    def count(wrapper, a, others, route=None):
        wrapper.launches += 1
        route = route or rg._route(a.dtype, a.shape[-1], [t.data_ptr() for t in (a, *others)])
        wrapper.launches_tma += route == rg.TMA

    def plain(a, b, h0):
        count(rg.rglru_scan, a, (b,))
        return fwd(a, b, h0)

    def plain_backward(a, h, h0, dh):
        count(rg.rglru_scan_backward, a, (h, dh))
        return bwd(a, h, h0, dh)

    def launch(a, b, h0, route=None):
        count(rg.rglru_scan, a, (b,), route)
        return fwd(a, b, h0)

    def launch_backward(a, h, h0, dh, route=None):
        count(rg.rglru_scan_backward, a, (h, dh), route)
        return bwd(a, h, h0, dh)

    monkeypatch.setattr(rg, "rglru_scan_plain", plain)
    monkeypatch.setattr(rg, "rglru_scan_backward_plain", plain_backward)
    monkeypatch.setattr(rg, "_launch", launch)
    monkeypatch.setattr(rg, "_launch_backward", launch_backward)


def test_chip_smoke_phase_10_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 10 on the CPU with its full-width shapes
    cut: the plain version stands in for both routes' kernels and counts as
    their launches, the timers and the SASS report are stubbed. Its checks
    (kernel == plain bit for bit on every case and route, one launch per
    call on the route the rule names, a TMA load in each TMA kernel, no
    spill) must pass."""
    monkeypatch.syspath_prepend(os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke as cs

    counting_plain_versions(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "graph_ms", lambda torch, fn, reps=1, rounds=1: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "call_ms", lambda torch, fn, reps=1: (fn(), 1.0)[1])
    spills = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    monkeypatch.setattr(cs, "kernel_report", lambda name: {
        "_ZN12_GLOBAL__N_121rglru_scan_tma_kernelIfEEv14CUtensorMap_st": {
            "UTMALDG": 16, "registers": "Used 50 registers", "spills": spills},
        "_ZN12_GLOBAL__N_121rglru_scan_tma_kernelI13__nv_bfloat16EEv14CUtensorMap_st": {
            "UTMALDG": 16},
        "_ZN12_GLOBAL__N_130rglru_scan_backward_tma_kernelEv14CUtensorMap_st": {
            "UTMALDG": 6},
        "_ZN12_GLOBAL__N_117rglru_scan_kernelIfEEvPKT_": {"spills": spills}})
    monkeypatch.setattr(cs, "RG_FULL", (("train_fp32", (2, 70, 96), "float32"),
                                        ("prefill_fp32", (3, 40, 64), "float32"),
                                        ("prefill_bf16", (3, 40, 64), "bfloat16")))
    detail = {}
    out = cs.rglru_phase(torch, rg, detail, dev="cpu")
    # 24 cases: 19 the TMA kernel takes (each also run on the direct one),
    # 5 only the direct one takes (D 97, bf16 D 2564 and 100, two views)
    assert out["cases"] == 24 and out["runs"] == {"tma": 19, "direct": 24}
    assert out["max_abs_err"] == 0.0 and out["bound_by"] == "bytes"
    assert sorted(detail["rglru_sass"]) == [
        "rglru_scan_backward_tma_kernel", "rglru_scan_kernel<float>",
        "rglru_scan_tma_kernel<bf16>", "rglru_scan_tma_kernel<float>"]
    assert set(out["shapes"]) == {"train_fp32", "prefill_fp32", "prefill_bf16"}


def test_chip_smoke_phase_10_fails_on_a_missing_tma_load(monkeypatch):
    """The SASS check bites: a TMA kernel without UTMALDG fails phase 10."""
    monkeypatch.syspath_prepend(os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke as cs

    monkeypatch.setattr(cs, "kernel_report", lambda name: {
        "rglru_scan_tma_kernelIfE": {"UTMALDG": 4},
        "rglru_scan_tma_kernelI13__nv_bfloat16E": {},
        "rglru_scan_backward_tma_kernel": {"UTMALDG": 6}})
    with pytest.raises(cs.SmokeFailure, match="no UTMALDG"):
        cs.rglru_sass({})
