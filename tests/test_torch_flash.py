"""Port's flash attention ops vs the JAX package's oracle, on the CPU.

On CPU tensors ``repro_torch.kernels.ops.flash_attention`` and
``flash_attention_gqa`` run their plain torch version; they must agree with
``repro.kernels.ref.attention_ref`` on the same numpy inputs within 1e-5 in
float32 and 2e-2 in bf16, the tolerances of the JAX package's flash tests
(``tests/test_kernels.py``), on every case of those tests. The Pallas kernel
itself does not run under the installed jax (its body calls ``pl.load``),
so the oracle is the reference, as it is for the JAX tests. Rows that see
no key follow the oracle: the mean of V over all keys. The CUDA kernel is
held against the plain version on the card by ``chip_smoke.py`` (phase 13).
"""
import os
import traceback

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import KernelError, _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import xent as xe
from torch_threads import one_thread

one_thread()

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = {False: 1e-5, True: 2e-2}  # by bf16


def operands(q_shape, kv_shape, seed, bf16=False):
    """q, k, v drawn from N(0, 1), as jnp arrays and as torch tensors."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in (q_shape, kv_shape, kv_shape)]
    js = [jnp.asarray(a) for a in arrays]
    ts = [torch.from_numpy(a) for a in arrays]
    if bf16:
        js = [a.astype(jnp.bfloat16) for a in js]
        ts = [t.bfloat16() for t in ts]
    return js, ts


def close(got, want, bf16=False):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[bf16], rtol=TOL[bf16])


@pytest.mark.parametrize("shape", [(1, 1, 128, 64), (2, 4, 256, 64), (1, 2, 512, 128),
                                   (2, 2, 384, 32)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_attention_ref(shape, bf16, causal):
    (jq, jk, jv), (q, k, v) = operands(shape, shape, seed=0, bf16=bf16)
    got = ops.flash_attention(q, k, v, causal=causal, block_q=128, block_k=128)
    assert got.dtype == q.dtype and tuple(got.shape) == shape
    close(got, jref.attention_ref(jq, jk, jv, causal=causal), bf16)


@pytest.mark.parametrize("window", [64, 128, 256])
def test_sliding_window(window):
    shape = (1, 2, 512, 64)
    (jq, jk, jv), (q, k, v) = operands(shape, shape, seed=1)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    close(got, jref.attention_ref(jq, jk, jv, causal=True, window=window))


def test_gqa_matches_attention_ref_on_repeated_kv_heads():
    B, Hq, Hkv, S, D = 2, 8, 2, 256, 64
    (jq, jk, jv), (q, k, v) = operands((B, Hq, S, D), (B, Hkv, S, D), seed=2)
    got = ops.flash_attention_gqa(q, k, v, causal=True)
    kr, vr = (jnp.repeat(x, Hq // Hkv, axis=1) for x in (jk, jv))
    close(got, jref.attention_ref(jq, kr, vr, causal=True))


@pytest.mark.parametrize("Sq,Sk,causal,window", [(256, 384, True, None),
                                                 (128, 512, False, 128),
                                                 (384, 128, True, None)])
def test_query_and_key_lengths_may_differ(Sq, Sk, causal, window):
    (jq, jk, jv), (q, k, v) = operands((1, 2, Sq, 64), (1, 2, Sk, 64), seed=3)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert tuple(got.shape) == (1, 2, Sq, 64)
    close(got, jref.attention_ref(jq, jk, jv, causal=causal, window=window))


def test_rows_that_see_no_key_take_the_mean_of_v():
    """Causal with window 64, Sq = 256, Sk = 128: query q sees keys
    (q - 64, q], none when q >= 191. Those rows get the mean of V over all
    keys, as the oracle's softmax over equal -1e30 scores gives it."""
    (jq, jk, jv), (q, k, v) = operands((1, 2, 256, 64), (1, 2, 128, 64), seed=4)
    got = ops.flash_attention(q, k, v, causal=True, window=64)
    close(got, jref.attention_ref(jq, jk, jv, causal=True, window=64))
    mean = v.mean(dim=2, keepdim=True).expand(-1, -1, 256 - 191, -1)
    torch.testing.assert_close(got[:, :, 191:], mean, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ("Sq", "Sk", "gqa_heads", "heads"))
def test_refuses_what_the_jax_op_refuses(case):
    q_shape, kv_shape, op, kw = (1, 2, 128, 32), (1, 2, 128, 32), ops.flash_attention, {}
    if case == "Sq":
        q_shape = (1, 2, 192, 32)
    elif case == "Sk":
        kv_shape, kw = (1, 2, 128, 32), {"block_k": 96}
    elif case == "gqa_heads":
        q_shape, kv_shape, op = (1, 6, 128, 32), (1, 4, 128, 32), ops.flash_attention_gqa
    else:
        kv_shape = (1, 1, 128, 32)
    _, (q, k, v) = operands(q_shape, kv_shape, seed=5)
    with pytest.raises(ValueError):
        op(q, k, v, **kw)


def test_smaller_blocks_accept_what_the_default_refuses():
    """block_q / block_k only refuse lengths; the kernel picks its tiles."""
    (jq, jk, jv), (q, k, v) = operands((1, 2, 96, 32), (1, 2, 96, 32), seed=6)
    got = ops.flash_attention(q, k, v, block_q=32, block_k=32)
    close(got, jref.attention_ref(jq, jk, jv, causal=True))


def test_ops_wrappers_are_the_kernel_wrappers():
    assert ops.flash_attention is fa.flash_attention
    assert ops.flash_attention_gqa is fa.flash_attention_gqa


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    _, (q, k, v) = operands((1, 4, 128, 32), (1, 2, 128, 32), seed=7)
    before = fa.flash_attention.launches
    got = fa.flash_attention_gqa(q, k, v, window=32)
    torch.testing.assert_close(got, fa.flash_attention_plain(q, k, v, window=32),
                               atol=0, rtol=0)
    assert fa.flash_attention.launches == before


def test_other_devices_raise():
    q = torch.empty((1, 2, 128, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("bad", ("rank", "kv_shape", "head_dim", "dtype", "mixed",
                                 "devices"))
def test_wrapper_rejects_malformed_operands(bad):
    _, (q, k, v) = operands((1, 2, 128, 32), (1, 2, 128, 32), seed=8)
    if bad == "rank":
        q = q[0]
    elif bad == "kv_shape":
        v = v[:, :1]
    elif bad == "head_dim":
        k, v = k[..., :16], v[..., :16]
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed":
        v = v.bfloat16()
    else:
        k = k.to("meta")
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention(q, k, v)


def test_load_without_nvcc_raises_kernel_error(monkeypatch, tmp_path):
    import shutil
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setattr(fa, "_LIB", None)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(KernelError, match="nvcc not found"):
        fa.load()


def test_chip_smoke_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 13 on the CPU, at cut full-width shapes: the
    plain version stands in for the kernel and counts as its launch (on the
    path ``_path_for`` names), the timers and the SASS report are stubbed,
    the flash and cross-entropy plain versions carry their kernels' grad
    guard, and the RG-LRU scan's plain forward and backward count as their
    kernels' launches. Its checks (one launch per op call on the expected
    path, kernel == plain on every case, an input that requires grad raises
    in flash and the cross-entropy and flows through the RG-LRU scan's two
    kernels, a second launch identical, SDPA against the kernel) must all
    pass."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    plain = fa.flash_attention_plain

    def counted(q, k, v, **kw):
        # the kernel wrapper's guard, launch count and path count
        _build.refuse_grad("flash_attention", q=q, k=k, v=v)
        fa.flash_attention.launches += 1
        path = fa._path_for(q.dtype, q.shape[-1], (q.data_ptr(), k.data_ptr(), v.data_ptr()))
        fa.flash_attention.launches_tc += path == fa.TENSOR_CORE
        return plain(q, k, v, **kw)

    def guarded(name, fn, *inputs):
        def call(*args):
            _build.refuse_grad(name, **dict(zip(inputs, args)))
            return fn(*args)
        return call

    monkeypatch.setattr(fa, "flash_attention_plain", counted)
    monkeypatch.setattr(fa, "_launch", lambda q, k, v, c, w, o=0: plain(q, k, v, causal=c,
                                                                       window=w, q_offset=o))
    monkeypatch.setattr(xe, "softmax_xent_plain", guarded(
        "softmax_xent", xe.softmax_xent_plain, "logits", "targets"))
    def counted_as(wrapper, fn):
        def call(*args):
            wrapper.launches += 1
            return fn(*args)
        return call

    monkeypatch.setattr(rg, "rglru_scan_plain",
                        counted_as(rg.rglru_scan, rg.rglru_scan_plain))
    monkeypatch.setattr(rg, "rglru_scan_backward_plain",
                        counted_as(rg.rglru_scan_backward, rg.rglru_scan_backward_plain))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "graph_ms", lambda torch, fn, reps=1, rounds=1: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "call_ms", lambda torch, fn, reps=1: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "kernel_report", lambda name: {
        "flash_tc_kernel<256>": {"HGMMA": 48, "UTMALDG": 12}, "flash_kernel<float, 256>": {}})
    monkeypatch.setattr(cs, "FLASH_FULL", (("a", 1, 4, 1, 128, 256, True, 128),
                                           ("b", 1, 4, 2, 256, 64, True, 64)))
    monkeypatch.setattr(cs, "FLASH_OFFSET", (("o", 1, 4, 2, 64, 128, 64, 32, 64),))
    detail = {}
    out = cs.flash_phase(torch, fa, detail, dev="cpu")
    # the offset block: the small cases and the cut rank-1 block, each in
    # both dtypes (one launch an op call, bf16 on the tensor-core path)
    o = out["offset"]["o"]
    assert detail["flash_kernel"]["offset_cases"] == 2 * len(cs.FLASH_OFFSET_CASES)
    assert o["q_offset"] == 64 and o["bound_by"] == "bytes"
    assert o["gflop"] == 4 * 64 * 4 * cs.offset_pairs(64, 128, 32, 64) / 1e9
    assert cs.offset_pairs(64, 128, 32, 64) == 64 * 32
    assert out["launches"] == 2 and out["launches_tc"] == 2 and out["bound_by"] == "bytes"
    assert detail["flash_kernel"]["cases"] == 37
    assert detail["flash_kernel"]["tensor_core_cases"] == 17
    # 4 D per visible pair: (1 + ... + 128) pairs x 4 heads x 4 x 256
    assert out["gflop"] == 4 * 256 * 4 * (128 * 129 // 2) / 1e9


@pytest.mark.parametrize("D", [8, 32, 48, 80, 256, 33, 250])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("aligned", [True, False])
def test_path_for_routes_by_dtype_head_dim_and_alignment(D, dtype, aligned):
    """bf16 with D % 8 == 0 and every address 16-byte aligned takes the
    tensor-core kernel (TMA's row strides and bases); all else the CUDA-core
    kernel."""
    ptrs = (0x7F0000000000, 0x7F0000100000, 0x7F0000200000 + (0 if aligned else 2))
    want = (fa.TENSOR_CORE if dtype == torch.bfloat16 and D % 8 == 0 and aligned
            else fa.CUDA_CORE)
    assert fa._path_for(dtype, D, ptrs) == want


def _unreachable_load():
    raise AssertionError("the guard must raise before the kernel is loaded")


@pytest.mark.parametrize("op", ["flash_attention", "softmax_xent", "rglru_scan"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(op, monkeypatch):
    """The CUDA branch of the flash and cross-entropy wrappers raises before
    it loads the kernel when grad is enabled and an input requires grad:
    those kernels have no backward, and their output would carry no
    grad_fn. The RG-LRU scan has a backward kernel: its CUDA branch takes
    the autograd Function and reaches the kernel's load inside the
    Function's forward, with no refusal."""
    if op == "flash_attention":
        mod = fa
        _, (q, k, v) = operands((1, 2, 128, 32), (1, 2, 128, 32), seed=9)
        args = (q.requires_grad_(), k, v, True, None)
    elif op == "softmax_xent":
        mod = xe
        args = (torch.randn(4, 16).requires_grad_(), torch.zeros(4, dtype=torch.int64))
    else:
        mod = rg
        args = (torch.rand(1, 8, 16), torch.rand(1, 8, 16).requires_grad_(),
                torch.zeros(1, 16))
    monkeypatch.setattr(mod, "load", _unreachable_load)
    if op == "rglru_scan":
        with pytest.raises(AssertionError, match="before the kernel") as info:
            rg._scan(*args, True)
        frames = [f.name for f in traceback.extract_tb(info.tb)]
        assert "forward" in frames and frames[-2] == "_launch"
        with torch.no_grad(), pytest.raises(AssertionError, match="before the kernel") as info:
            rg._scan(*args, True)
        assert "forward" not in [f.name for f in traceback.extract_tb(info.tb)]
        return
    with pytest.raises(RuntimeError, match="no backward"):
        mod._launch(*args)
    # without grad the guard lets the call through to the kernel's load
    with torch.no_grad(), pytest.raises(AssertionError, match="before the kernel"):
        mod._launch(*args)


@pytest.mark.parametrize("window", [None, 48, 200])
@pytest.mark.parametrize("Sq,offset", [(128, 128), (96, 160), (256, 0)])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_at_an_offset_is_the_whole_sequence_s_rows(window, Sq, offset, bf16):
    """``flash_attention_plain(q_offset=o)`` on the query rows o:o+Sq of a
    sequence of 256 against all its keys equals rows o:o+Sq of the whole
    sequence's plain version and of JAX's ``ref.attention_ref`` (which has
    no offset), with and without a window, also through the GQA op on CPU
    tensors."""
    T = 256
    (jq, jk, jv), (q, k, v) = operands((2, 4, T, 32), (2, 4, T, 32), seed=3, bf16=bf16)
    rows = slice(offset, offset + Sq)
    got = fa.flash_attention_plain(q[:, :, rows], k, v, causal=True, window=window,
                                   q_offset=offset)
    whole = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    assert torch.equal(got, whole[:, :, rows])
    want = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    close(got, np.asarray(want.astype(jnp.float32))[:, :, rows], bf16)
    via_op = ops.flash_attention_gqa(q[:, :, rows].contiguous(), k[:, :2].contiguous(),
                                     v[:, :2].contiguous(), causal=True, window=window,
                                     block_q=32, block_k=32, q_offset=offset)
    whole_gqa = fa.flash_attention_plain(q, k[:, :2], v[:, :2], causal=True, window=window)
    assert torch.equal(via_op, whole_gqa[:, :, rows])


def test_a_negative_offset_is_refused():
    _, (q, k, v) = operands((1, 2, 64, 32), (1, 2, 64, 32), seed=0)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, block_q=32, block_k=32, q_offset=-1)


def test_blocked_attention_at_an_offset_takes_the_kernel_route(monkeypatch):
    """Where ``layers._on_kernel`` holds (CUDA tensors, no grad; widened to
    CPU tensors here), a sequence block's blocked attention (``q_offset``
    its start) is one ``flash_attention_gqa`` call at that offset, never the
    twin, and equals the twin's rows."""
    from repro_torch.models import layers as TL

    calls, twin = [], []
    real = ops.flash_attention_gqa

    def counted(q, k, v, **kw):
        calls.append(kw["q_offset"])
        return real(q, k, v, **kw)

    monkeypatch.setattr(TL.kops, "flash_attention_gqa", counted)
    monkeypatch.setattr(TL, "_on_kernel", lambda q, k, v: True)
    plain = TL.blocked_attention_plain
    monkeypatch.setattr(TL, "blocked_attention_plain",
                        lambda *a, **kw: (twin.append(1), plain(*a, **kw))[1])
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 32, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    got = TL.blocked_attention(q, k, v, window=24, block_q=16, block_kv=32, q_offset=32)
    assert calls == [32] and not twin
    want = plain(q, k, v, window=24, bq=16, bkv=32, q_offset=32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
