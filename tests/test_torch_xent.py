"""Port's fused cross-entropy vs the JAX package's Pallas kernel, on the CPU.

On CPU tensors ``repro_torch.kernels.ops.softmax_xent`` runs its plain torch
version; it must agree with the Pallas kernel itself,
``repro.kernels.ops.softmax_xent`` in interpret mode (which runs under the
installed jax), within atol 1e-4 / rtol 1e-5, the tolerance of the JAX
package's kernel test (``tests/test_kernels.py``), on the same numpy inputs.
That includes targets outside ``[0, V)`` (-1 and V), where both give the
row's logsumexp. On targets inside the vocabulary it must also agree with
the jnp oracle ``repro.kernels.ref.xent_ref``. The CUDA kernel is held
against the plain version on the card by ``chip_smoke.py`` (phase 14).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import KernelError, _build, ops
from repro_torch.kernels import xent as xe
from torch_threads import one_thread

one_thread()

ATOL, RTOL = 1e-4, 1e-5
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def operands(N, V, seed, edge=False):
    """Logits 3 * N(0, 1) and uniform targets, as the JAX test draws them;
    with ``edge``, every other target is -1 and every fourth V."""
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((N, V))).astype(np.float32)
    targets = rng.integers(0, V, size=N).astype(np.int32)
    if edge:
        targets[0::2] = -1
        targets[1::4] = V
    return logits, targets


def port(logits, targets, bf16=False):
    tl = torch.from_numpy(logits)
    return ops.softmax_xent(tl.bfloat16() if bf16 else tl, torch.from_numpy(targets))


def pallas(logits, targets, bf16=False, **kw):
    jl = jnp.asarray(logits)
    return np.asarray(jops.softmax_xent(jl.astype(jnp.bfloat16) if bf16 else jl,
                                        jnp.asarray(targets), interpret=True, **kw))


@pytest.mark.parametrize("N,V,bf16", [(256, 4096, False), (128, 51968, True),
                                      (64, 1000, False), (32, 262144, True)])
def test_matches_pallas_kernel(N, V, bf16):
    logits, targets = operands(N, V, seed=N + V)
    got = port(logits, targets, bf16)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N,)
    np.testing.assert_allclose(got.numpy(), pallas(logits, targets, bf16),
                               atol=ATOL, rtol=RTOL)


# the JAX test's property sweep (N 16-128, V 256-4096, float32, the Pallas
# kernel on 32 x 256 tiles), as fixed cases
@pytest.mark.parametrize("N,V,seed", [(16, 256, 0), (32, 512, 1), (64, 1024, 2),
                                      (128, 2048, 3), (16, 4096, 4), (128, 256, 5),
                                      (64, 4096, 6), (32, 2048, 7)])
def test_matches_pallas_kernel_sweep(N, V, seed):
    logits, targets = operands(N, V, seed)
    np.testing.assert_allclose(port(logits, targets).numpy(),
                               pallas(logits, targets, block_n=32, block_v=256),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("N,V,bf16", [(64, 1000, False), (32, 4096, True)])
def test_targets_outside_the_vocabulary_give_the_logsumexp(N, V, bf16):
    logits, targets = operands(N, V, seed=11, edge=True)
    got = port(logits, targets, bf16).numpy()
    np.testing.assert_allclose(got, pallas(logits, targets, bf16), atol=ATOL, rtol=RTOL)
    tl = torch.from_numpy(logits)
    lse = torch.logsumexp((tl.bfloat16() if bf16 else tl).float(), -1).numpy()
    outside = (targets < 0) | (targets >= V)
    assert outside.sum() == N // 2 + N // 4
    np.testing.assert_allclose(got[outside], lse[outside], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("N,V,bf16", [(64, 50257, False), (1, 4096, False),
                                      (16, 50257, True), (3, 1, False)])
def test_matches_xent_ref_inside_the_vocabulary(N, V, bf16):
    logits, targets = operands(N, V, seed=V)
    jl = jnp.asarray(logits)
    want = jref.xent_ref(jl.astype(jnp.bfloat16) if bf16 else jl, jnp.asarray(targets))
    np.testing.assert_allclose(port(logits, targets, bf16).numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_int64_targets_give_the_same_losses():
    logits, targets = operands(32, 1000, seed=3, edge=True)
    a = ops.softmax_xent(torch.from_numpy(logits), torch.from_numpy(targets))
    b = ops.softmax_xent(torch.from_numpy(logits), torch.from_numpy(targets).long())
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_ops_wrapper_is_the_kernel_wrapper():
    assert ops.softmax_xent is xe.softmax_xent


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    logits, targets = (torch.from_numpy(x) for x in operands(8, 300, seed=1))
    before = xe.softmax_xent.launches
    got = xe.softmax_xent(logits, targets)
    torch.testing.assert_close(got, xe.softmax_xent_plain(logits, targets), atol=0, rtol=0)
    assert xe.softmax_xent.launches == before


def test_other_devices_raise():
    logits = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        xe.softmax_xent(logits, torch.empty((4,), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("bad", ("rank", "length", "float_targets", "fp16", "empty",
                                 "devices"))
def test_wrapper_rejects_malformed_operands(bad):
    logits, targets = (torch.from_numpy(x) for x in operands(4, 16, seed=0))
    if bad == "rank":
        logits = logits[None]
    elif bad == "length":
        targets = targets[:3]
    elif bad == "float_targets":
        targets = targets.float()
    elif bad == "fp16":
        logits = logits.half()
    elif bad == "empty":
        logits, targets = logits[:0], targets[:0]
    else:
        targets = targets.to("meta")
    with pytest.raises((TypeError, ValueError)):
        xe.softmax_xent(logits, targets)


def test_load_without_nvcc_raises_kernel_error(monkeypatch, tmp_path):
    import shutil
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setattr(xe, "_LIB", None)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(KernelError, match="nvcc not found"):
        xe.load()


def test_chip_smoke_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 14 on the CPU, at cut shapes: the plain
    version stands in for the kernel and counts as its launch, the timers
    are stubbed. Its checks (one launch per op call, kernel == plain, the
    logsumexp at targets -1 and V, the library call) must all pass."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    plain = xe.softmax_xent_plain

    def counted(logits, targets):
        xe.softmax_xent.launches += 1
        return plain(logits, targets)

    monkeypatch.setattr(xe, "softmax_xent_plain", counted)
    monkeypatch.setattr(xe, "_launch", plain)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "graph_ms", lambda torch, fn, reps=1, rounds=1: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "call_ms", lambda torch, fn, reps=1: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "XENT_FULL", (("a", 16, 2048), ("b", 8, 1001)))
    detail = {}
    out = cs.xent_phase(torch, xe, detail, dev="cpu")
    assert out["launches"] == 2 and out["bound_by"] == "bytes"
    assert detail["xent_kernel"]["cases"] == 11
