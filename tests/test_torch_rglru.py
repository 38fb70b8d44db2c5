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
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro_torch.kernels import KernelError, _build
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg

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
