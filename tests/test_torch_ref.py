"""Port's workload oracles (``repro_torch.kernels.ref``) vs their jnp twins.

Each torch oracle gets the same numpy inputs as the JAX package's
``repro.kernels.ref`` function of the same name, on the CPU; float32 results
must agree within 1e-5 (summation order only), bf16 results within 2e-2
(one bf16 rounding of the output), the tolerances of the JAX kernel tests.
``xent_ref`` is compared on targets inside the vocabulary only: outside it
the jnp twin wraps or gives NaN, and ``torch.gather`` raises.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from torch_threads import one_thread

one_thread()

F32 = 1e-5
BF16 = 2e-2


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def pair(x, bf16=False):
    """The same values as a jnp array and a torch tensor."""
    j, t = jnp.asarray(x), torch.from_numpy(x)
    return (j.astype(jnp.bfloat16), t.bfloat16()) if bf16 else (j, t)


def as_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (128, 128, True, None), (128, 128, False, None), (128, 128, True, 32),
    (64, 128, True, None), (128, 64, False, 16), (128, 64, True, 16)])
@pytest.mark.parametrize("bf16", [False, True])
def test_attention_ref_matches_jnp(Sq, Sk, causal, window, bf16):
    (jq, tq), (jk, tk), (jv, tv) = (
        pair(normal(shape, seed), bf16)
        for seed, shape in enumerate(((2, 3, Sq, 32), (2, 3, Sk, 32), (2, 3, Sk, 32))))
    got = ref.attention_ref(tq, tk, tv, causal=causal, window=window)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(want.shape)
    tol = BF16 if bf16 else F32
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def test_attention_mask_is_top_left_aligned():
    m = ref.attention_mask(4, 6, True, 2, "cpu")
    want = np.array([[1, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0],
                     [0, 1, 1, 0, 0, 0], [0, 0, 1, 1, 0, 0]], bool)
    np.testing.assert_array_equal(m.numpy(), want)


@pytest.mark.parametrize("B,S,D", [(1, 64, 32), (2, 128, 64), (3, 17, 40)])
def test_rglru_scan_ref_matches_jnp(B, S, D):
    a = 1.0 / (1.0 + np.exp(-normal((B, S, D), 0)))
    (ja, ta), (jb, tb), (jh, th) = (pair(x) for x in (a, normal((B, S, D), 1),
                                                      normal((B, D), 2)))
    got = ref.rglru_scan_ref(ta, tb, th)
    want = jref.rglru_scan_ref(ja, jb, jh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32, rtol=1e-4)


@pytest.mark.parametrize("N,V,bf16", [(64, 1000, False), (32, 4096, True),
                                      (8, 50257, False), (1, 7, False)])
def test_xent_ref_matches_jnp(N, V, bf16):
    jl, tl = pair(3 * normal((N, V), N + V), bf16)
    targets = np.random.default_rng(V).integers(0, V, size=N).astype(np.int32)
    got = ref.xent_ref(tl, torch.from_numpy(targets))
    want = jref.xent_ref(jl, jnp.asarray(targets))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("B,S,H,D", [(1, 8, 1, 4), (2, 24, 2, 8)])
def test_mlstm_recurrent_ref_matches_jnp(B, S, H, D):
    q, k, v = (normal((B, S, H, D), s) for s in range(3))
    i_gate = np.exp(0.5 * normal((B, S, H), 3))
    log_f = -np.log1p(np.exp(-normal((B, S, H), 4)))  # log sigmoid
    jins, tins = zip(*(pair(np.ascontiguousarray(x, np.float32))
                       for x in (q, k, v, i_gate, log_f)))
    got = ref.mlstm_recurrent_ref(*tins)
    want = jref.mlstm_recurrent_ref(*jins)
    assert tuple(got.shape) == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32, rtol=1e-4)
