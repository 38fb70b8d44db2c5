"""Port's envy-gap kernel module vs the JAX package's, on the CPU.

On CPU tensors ``repro_torch.kernels.envy.envy_gaps`` runs its plain torch
version; it must agree with the JAX reference path (``envy_gaps_ref``) and
with the Pallas kernel in interpret mode to atol 1e-12, the tolerance of the
JAX package's own kernel test (the reference forms ``W @ X.T``, whose
summation order is the BLAS's; the plain version sums over ``k`` in order).
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import envy as jenvy
from repro_torch.kernels import envy as tenvy
from torch_threads import one_thread

one_thread()

TOL = 1e-12


def x64():
    """Float64 for the JAX calls (jax 0.9 removed the
    ``jax.experimental.enable_x64`` that ``jax_solve.x64_scope`` uses)."""
    return jax.enable_x64(True)


def operands(rng, G, k):
    """Same construction as tests/test_jax_coop.py's kernel test."""
    return rng.uniform(0.5, 4.0, size=(G, k)), rng.uniform(0.0, 2.0, size=(G, k))


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("G,k", ((8, 3), (32, 4), (64, 2), (256, 3)))
def test_plain_matches_jax_reference_and_interpret_kernel(G, k):
    W, X = operands(np.random.default_rng(G + k), G, k)
    got = tenvy.envy_gaps(t64(W), t64(X)).numpy()
    with x64():
        ref = np.asarray(jenvy.envy_gaps_ref(jnp.asarray(W), jnp.asarray(X)))
        pallas = np.asarray(jenvy.envy_gaps(jnp.asarray(W), jnp.asarray(X),
                                            interpret=True))
    assert got.shape == (G, G) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=0)
    np.testing.assert_array_equal(np.diag(got), 0.0)


def test_batched_operands_match_single_instances():
    rng = np.random.default_rng(9)
    inst = [operands(rng, 12, 3) for _ in range(3)]
    Ws, Xs = (np.stack(a) for a in zip(*inst))
    got = tenvy.envy_gaps(t64(Ws), t64(Xs))
    assert got.shape == (3, 12, 12)
    for b, (W, X) in enumerate(inst):
        torch.testing.assert_close(got[b], tenvy.envy_gaps(t64(W), t64(X)),
                                   atol=0, rtol=0)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    W, X = operands(np.random.default_rng(1), 10, 3)
    before = tenvy.envy_gaps.launches
    got = tenvy.envy_gaps(t64(W), t64(X))
    plain = tenvy.envy_gaps_plain(t64(W)[None], t64(X)[None])[0]
    torch.testing.assert_close(got, plain, atol=0, rtol=0)
    assert tenvy.envy_gaps.launches == before


@pytest.mark.parametrize("bad", ("dtype", "mismatch", "rank", "empty_k"))
def test_wrapper_rejects_malformed_operands(bad):
    W, X = (t64(a) for a in operands(np.random.default_rng(2), 8, 3))
    if bad == "dtype":
        X = X.float()
    elif bad == "mismatch":
        X = X[:5]
    elif bad == "rank":
        W, X = W[None, None], X[None, None]
    else:
        W, X = W[:, :0], X[:, :0]
    with pytest.raises((TypeError, ValueError)):
        tenvy.envy_gaps(W, X)


def test_shape_mismatch_message_names_share():
    with pytest.raises(ValueError, match="share"):
        tenvy.envy_gaps(t64(np.ones((4, 3))), t64(np.ones((5, 3))))
