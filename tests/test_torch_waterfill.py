"""Port's water-filling kernel module vs the JAX package's, on the CPU.

On CPU tensors ``repro_torch.kernels.waterfill.waterfill_masses`` runs its
plain torch version; it must agree with the JAX reference path
(``waterfill_masses_ref``) and with the Pallas kernel in interpret mode to
atol = rtol = 1e-12, the tolerance of the JAX package's own kernel test
(cumsums taken in another order differ in the last bits). The CUDA kernel
itself is held against the plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import jax_solve
from repro.kernels import waterfill as jwf
from repro_torch.core import torch_solve
from repro_torch.kernels import waterfill as twf
from torch_threads import one_thread

one_thread()

TOL = 1e-12


def x64():
    """Float64 for the JAX calls. ``jax_solve.x64_scope`` reaches for
    ``jax.experimental.enable_x64``, which jax 0.9 removed; with x64 already
    on, that helper is a no-op and the JAX package runs unchanged."""
    return jax.enable_x64(True)


def monge_instance(rng, n, k):
    """Same construction as tests/test_jax_solve.py."""
    a = np.cumsum(rng.uniform(0.05, 0.8, size=n)) + 1.0
    c = np.cumsum(rng.uniform(0.05, 0.6, size=k))
    c = c - c[0]
    W = np.power(a[:, None], c[None, :])
    m = rng.integers(1, 9, size=k).astype(float)
    return W, m


def padded(W, m):
    _, Wf, m64, mask = torch_solve._prepare(W, m)
    return Wf, m64, mask


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


SHAPES = ((8, 2), (16, 3), (64, 4), (256, 3))


@pytest.mark.parametrize("n,k", SHAPES)
@pytest.mark.parametrize("T", (1, 8, 16))
def test_masses_match_jax_reference_and_interpret_kernel(n, k, T):
    rng = np.random.default_rng(3 + n + k)
    W, m = monge_instance(rng, n, k)
    Wf, m64, mask = padded(W, m)
    hi = float(W.max() * m.sum()) + 1.0
    taus = np.linspace(0.0, hi, T) if T > 1 else np.array([0.37 * hi])
    got = twf.waterfill_masses(t64(taus), t64(Wf), t64(m64), t64(mask)).numpy()
    with x64():
        args = (jnp.asarray(taus), jnp.asarray(Wf), jnp.asarray(m64), jnp.asarray(mask))
        ref = np.asarray(jwf.waterfill_masses_ref(*args))
        pallas = np.asarray(jwf.waterfill_masses(*args, interpret=True))
    assert got.shape == (T,) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n,k", SHAPES)
def test_allocate_matches_jax(n, k):
    rng = np.random.default_rng(40 + n)
    W, m = monge_instance(rng, n, k)
    Wf, m64, mask = padded(W, m)
    tau, _ = torch_solve.solve_noncoop_fast_torch(W, m, device="cpu")
    got = twf.waterfill_allocate(t64(tau), t64(Wf), t64(m64), t64(mask)).numpy()
    with x64():
        ref = np.asarray(jwf.waterfill_allocate(
            jnp.asarray(tau), jnp.asarray(Wf), jnp.asarray(m64), jnp.asarray(mask)))
    assert got.shape == Wf.shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    assert np.all(got[mask == 0] == 0.0)


def test_batched_operands_match_single_instances():
    rng = np.random.default_rng(9)
    inst = [padded(*monge_instance(rng, 12, 3)) for _ in range(3)]
    taus = np.stack([np.linspace(0.1, 20.0, 8) * (b + 1) for b in range(3)])
    Wfs, ms, masks = (np.stack(x) for x in zip(*inst))
    got = twf.waterfill_masses(t64(taus), t64(Wfs), t64(ms), t64(masks))
    assert got.shape == (3, 8)
    for b, (Wf, m64, mask) in enumerate(inst):
        one = twf.waterfill_masses(t64(taus[b]), t64(Wf), t64(m64), t64(mask))
        torch.testing.assert_close(got[b], one, atol=0, rtol=0)
    X = twf.waterfill_allocate(t64([1.0, 2.0, 3.0]), t64(Wfs), t64(ms), t64(masks))
    assert X.shape == Wfs.shape
    torch.testing.assert_close(
        X[1], twf.waterfill_allocate(t64(2.0), *(t64(a) for a in inst[1])),
        atol=0, rtol=0)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    Wf, m64, mask = padded(*monge_instance(np.random.default_rng(1), 10, 3))
    before = twf.waterfill_masses.launches
    got = twf.waterfill_masses(t64([1.0, 2.0]), t64(Wf), t64(m64), t64(mask))
    plain = twf.waterfill_masses_plain(
        t64([[1.0, 2.0]]), t64(Wf[None]), t64(m64[None]), t64(mask[None]))[0]
    torch.testing.assert_close(got, plain, atol=0, rtol=0)
    assert twf.waterfill_masses.launches == before


@pytest.mark.parametrize("bad", ("dtype", "shape_m", "shape_mask", "shape_W",
                                 "batch"))
def test_wrapper_rejects_malformed_operands(bad):
    Wf, m64, mask = (t64(a) for a in padded(*monge_instance(
        np.random.default_rng(2), 8, 3)))
    taus = t64([1.0, 2.0])
    ops = {"taus": taus, "Wf": Wf, "m": m64, "mask": mask}
    if bad == "dtype":
        ops["taus"] = taus.float()
    elif bad == "shape_m":
        ops["m"] = m64[:2]
    elif bad == "shape_mask":
        ops["mask"] = mask[:4]
    elif bad == "shape_W":
        ops["Wf"] = Wf[None, None]
    else:
        ops["taus"] = taus[None].repeat(2, 1)
    with pytest.raises((TypeError, ValueError)):
        twf.waterfill_masses(ops["taus"], ops["Wf"], ops["m"], ops["mask"])
