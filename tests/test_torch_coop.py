"""Port's cooperative primal–dual tier vs the JAX tier and the LP.

``repro_torch.core.torch_coop.solve_coop_pd`` on the CPU (its envy kernel's
plain version) is held, over the cases of ``tests/test_jax_coop.py``, both
against the scipy LP (objective, envy, capacity, the paper's EF and SI
audits, within 1e-6 as the JAX tier's own tests hold it) and against
``repro.core.jax_coop.solve_coop_pd`` on the same inputs: objective within
1e-9 relative, ``X`` within 1e-7, and the same ``pd_iters`` and
``crossover``. Plus warm starts (the port's own state and a JAX
allocation's carried through ``interop``), the certified-or-fallback
contract, the batch API, ``prewarm``, the kernel-error rule and the exact
number of envy evaluations per segment.
"""
import numpy as np
import pytest
import torch

import jax

from repro.core import jax_coop
from repro.core import oef as joef
from repro_torch import interop
from repro_torch.core import backends, oef, properties, torch_coop
from repro_torch.core.backends import BackendError
from repro_torch.kernels import KernelError
from repro_torch.kernels import envy as tenvy
from torch_threads import one_thread

one_thread()

TOL = 1e-6          # against the LP, as tests/test_jax_coop.py
OBJ_REL = 1e-9      # objective against the JAX tier, relative
X_TOL = 1e-7        # allocation against the JAX tier


def x64():
    """Float64 for the JAX calls (jax 0.9 removed the
    ``jax.experimental.enable_x64`` that ``jax_solve.x64_scope`` uses; with
    x64 already on it is a no-op)."""
    return jax.enable_x64(True)


def catalog_instance(rng, n, g=5, k=3):
    """n tenants drawn from a g-profile catalog (the service's regime)."""
    cat = np.cumprod(1.0 + rng.uniform(0.05, 1.0, size=(g, k)), axis=1)
    cat /= cat[:, :1]
    W = cat[rng.integers(0, g, size=n)]
    m = rng.uniform(1.0, 4.0, size=k) * n / 4
    return W, m


def distinct_instance(rng, n, k=3):
    W = np.cumprod(1.0 + rng.uniform(0.05, 1.0, size=(n, k)), axis=1)
    W /= W[:, :1]
    m = rng.uniform(1.0, 4.0, size=k) * n / 4
    return W, m


def envy_max(W, X):
    own = np.einsum("lk,lk->l", W, X)
    E = W @ X.T - own[:, None]
    np.fill_diagonal(E, 0.0)
    return float(E.max())


def assert_lp_parity(W, m, alloc):
    lp = joef.solve_coop(W, m)
    o_pd, o_lp = (W * alloc.X).sum(), (W * lp.X).sum()
    assert abs(o_pd - o_lp) <= TOL * max(abs(o_lp), 1.0)
    assert envy_max(W, alloc.X) <= TOL
    assert np.all(alloc.X.sum(axis=0) <= m + 1e-9 * max(m.max(), 1.0))
    rep = properties.property_report(W, alloc.X, m)
    assert rep["envy_free"] and rep["sharing_incentive"]


def assert_jax_parity(W, m, alloc, ref):
    o, o_ref = (W * alloc.X).sum(), (W * ref.X).sum()
    assert abs(o - o_ref) <= OBJ_REL * max(abs(o_ref), 1.0)
    np.testing.assert_allclose(alloc.X, ref.X, atol=X_TOL, rtol=0)
    for key in ("pd_iters", "crossover", "warm_started"):
        assert alloc.meta.get(key) == ref.meta.get(key), key


def solve_both(W, m, **kw):
    got = torch_coop.solve_coop_pd(W, m, device="cpu", **kw)
    with x64():
        ref = jax_coop.solve_coop_pd(W, m, **kw)
    return got, ref


# ---------------------------------------------------------------------------
# parity vs the LP and the JAX tier
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(5))
def test_catalog_parity(seed):
    rng = np.random.default_rng(100 + seed)
    W, m = catalog_instance(rng, int(rng.integers(8, 64)))
    got, ref = solve_both(W, m)
    assert got.meta["policy"] == "oef-coop"
    lb, ub = got.meta["objective_bounds"]
    assert ub - lb <= TOL * max(abs(lb), 1.0)  # the certificate itself
    assert_lp_parity(W, m, got)
    assert_jax_parity(W, m, got, ref)


@pytest.mark.parametrize("kind,n", (("catalog", 40), ("distinct", 20),
                                    ("distinct", 64)))
def test_pd_segment_matches_jax_segment(kind, n):
    """One 250-step segment from a cold start, on the same padded operands:
    the port's loop of torch ops against the JAX tier's jitted segment. The
    two sum in different orders (the envy gaps over k in order against
    ``W @ X.T``; XLA fuses), so they agree to a few ulps, not bit for bit."""
    make = catalog_instance if kind == "catalog" else distinct_instance
    W, m = make(np.random.default_rng(n), n)
    Wd, _, cnt = torch_coop._reduce(W)
    G, Wp, cntp, _, pairm, tau, sig_env, sig_cap = torch_coop._padded_operands(
        Wd, cnt, W.shape[1])
    x, p, L = np.zeros((G, W.shape[1])), np.zeros(W.shape[1]), np.zeros((G, G))
    with x64():
        ref = [np.asarray(a) for a in jax_coop._pd_segment(
            Wp, cntp, m, pairm, tau, sig_env, sig_cap, x, p, L)]
    ops = torch_coop._device_operands(
        torch.device("cpu"), (Wp[None], cntp[None], m[None], pairm[None],
                              tau[None], sig_env[None], sig_cap),
        x[None], p[None], L[None])
    got = [a[0].numpy() for a in torch_coop._pd_segment(*ops)]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_small_distinct_parity(n):
    W, m = distinct_instance(np.random.default_rng(n), n)
    got, ref = solve_both(W, m)
    assert_lp_parity(W, m, got)
    assert_jax_parity(W, m, got, ref)


def test_distinct_instance_certified_after_many_segments():
    """32 distinct rows: past the rescue size, so the PD segments alone must
    bring the iterate to a certifiable active set (33 segments here)."""
    W, m = distinct_instance(np.random.default_rng(1), 32)
    got, ref = solve_both(W, m)
    assert got.meta["crossover"] == "active-set" and got.meta["pd_iters"] > 5000
    assert_lp_parity(W, m, got)
    assert_jax_parity(W, m, got, ref)


def test_degenerate_all_ties():
    W = np.tile([[1.0, 2.0, 3.0]], (12, 1))
    m = np.array([4.0, 2.0, 6.0])
    got, ref = solve_both(W, m)
    assert np.allclose(got.X, np.tile(m / 12, (12, 1)), atol=1e-8)
    assert_lp_parity(W, m, got)
    assert_jax_parity(W, m, got, ref)


def test_single_tenant_takes_all():
    W = np.array([[1.0, 2.0, 4.0]])
    m = np.array([3.0, 1.0, 2.0])
    got, ref = solve_both(W, m)
    assert np.allclose(got.X, m[None, :])
    assert got.meta["pd_iters"] == 0
    np.testing.assert_array_equal(got.X, ref.X)


# ---------------------------------------------------------------------------
# warm start, fallback, batch
# ---------------------------------------------------------------------------
def test_warm_start_from_own_state_and_from_a_jax_allocation():
    W, m = catalog_instance(np.random.default_rng(1), 32)
    cold, cold_j = solve_both(W, m)
    warm = torch_coop.solve_coop_pd(W, m * 1.02, prev_state=cold.meta["pd_state"],
                                    device="cpu")
    with x64():
        warm_j = jax_coop.solve_coop_pd(W, m * 1.02,
                                        prev_state=cold_j.meta["pd_state"])
    assert warm_j.meta["pd_iters"] == 0 and warm_j.meta["warm_started"] is True
    assert_jax_parity(W, m * 1.02, warm, warm_j)
    assert_lp_parity(W, m * 1.02, warm)
    # a JAX allocation's certified saddle, carried into the port as plain data
    prev = interop.allocation_from_arrays(cold_j.X, cold_j.W, cold_j.m,
                                          cold_j.rows, cold_j.meta)
    state = prev.meta["pd_state"]
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float64
               for v in state.values())
    assert state["x"] is not cold_j.meta["pd_state"]["x"]
    carried = oef.solve_incremental(W, m * 1.02, policy="oef-coop", prev=prev,
                                    backend="torch", device="cpu")
    assert carried.meta["backend"] == "torch"
    assert_jax_parity(W, m * 1.02, carried, warm_j)


def test_warm_start_rejected_on_profile_change():
    W, m = catalog_instance(np.random.default_rng(2), 16)
    cold = torch_coop.solve_coop_pd(W, m, device="cpu")
    W2, m2 = catalog_instance(np.random.default_rng(3), 16)
    again = torch_coop.solve_coop_pd(W2, m2, prev_state=cold.meta["pd_state"],
                                     device="cpu")
    assert again.meta["warm_started"] is False
    assert_lp_parity(W2, m2, again)


def test_budget_exhaustion_raises_backend_error():
    W, m = distinct_instance(np.random.default_rng(4), 24)
    with pytest.raises(BackendError, match="did not certify"):
        torch_coop.solve_coop_pd(W, m, max_iters=250, seg=250, device="cpu")


def test_dispatch_falls_back_to_lp_on_exhaustion():
    W, m = distinct_instance(np.random.default_rng(4), 24)
    alloc = backends.dispatch("oef-coop", W, m, backend="torch", max_iters=250,
                              seg=250, device="cpu")
    assert alloc.meta["backend"] == "lp"
    assert alloc.meta["fallback_from"] == "torch"
    assert "certify" in alloc.meta["fallback_reason"]
    assert envy_max(W, alloc.X) <= TOL


def test_batch_matches_single_solves_and_jax_batch():
    W, m = catalog_instance(np.random.default_rng(5), 8)
    Ws = np.stack([W, W[::-1]])
    Xs = torch_coop.solve_coop_batch(Ws, m, device="cpu")
    with x64():
        Xs_j = jax_coop.solve_coop_batch(Ws, m)
    assert Xs.shape == Ws.shape
    np.testing.assert_allclose(Xs, Xs_j, atol=X_TOL, rtol=0)
    for b in range(2):
        single = torch_coop.solve_coop_pd(Ws[b], m, device="cpu")
        assert abs((Ws[b] * Xs[b]).sum() - (Ws[b] * single.X).sum()) <= TOL
        assert envy_max(Ws[b], Xs[b]) <= TOL


def test_prewarm_runs_the_jax_tiers_buckets():
    assert torch_coop.prewarm(20, 3, seg=10, device="cpu") == [8, 16, 32]
    assert torch_coop.prewarm(3, 4, seg=10, device="cpu") == [8]


# ---------------------------------------------------------------------------
# registry, launches, the card's errors
# ---------------------------------------------------------------------------
def test_registry_and_incremental_hook_reach_the_torch_tier():
    assert backends.backends_for("oef-coop") == ["lp", "torch"]
    spec = backends.resolve_backend("oef-coop", "torch")
    assert spec.fallback == "lp" and spec.instance_class == "any"
    assert {"prev_state", "device"} <= set(spec.accepts)
    W, m = catalog_instance(np.random.default_rng(6), 24)
    first = oef.solve_incremental(W, m, policy="oef-coop", backend="torch",
                                  device="cpu")
    assert first.meta["backend"] == "torch" and first.meta["pd_iters"] > 0
    second = oef.solve_incremental(W, m * 1.01, policy="oef-coop", prev=first,
                                   backend="torch", device="cpu")
    assert second.meta["warm_started"] is True and second.meta["pd_iters"] == 0
    assert oef.solve_incremental(W, m * 1.01, policy="oef-coop", prev=second,
                                 backend="torch", device="cpu").meta["reused"]


def test_one_envy_evaluation_per_pd_iteration(monkeypatch):
    """On the card each PD step is one kernel launch; count the steps here."""
    calls = []
    real = tenvy.envy_gaps_plain

    def counting(W, X):
        calls.append(tuple(W.shape))
        return real(W, X)

    monkeypatch.setattr(tenvy, "envy_gaps_plain", counting)
    W, m = distinct_instance(np.random.default_rng(1), 32)
    got = torch_coop.solve_coop_pd(W, m, seg=100, device="cpu")
    assert got.meta["pd_iters"] % 100 == 0
    assert len(calls) == got.meta["pd_iters"]
    assert set(calls) == {(1, 32, 3)}
    calls.clear()
    warm = torch_coop.solve_coop_pd(W, m * 1.01, prev_state=got.meta["pd_state"],
                                    seg=100, device="cpu")
    assert warm.meta["warm_started"] is True
    assert len(calls) == warm.meta["pd_iters"] > 0
    # a small instance crosses over to the reduced LP after one segment, and
    # its warm re-solve certifies on the host with no PD step at all
    Wc, mc = catalog_instance(np.random.default_rng(100), 20)
    calls.clear()
    resc = torch_coop.solve_coop_pd(Wc, mc, device="cpu")
    assert resc.meta["crossover"] == "reduced-lp"
    assert len(calls) == resc.meta["pd_iters"] == torch_coop.SEG_ITERS
    calls.clear()
    again = torch_coop.solve_coop_pd(Wc, mc * 1.02,
                                     prev_state=resc.meta["pd_state"], device="cpu")
    assert again.meta["pd_iters"] == 0 and calls == []


def test_kernel_error_passes_through_failsafe_dispatch(monkeypatch):
    def broken(*_a):
        raise KernelError("envy_gaps kernel launch failed: test")

    monkeypatch.setattr(torch_coop, "envy_gaps", broken)
    W, m = catalog_instance(np.random.default_rng(7), 16)
    with pytest.raises(KernelError, match="launch failed"):
        backends.dispatch("oef-coop", W, m, backend="torch", device="cpu",
                          failsafe=True, max_retries=1)


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA path is chip_smoke.py's")
    W, m = catalog_instance(np.random.default_rng(8), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_coop.solve_coop_pd(W, m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_coop.prewarm(8, 3)
