"""Port's water-filling solve tier vs the JAX tier and the numpy greedy.

``repro_torch.core.torch_solve`` on the CPU (its kernel's plain version)
must give the same tau and allocation as ``repro.core.jax_solve`` and as
``repro.core.oef.solve_noncoop_fast(backend="numpy")`` to 1e-9, over the
cases of the JAX tier's own tests: random instances, padding buckets,
fractional capacity, warm hints, the batch API, and the off-class instance
that the registry hands to the LP.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax

from repro.core import jax_solve
from repro.core import oef as joef
from repro.core.profiler import PAPER_WORKLOAD_SPEEDUPS
from repro_torch.core import backends, oef, torch_solve
from repro_torch.core.torch_solve import (
    bucket, solve_noncoop_fast_batch, solve_noncoop_fast_torch)
from repro_torch.kernels import KernelError, _build
from repro_torch.kernels import waterfill as twf

PARITY_TOL = 1e-9


def x64():
    """Float64 for the JAX calls (``jax_solve.x64_scope`` needs the
    ``jax.experimental.enable_x64`` that jax 0.9 removed; with x64 already
    on it is a no-op)."""
    return jax.enable_x64(True)


def monge_instance(rng, n=None, k=None):
    """Same construction as tests/test_jax_solve.py."""
    n = n if n is not None else int(rng.integers(1, 24))
    k = k if k is not None else int(rng.integers(2, 5))
    a = np.cumsum(rng.uniform(0.05, 0.8, size=n)) + 1.0
    c = np.cumsum(rng.uniform(0.05, 0.6, size=k))
    c = c - c[0]
    W = np.power(a[:, None], c[None, :])
    m = rng.integers(1, 9, size=k).astype(float)
    return W, m


def assert_parity(W, m, *, tau_hint=None):
    """torch (via the port's registry) == jax tier == numpy greedy."""
    got = backends.dispatch("oef-noncoop", W, m, backend="torch",
                            tau_hint=tau_hint, device="cpu")
    ref = joef.solve_noncoop_fast(W, m, backend="numpy")
    with x64():
        tau_j, X_j = jax_solve.solve_noncoop_fast_jax(W, m, tau_hint=tau_hint)
    assert got.meta["backend"] == "torch"
    for tau, X in ((ref.meta["tau"], ref.X), (tau_j, X_j)):
        assert abs(got.meta["tau"] - tau) <= PARITY_TOL
        np.testing.assert_allclose(got.X, X, atol=PARITY_TOL, rtol=0)
    return got


@pytest.mark.parametrize("seed", range(8))
def test_torch_matches_jax_and_numpy_random_instances(seed):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        W, m = monge_instance(rng)
        assert_parity(W, m)


def test_torch_matches_across_padding_buckets():
    rng = np.random.default_rng(7)
    for n in (1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64):
        W, m = monge_instance(rng, n=n, k=3)
        assert_parity(W, m)


def test_torch_matches_fractional_capacity():
    rng = np.random.default_rng(11)
    W, _ = monge_instance(rng, n=9, k=3)
    assert_parity(W, np.array([2.5, 0.75, 4.25]))


@pytest.mark.parametrize("seed", range(4))
def test_warm_start_hint_parity(seed):
    """tau_hint changes the launch count only, never the answer."""
    rng = np.random.default_rng(100 + seed)
    W, m = monge_instance(rng)
    tau_ref = joef.solve_noncoop_fast(W, m, backend="numpy").meta["tau"]
    for hint in (tau_ref, tau_ref * 0.5, tau_ref * 2.0, 1e-6, 1e9, -3.0):
        got = assert_parity(W, m, tau_hint=hint)
        assert got.meta["warm_started"] is torch_solve.hint_usable(hint, W, m)


@given(st.integers(0, 2**32 - 1))
@settings(max_examples=25, deadline=None)
def test_torch_matches_property(seed):
    rng = np.random.default_rng(seed)
    W, m = monge_instance(rng)
    assert_parity(W, m)
    assert_parity(W, m, tau_hint=float(rng.uniform(0.0, 5.0)))


def test_service_scale_instance_matches_jax():
    """1024 tenants from the paper's job types on 1024 devices per type.

    Against the JAX tier (same multisection) tau and X agree to 1e-9. Against
    the numpy greedy tau does too, but X only to 1e-9 + n*|dtau|/min(W): the
    multisection accepts a tau a few 1e-12 above the optimum (its mass
    tolerance is 1e-12*(1+n*tau)) and the boundary user absorbs every
    user's share of that error — the JAX tier departs from numpy by the
    same ~4e-9 here."""
    rng = np.random.default_rng(2)
    names = sorted(PAPER_WORKLOAD_SPEEDUPS)
    W = np.array([PAPER_WORKLOAD_SPEEDUPS[names[i]]
                  for i in rng.integers(len(names), size=1024)])
    m = np.full(3, 1024.0)
    tau, X = solve_noncoop_fast_torch(W, m, device="cpu")
    with x64():
        tau_j, X_j = jax_solve.solve_noncoop_fast_jax(W, m)
    assert abs(tau - tau_j) <= PARITY_TOL
    np.testing.assert_allclose(X, X_j, atol=PARITY_TOL, rtol=0)
    ref = oef.solve_noncoop_waterfill(W, m)
    d_tau = abs(tau - ref.meta["tau"])
    assert d_tau <= PARITY_TOL
    np.testing.assert_allclose(X, ref.X, rtol=0,
                               atol=PARITY_TOL + 1024 * d_tau / W.min())


# ---------------------------------------------------------------------------
# LP-fallback boundary
# ---------------------------------------------------------------------------
def test_backend_torch_falls_back_to_lp_on_unordered():
    W = np.array([[1.0, 3.0], [2.0, 1.0]])  # rows order differently per type
    m = np.array([2.0, 2.0])
    got = backends.dispatch("oef-noncoop", W, m, backend="torch", device="cpu")
    ref = joef.solve_noncoop_fast(W, m, backend="numpy")
    assert got.meta["backend"] == "lp"
    assert got.meta["fallback_from"] == "torch"
    assert "degraded" not in got.meta
    assert abs(got.meta["tau"] - ref.meta["tau"]) <= PARITY_TOL


def test_torch_entry_point_rejects_unordered():
    W = np.array([[1.0, 3.0], [2.0, 1.0]])
    with pytest.raises(ValueError, match="consistently ordered"):
        solve_noncoop_fast_torch(W, np.array([2.0, 2.0]), device="cpu")


def test_registry_names_the_torch_tier():
    assert backends.backends_for("oef-noncoop") == ["lp", "numpy", "torch"]
    assert backends.backends_for("oef-coop") == ["lp"]
    spec = backends.resolve_backend("oef-noncoop", "torch")
    assert spec.instance_class == "piecewise-monge" and spec.fallback == "lp"
    assert "device" in spec.accepts


# ---------------------------------------------------------------------------
# batched API
# ---------------------------------------------------------------------------
def test_batch_matches_single_solves_and_jax_batch():
    rng = np.random.default_rng(17)
    B, n, k = 5, 10, 3
    Ws = np.stack([monge_instance(rng, n=n, k=k)[0] for _ in range(B)])
    ms = np.stack([np.asarray(monge_instance(rng, n=1, k=k)[1]) for _ in range(B)])
    taus, Xs = solve_noncoop_fast_batch(Ws, ms, device="cpu")
    with x64():
        taus_j, Xs_j = jax_solve.solve_noncoop_fast_batch(Ws, ms)
    assert taus.shape == (B,) and Xs.shape == (B, n, k)
    np.testing.assert_allclose(taus, taus_j, atol=PARITY_TOL, rtol=0)
    np.testing.assert_allclose(Xs, Xs_j, atol=PARITY_TOL, rtol=0)
    for b in range(B):
        ref = joef.solve_noncoop_fast(Ws[b], ms[b], backend="numpy")
        assert abs(taus[b] - ref.meta["tau"]) <= PARITY_TOL
        np.testing.assert_allclose(Xs[b], ref.X, atol=PARITY_TOL, rtol=0)


def test_batch_broadcasts_shared_capacity():
    rng = np.random.default_rng(19)
    W, m = monge_instance(rng, n=6, k=3)
    taus, Xs = solve_noncoop_fast_batch(np.stack([W, W]), m, device="cpu")
    assert abs(taus[0] - taus[1]) == 0.0
    np.testing.assert_allclose(Xs[0], Xs[1], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# incremental hook, device handling, plumbing
# ---------------------------------------------------------------------------
def test_solve_incremental_warm_start_and_reuse():
    rng = np.random.default_rng(23)
    W, m = monge_instance(rng, n=8, k=3)
    first = oef.solve_incremental(W, m, policy="oef-noncoop", backend="torch",
                                  device="cpu")
    assert first.meta["backend"] == "torch"
    assert first.meta["warm_started"] is False
    W2 = W * 1.01
    second = oef.solve_incremental(W2, m, policy="oef-noncoop", prev=first,
                                   backend="torch", device="cpu")
    ref = joef.solve_noncoop_fast(W2, m, backend="numpy")
    assert second.meta["warm_started"] is True
    assert abs(second.meta["tau"] - ref.meta["tau"]) <= PARITY_TOL
    third = oef.solve_incremental(W2, m, policy="oef-noncoop", prev=second,
                                  backend="torch", device="cpu")
    assert third.meta.get("reused") is True


def test_coop_on_torch_raises_naming_the_next_slice():
    W, m = monge_instance(np.random.default_rng(3), n=4, k=3)
    with pytest.raises(ValueError, match="next slice"):
        oef.solve_incremental(W, m, policy="oef-coop", backend="torch")
    assert oef.solve_incremental(W, m, policy="oef-coop",
                                 backend="numpy").meta["backend"] == "lp"


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA path is chip_smoke.py's")
    W, m = monge_instance(np.random.default_rng(4), n=4, k=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_noncoop_fast_torch(W, m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_solve.prewarm(8, 3, device="cuda")
    # the registry must not hide it either: without failsafe it propagates
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backends.dispatch("oef-noncoop", W, m, backend="torch")


def test_bucket_boundaries():
    assert [bucket(n) for n in (1, 8, 9, 16, 17, 1000, 1024, 1025)] == \
        [8, 8, 16, 16, 32, 1024, 1024, 2048]
    assert [bucket(n) for n in (1, 9, 1000)] == [jax_solve.bucket(n) for n in (1, 9, 1000)]


def test_default_dtype_untouched():
    W, m = monge_instance(np.random.default_rng(29), n=4, k=2)
    solve_noncoop_fast_torch(W, m, device="cpu")
    assert torch.get_default_dtype() == torch.float32


def test_prewarm_covers_buckets():
    assert torch_solve.prewarm(20, 2, device="cpu") == [8, 16, 32]


def test_cold_and_warm_solves_probe_iters_and_iters_plus_one_times(monkeypatch):
    """On the card each probe is one kernel launch; count the probes here."""
    calls = []
    real = twf.waterfill_masses

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(torch_solve, "waterfill_masses", counting)
    W, m = monge_instance(np.random.default_rng(31), n=12, k=3)
    tau, _ = solve_noncoop_fast_torch(W, m, device="cpu")
    assert len(calls) == torch_solve.ITERS
    assert all(s == (1, torch_solve.LANES) for s in calls)
    calls.clear()
    solve_noncoop_fast_torch(W, m, tau_hint=tau * 0.9, device="cpu")
    assert len(calls) == torch_solve.ITERS + 1
    assert calls[0] == (1, 1)


# ---------------------------------------------------------------------------
# a failed kernel is never answered by the LP
# ---------------------------------------------------------------------------
def _broken_kernel(*_a):
    raise KernelError("waterfill_masses kernel launch failed: test")


def test_dispatch_reraises_kernel_errors_even_failsafe(monkeypatch):
    monkeypatch.setattr(torch_solve, "waterfill_masses", _broken_kernel)
    W, m = monge_instance(np.random.default_rng(37), n=6, k=3)
    with pytest.raises(KernelError, match="launch failed"):
        backends.dispatch("oef-noncoop", W, m, backend="torch", device="cpu",
                          failsafe=True, max_retries=1)


def test_dispatch_failsafe_still_absorbs_other_crashes(monkeypatch):
    def crash(*_a):
        raise RuntimeError("a host-side bug")

    monkeypatch.setattr(torch_solve, "waterfill_masses", crash)
    W, m = monge_instance(np.random.default_rng(37), n=6, k=3)
    got = backends.dispatch("oef-noncoop", W, m, backend="torch", device="cpu",
                            failsafe=True)
    assert got.meta["backend"] == "lp" and got.meta["degraded"] is True


def test_card_faults_surface_as_kernel_errors():
    with pytest.raises(KernelError, match="CUDA error"):
        with torch_solve._card_errors(torch.device("cuda")):
            raise RuntimeError("CUDA error: an illegal memory access")
    with pytest.raises(RuntimeError) as exc:
        with torch_solve._card_errors(torch.device("cpu")):
            raise RuntimeError("plain")
    assert not isinstance(exc.value, KernelError)


def test_missing_nvcc_raises_kernel_error(monkeypatch):
    import shutil
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    with pytest.raises(KernelError, match="nvcc not found"):
        _build.nvcc_path()
