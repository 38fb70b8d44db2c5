"""Fairness/efficiency property checkers (§2.3.1 of the paper).

These are used by the test suite (hypothesis property tests), the Table-1
benchmark, and the simulator's runtime assertions.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .lp import solve_lp
from .types import Allocation

Array = np.ndarray

DEFAULT_TOL = 1e-6


def envy_matrix(W: Array, X: Array) -> Array:
    """E[l, i] = W_l.x_i - W_l.x_l  (positive => l envies i)."""
    W = np.asarray(W, dtype=np.float64)
    X = np.asarray(X, dtype=np.float64)
    own = np.einsum("lk,lk->l", W, X)
    cross = W @ X.T  # cross[l, i] = W_l . x_i
    return cross - own[:, None]


def is_envy_free(W: Array, X: Array, tol: float = DEFAULT_TOL) -> bool:
    return bool(np.max(envy_matrix(W, X)) <= tol)


def sharing_incentive_slack(W: Array, X: Array, m: Array) -> Array:
    """slack[l] = W_l.x_l - W_l.(m/n); negative => SI violated for l."""
    W = np.asarray(W, dtype=np.float64)
    X = np.asarray(X, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n = W.shape[0]
    own = np.einsum("lk,lk->l", W, X)
    fair = W @ (m / n)
    return own - fair


def is_sharing_incentive(W: Array, X: Array, m: Array, tol: float = DEFAULT_TOL) -> bool:
    return bool(np.min(sharing_incentive_slack(W, X, m)) >= -tol)


def pareto_improvement_value(W: Array, X: Array, m: Array, *, method: str = "highs",
                             within: Optional[str] = None) -> float:
    """Max total throughput slack achievable without hurting anyone.

    Solves: max sum_l s_l s.t. W_l.x'_l >= W_l.x_l + s_l, s_l >= 0, capacity.
    Result ~ 0  <=>  X is Pareto-efficient.

    ``within`` restricts the improving allocation to the mechanism's own
    fairness domain ("envy-free" | "equal-throughput" | None). The paper's
    Thm 5.3 proves PE *within* the feasible domain; globally (DRF-strong PE,
    within=None) cooperative OEF can be Pareto-dominated by an envy-violating
    allocation — an empirical nuance we surface in Table-1 (see
    benchmarks/table1_properties.py and EXPERIMENTS.md).
    """
    W = np.asarray(W, dtype=np.float64)
    X = np.asarray(X, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n, k = W.shape
    own = np.einsum("lk,lk->l", W, X)
    nv = n * k + n  # x' variables then s variables
    c = np.concatenate([np.zeros(n * k), np.ones(n)])
    # capacity
    A_cap = np.zeros((k, nv))
    for j in range(k):
        A_cap[j, j : n * k : k] = 1.0
    b_cap = m.copy()
    # -W_l.x'_l + s_l <= -own_l
    rows = np.zeros((n, nv))
    for l in range(n):
        rows[l, l * k : (l + 1) * k] = -W[l]
        rows[l, n * k + l] = 1.0
    A_ub = np.vstack([A_cap, rows])
    b_ub = np.concatenate([b_cap, -own])
    A_eq, b_eq = None, None
    if within == "envy-free":
        ef_rows = []
        for l in range(n):
            for i in range(n):
                if i == l:
                    continue
                row = np.zeros(nv)
                row[l * k : (l + 1) * k] = -W[l]
                row[i * k : (i + 1) * k] += W[l]
                ef_rows.append(row)
        A_ub = np.vstack([A_ub, np.vstack(ef_rows)])
        b_ub = np.concatenate([b_ub, np.zeros(len(ef_rows))])
    elif within == "equal-throughput":
        eq = np.zeros((max(n - 1, 0), nv))
        for l in range(1, n):
            eq[l - 1, l * k : (l + 1) * k] = W[l]
            eq[l - 1, 0:k] -= W[0]
        A_eq, b_eq = eq, np.zeros(max(n - 1, 0))
    res = solve_lp(c, A_ub, b_ub, A_eq, b_eq, method=method)
    if not res.ok:
        # X itself may be infeasible w.r.t. capacity by > tol: treat as failure.
        return float("inf")
    return float(res.fun)


def is_pareto_efficient(W: Array, X: Array, m: Array, tol: float = 1e-5) -> bool:
    return pareto_improvement_value(W, X, m) <= tol


@dataclasses.dataclass
class SPProbeResult:
    honest_throughput: float
    best_cheat_throughput: float
    best_fake: Optional[Array]

    @property
    def gain(self) -> float:
        return self.best_cheat_throughput - self.honest_throughput


def strategy_proofness_probe(
    mechanism: Callable[[Array, Array], Allocation],
    W: Array,
    m: Array,
    user: int,
    *,
    n_trials: int = 16,
    max_inflation: float = 2.0,
    rng: Optional[np.random.Generator] = None,
) -> SPProbeResult:
    """Probe SP: user inflates entries of their speedup vector (elementwise >=
    truth, per the paper's SP definition) and we measure their *true*
    normalized throughput under the resulting allocation.
    """
    rng = rng or np.random.default_rng(0)
    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    honest = mechanism(W, m)
    w_true = W[user]
    honest_tp = float(np.dot(w_true, honest.X[user]))
    best_tp, best_fake = -np.inf, None
    for _ in range(n_trials):
        fake = w_true * (1.0 + rng.uniform(0.0, max_inflation - 1.0, size=w_true.shape))
        fake[0] = w_true[0]  # reference type stays normalized
        fake = np.maximum(fake, w_true)
        Wf = W.copy()
        Wf[user] = fake
        try:
            alloc = mechanism(Wf, m)
        except Exception:
            continue
        tp = float(np.dot(w_true, alloc.X[user]))
        if tp > best_tp:
            best_tp, best_fake = tp, fake
    if best_fake is None:
        best_tp = honest_tp
    return SPProbeResult(honest_tp, best_tp, best_fake)


def adjacency_ok(X: Array, tol: float = DEFAULT_TOL) -> bool:
    """Thm 5.2: each user's nonzero type shares form a contiguous range."""
    X = np.asarray(X, dtype=np.float64)
    for row in X:
        nz = np.where(row > tol)[0]
        if len(nz) > 1 and (nz[-1] - nz[0] + 1) != len(nz):
            return False
    return True


def nonzero_count(X: Array, tol: float = DEFAULT_TOL) -> int:
    """Extreme-point bound (§4.4): basic optimal X has <= n + k - 1 nonzeros."""
    return int(np.sum(np.asarray(X) > tol))


def total_efficiency(W: Array, X: Array) -> float:
    return float(np.einsum("lk,lk->", np.asarray(W, dtype=np.float64), np.asarray(X, dtype=np.float64)))


def efficiency_optimality_gap(
    W: Array,
    X: Array,
    m: Array,
    constraint: str,
    *,
    method: str = "highs",
) -> float:
    """Gap between achieved efficiency and the LP optimum under the same
    fairness constraint family ('none' | 'equal-throughput' | 'envy-free')."""
    from . import oef  # local import to avoid cycle

    if constraint == "none":
        opt = oef.solve_efficiency_only(W, m, method=method)
    elif constraint == "equal-throughput":
        opt = oef.solve_noncoop(W, m, method=method)
    elif constraint == "envy-free":
        opt = oef.solve_coop(W, m, method=method)
    else:
        raise ValueError(constraint)
    return total_efficiency(W, opt.X) - total_efficiency(W, X)


#: ``module.name -> wrapped solver`` for every @audited_solver entry point.
AUDITED_SOLVERS: Dict[str, Callable[..., Allocation]] = {}


def audit_enabled() -> bool:
    """True when the ``REPRO_AUDIT`` env var requests audits globally."""
    return os.environ.get("REPRO_AUDIT", "").strip().lower() in ("1", "true", "yes", "on")


def audited_solver(fn: Callable[..., Allocation]) -> Callable[..., Allocation]:
    """Contract decorator for solver entry points returning an ``Allocation``.

    Adds an ``audit=`` keyword (default: :func:`audit_enabled`, i.e. the
    ``REPRO_AUDIT`` env var). When enabled, the fairness/efficiency
    :func:`property_report` for the returned allocation is attached at
    ``alloc.meta["audit"]``, so any caller — the sweep harness, the online
    service, a notebook — can audit every mechanism uniformly without knowing
    its internals. Registration in :data:`AUDITED_SOLVERS` gives benchmarks a
    single catalog of auditable mechanisms. Enforced by analysis rule C301.
    """

    @functools.wraps(fn)
    def wrapper(*args, audit: Optional[bool] = None, **kwargs) -> Allocation:
        alloc = fn(*args, **kwargs)
        if audit if audit is not None else audit_enabled():
            alloc.meta["audit"] = property_report(alloc.W, alloc.X, alloc.m)
        return alloc

    wrapper.__audited_solver__ = True
    AUDITED_SOLVERS[f"{fn.__module__}.{fn.__name__}"] = wrapper
    return wrapper


def property_report(W: Array, X: Array, m: Array) -> Dict[str, object]:
    return {
        "envy_free": is_envy_free(W, X),
        "sharing_incentive": is_sharing_incentive(W, X, m),
        "pareto_efficient": is_pareto_efficient(W, X, m),
        "adjacent_types": adjacency_ok(X),
        "total_efficiency": total_efficiency(W, X),
        "max_envy": float(np.max(envy_matrix(W, X))),
        "min_si_slack": float(np.min(sharing_incentive_slack(W, X, m))),
    }
