"""OEF allocation mechanisms (the paper's core contribution, §4.2).

Implements:
  - ``solve_noncoop``      — Eq. (9): max total normalized throughput subject to
    capacity and *equal per-user throughput* (strategy-proof, Thm 5.4);
  - ``solve_coop``         — Eq. (10): max total throughput subject to capacity
    and *envy-freeness* constraints (EF + SI + optimal efficiency, Thm 5.1);
  - ``solve_efficiency_only`` — Eq. (4): unconstrained throughput max (used to
    demonstrate the conflicts of §3.1, not a real policy);
  - weighted OEF + multi-job-type tenants via *row replication* (§4.2.3/4.2.4);
  - ``solve_noncoop_waterfill`` / ``solve_noncoop_waterfill_torch`` —
    beyond-paper O(n log n + n·k) exact water-filling for the
    (piecewise-)Monge staircase class (see :func:`classify_staircase`),
    validated against the LP;
  - ``solve_noncoop_fast`` — the historical fast entry point, now a thin
    shim over :func:`repro_torch.core.backends.dispatch`.

Backend selection is the registry's job (:mod:`repro_torch.core.backends`):
this module registers the LP solvers as the ``"lp"`` backends, the numpy
water-filling as ``"numpy"`` (the ``oef-noncoop`` default, LP fallback) and
the GPU water-filling tier as ``"torch"``. The cooperative program's GPU tier,
the primal–dual solver of :mod:`repro_torch.core.torch_coop`, registers
itself as the ``"torch"`` backend of ``oef-coop`` (LP fallback) when
``repro_torch.core`` is imported. All solvers return an :class:`Allocation`
over *rows* (virtual users); use :func:`evaluate_tenants` for the
tenant-level API with folding.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import backends
from .lp import LPError, LPResult, solve_lp
from .properties import audited_solver
from .types import (
    Allocation,
    ClusterSpec,
    JobTypeProfile,
    Tenant,
    default_rows,
    validate_speedup_matrix,
)

Array = np.ndarray


# ---------------------------------------------------------------------------
# Row-level solvers
# ---------------------------------------------------------------------------


@audited_solver
def solve_efficiency_only(W: Array, m: Array, *, method: str = "highs") -> Allocation:
    """Eq. (4): pure throughput maximization — intentionally unfair (§3.1.1)."""
    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n, k = W.shape
    c = W.ravel()
    A_ub, b_ub = _capacity_constraints(n, k, m)
    res = _solve(c, A_ub, b_ub, None, None, method)
    X = res.x.reshape(n, k)
    return Allocation(X=X, rows=default_rows(n), W=W, m=m,
                      meta={"policy": "efficiency-only", "lp": res})


@audited_solver
def solve_noncoop(W: Array, m: Array, *, method: str = "highs") -> Allocation:
    """Non-cooperative OEF, Eq. (9): equal normalized throughput across users.

    maximize   sum_{l,j} w_l^j x_l^j
    s.t.       sum_l x_l^j <= m_j                      (capacity)
               W_l . x_l == W_0 . x_0   for all l      (Eq. 9c)
    """
    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    validate_speedup_matrix(W, normalized=False)
    n, k = W.shape
    c = W.ravel()
    A_ub, b_ub = _capacity_constraints(n, k, m)
    # Equal-throughput chain: W_l.x_l - W_0.x_0 == 0 for l = 1..n-1.
    A_eq = np.zeros((max(n - 1, 0), n * k))
    for l in range(1, n):
        A_eq[l - 1, l * k : (l + 1) * k] = W[l]
        A_eq[l - 1, 0:k] -= W[0]
    b_eq = np.zeros(max(n - 1, 0))
    res = _solve(c, A_ub, b_ub, A_eq if n > 1 else None, b_eq if n > 1 else None, method)
    X = res.x.reshape(n, k)
    tau = float(np.dot(W[0], X[0])) if n else 0.0
    return Allocation(X=X, rows=default_rows(n), W=W, m=m,
                      meta={"policy": "oef-noncoop", "tau": tau, "lp": res})


@audited_solver
def solve_coop(W: Array, m: Array, *, method: str = "highs") -> Allocation:
    """Cooperative OEF, Eq. (10): envy-freeness constraints.

    maximize   sum_{l,j} w_l^j x_l^j
    s.t.       sum_l x_l^j <= m_j                      (capacity)
               W_l . x_l >= W_l . x_i  for all i != l  (Eq. 10c)
    """
    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    validate_speedup_matrix(W, normalized=False)
    n, k = W.shape
    c = W.ravel()
    A_cap, b_cap = _capacity_constraints(n, k, m)
    # EF rows: -(W_l.x_l) + W_l.x_i <= 0.
    ef_rows = []
    for l in range(n):
        for i in range(n):
            if i == l:
                continue
            row = np.zeros(n * k)
            row[l * k : (l + 1) * k] = -W[l]
            row[i * k : (i + 1) * k] += W[l]
            ef_rows.append(row)
    if ef_rows:
        A_ub = np.vstack([A_cap, np.vstack(ef_rows)])
        b_ub = np.concatenate([b_cap, np.zeros(len(ef_rows))])
    else:
        A_ub, b_ub = A_cap, b_cap
    res = _solve(c, A_ub, b_ub, None, None, method)
    X = res.x.reshape(n, k)
    return Allocation(X=X, rows=default_rows(n), W=W, m=m,
                      meta={"policy": "oef-coop", "lp": res})


@audited_solver
def solve_noncoop_waterfill(
    W: Array,
    m: Array,
    *,
    iters: int = 80,
    tau_hint: Optional[float] = None,
) -> Allocation:
    """Beyond-paper exact combinatorial solver for non-cooperative OEF.

    Exploits the adjacency structure (Thm 5.2 / Lemma 3.1): on instances in
    the *(piecewise-)Monge staircase class* (:func:`classify_staircase`), the
    optimal allocation is a staircase: process users from fastest to slowest,
    assigning the fastest remaining capacity until each reaches the common
    throughput tau. tau* is found by monotone bisection on the greedy
    feasibility check — O((n + k) log(1/eps)) versus the LP's superlinear
    cost.

    ``tau_hint`` warm-starts the bisection from a previous solve's tau (the
    online service passes the last equal-throughput level): the bracket is
    found by exponential growth/shrink around the hint, so a re-solve after a
    small capacity/population change converges in a handful of probes.

    Instances outside the staircase class raise
    :class:`~repro_torch.core.backends.BackendError`: this is the registered
    ``"numpy"`` backend (and default) of program ``oef-noncoop`` with
    fallback ``"lp"``, so callers going through the registry get the exact LP
    automatically.
    """
    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n, k = W.shape
    cls = classify_staircase(W)
    if cls is None:
        raise backends.BackendError(
            "instance is outside the (piecewise-)Monge staircase class; the "
            "greedy water-filling is not provably optimal — solve via the LP")
    klass, order, Ws = cls

    def greedy(tau: float) -> Optional[Array]:
        """Fill users fastest-first from fastest types; None if infeasible."""
        X = np.zeros((n, k))
        cap = m.copy()
        j = k - 1
        for u in range(n - 1, -1, -1):  # fastest user first
            need = tau
            while need > 1e-15:
                while j >= 0 and cap[j] <= 1e-15:
                    j -= 1
                if j < 0:
                    return None
                w = Ws[u, j]
                take = min(cap[j], need / max(w, 1e-300))
                X[u, j] += take
                cap[j] -= take
                need -= take * w
        return X

    hi_cap = float(np.max(W) * m.sum()) + 1.0
    lo, hi = 0.0, hi_cap
    warm = tau_hint is not None and 0.0 < tau_hint < hi_cap
    if warm:
        if greedy(tau_hint) is not None:
            lo = float(tau_hint)
            probe = lo * 2.0
            while probe < hi_cap and greedy(probe) is not None:
                lo = probe
                probe *= 2.0
            hi = min(probe, hi_cap)
        else:
            hi = float(tau_hint)
            probe = hi * 0.5
            while probe > 1e-12 and greedy(probe) is None:
                hi = probe
                probe *= 0.5
            lo = probe if greedy(probe) is not None else 0.0
    for _ in range(iters):
        if hi - lo <= 1e-13 * max(hi, 1.0):
            break
        mid = 0.5 * (lo + hi)
        if greedy(mid) is not None:
            lo = mid
        else:
            hi = mid
    Xs = greedy(lo)
    if Xs is None:
        raise RuntimeError(
            f"water-filling bisection lost feasibility at tau={lo!r}; the "
            f"bracket invariant (lo always feasible) is broken — report the "
            f"(W, m) instance"
        )
    X = np.zeros_like(Xs)
    X[order] = Xs
    return Allocation(X=X, rows=default_rows(n), W=W, m=m,
                      meta={"policy": "oef-noncoop", "tau": lo, "fast_path": True,
                            "instance_class": klass, "warm_started": warm})


@audited_solver
def solve_noncoop_waterfill_torch(
    W: Array,
    m: Array,
    *,
    tau_hint: Optional[float] = None,
    device=None,
) -> Allocation:
    """Water-filling on the GPU: the ``"torch"`` backend of ``oef-noncoop``.

    Same staircase class and same answers (<=1e-9) as
    :func:`solve_noncoop_waterfill`, but the bisection runs as a fixed-trip
    multisection on ``device`` (default ``"cuda"``), on the card one launch
    of the hand-written fused water-filling kernel
    (:mod:`repro_torch.core.torch_solve`). Off-class instances raise
    :class:`~repro_torch.core.backends.BackendError` (registry falls back to
    the LP). ``meta["warm_started"]`` is True exactly when the solve probed
    ``tau_hint``, i.e. when it ran one feasibility launch more than a cold
    solve.
    """
    from . import torch_solve  # deferred: torch_solve imports this module

    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n, k = W.shape
    cls = classify_staircase(W)
    if cls is None:
        raise backends.BackendError(
            "instance is outside the (piecewise-)Monge staircase class; the "
            "greedy water-filling is not provably optimal — solve via the LP")
    klass, order, Ws = cls
    tau, X = torch_solve.solve_noncoop_fast_torch(
        W, m, tau_hint=tau_hint, device=device, _presorted=(order, Ws))
    return Allocation(X=X, rows=default_rows(n), W=W, m=m,
                      meta={"policy": "oef-noncoop", "tau": tau,
                            "fast_path": True, "instance_class": klass,
                            "warm_started": torch_solve.hint_usable(
                                tau_hint, W, m)})


_BACKEND_KWARG_WARNED = False


def _warn_backend_kwarg(fn: str) -> None:
    """One DeprecationWarning per process for the legacy ``backend=`` kwarg."""
    global _BACKEND_KWARG_WARNED
    if not _BACKEND_KWARG_WARNED:
        warnings.warn(
            f"{fn}(backend=...) is deprecated; use repro_torch.core.backends."
            f"dispatch(program, W, m, backend=...) or drop the kwarg to get "
            f"the program's default backend chain",
            DeprecationWarning, stacklevel=3)
        _BACKEND_KWARG_WARNED = True


@audited_solver
def solve_noncoop_fast(
    W: Array,
    m: Array,
    *,
    iters: int = 80,
    tau_hint: Optional[float] = None,
    backend: Optional[str] = None,
) -> Allocation:
    """Fast non-cooperative solve via the backend registry (historical shim).

    Dispatches program ``oef-noncoop`` through
    :func:`repro_torch.core.backends.dispatch`: by default the numpy water-filling
    with automatic LP fallback, ``backend="torch"`` for the GPU tier,
    ``backend="lp"`` to force the LP. Passing an explicit ``backend`` string
    here is deprecated (warned once per process) — new code should call
    ``backends.dispatch`` or rely on the default chain.

    ``meta`` keeps the historical contract: ``meta["backend"]`` names the
    tier that produced the answer and ``meta["fast_path"]`` is False exactly
    when the LP did.
    """
    if backend is not None:
        _warn_backend_kwarg("solve_noncoop_fast")
    alloc = backends.dispatch("oef-noncoop", W, m, backend=backend,
                              iters=iters, tau_hint=tau_hint)
    alloc.meta.setdefault("fast_path", alloc.meta.get("backend") != "lp")
    return alloc


# ---------------------------------------------------------------------------
# Incremental-solve hooks (online service: dirty-state re-solve, §"Online OEF")
# ---------------------------------------------------------------------------


def allocation_reusable(prev: Optional[Allocation], W: Array, m: Array,
                        *, policy: Optional[str] = None, tol: float = 1e-9) -> bool:
    """True when ``prev`` solved exactly this instance (same W, m, policy).

    The online scheduler calls this before every re-solve: arrival storms are
    batched into one dirty set, and when an event burst cancels out (e.g. a
    host fails and recovers between solves) the previous allocation is still
    optimal and is reused without touching the LP.
    """
    if prev is None:
        return False
    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    if policy is not None and prev.meta.get("policy") != policy:
        return False
    return (
        prev.W.shape == W.shape
        and prev.m.shape == m.shape
        and bool(np.all(np.abs(prev.W - W) <= tol))
        and bool(np.all(np.abs(prev.m - m) <= tol))
    )


def mark_reused(prev: Allocation) -> Allocation:
    """Clone ``prev`` with ``meta['reused']=True`` (meta is never shared)."""
    return Allocation(X=prev.X, rows=prev.rows, W=prev.W, m=prev.m,
                      meta={**prev.meta, "reused": True})


@audited_solver
def solve_incremental(
    W: Array,
    m: Array,
    *,
    policy: str = "oef-coop",
    prev: Optional[Allocation] = None,
    method: str = "highs",
    fast: bool = True,
    backend: Optional[str] = None,
    failsafe: bool = False,
    max_retries: int = 0,
    time_budget_s: Optional[float] = None,
    device=None,
) -> Allocation:
    """Warm-started re-solve of an OEF program for the online service.

    - unchanged instance  -> returns ``prev`` flagged ``reused`` (zero cost);
    - ``oef-noncoop`` with a previous tau -> warm-starts the water-filling
      bisection via ``tau_hint``;
    - ``oef-coop`` on the torch tier -> warm-starts the primal–dual state from
      the previous allocation's ``meta["pd_state"]``;
    - otherwise -> cold solve of the named policy.

    ``backend`` names a registry backend chain (None = the program's default:
    numpy water-filling for ``oef-noncoop``, the LP for ``oef-coop``). For
    ``oef-coop``, ``"numpy"`` is accepted as an alias of the LP default so a
    service configured with one backend can run every policy (see
    :func:`coop_backend`). ``device`` reaches the backends that take one
    (the ``"torch"`` tiers).

    ``failsafe`` and ``max_retries`` are forwarded to
    :func:`repro_torch.core.backends.dispatch` — the online scheduler sets both so
    a crashing tier escalates down the ladder instead of raising into the
    event loop, and transient declines get deterministic same-backend
    retries.
    """
    if allocation_reusable(prev, W, m, policy=_POLICY_META.get(policy, policy)):
        return mark_reused(prev)
    if policy in ("oef-noncoop", "noncooperative"):
        hint = prev.meta.get("tau") if prev is not None else None
        if fast:
            alloc = backends.dispatch(
                "oef-noncoop", W, m, backend=backend, iters=80,
                tau_hint=hint if isinstance(hint, float) else None,
                failsafe=failsafe, max_retries=max_retries,
                time_budget_s=time_budget_s, device=device)
            alloc.meta.setdefault("fast_path", alloc.meta.get("backend") != "lp")
            return alloc
        return solve_noncoop(W, m, method=method)
    if policy in ("oef-coop", "cooperative"):
        prev_state = prev.meta.get("pd_state") if prev is not None else None
        return backends.dispatch(
            "oef-coop", W, m, backend=coop_backend(backend), method=method,
            prev_state=prev_state, failsafe=failsafe, max_retries=max_retries,
            time_budget_s=time_budget_s, device=device)
    if policy == "efficiency-only":
        return backends.dispatch("efficiency-only", W, m, method=method,
                                 failsafe=failsafe, max_retries=max_retries,
                time_budget_s=time_budget_s)
    raise ValueError(f"unknown OEF policy: {policy}")


def coop_backend(backend: Optional[str]) -> Optional[str]:
    """The ``oef-coop`` backend chain that a service backend name selects:
    ``"numpy"`` aliases the LP default, any other name is taken as it is
    (``"torch"`` is the primal–dual tier)."""
    return None if backend == "numpy" else backend


# mode aliases -> the meta['policy'] tag written by the underlying solver
_POLICY_META = {
    "noncooperative": "oef-noncoop",
    "cooperative": "oef-coop",
}


def _consistently_ordered(Ws: Array, tol: float = 1e-9) -> bool:
    """Greedy-optimality condition (Monge / log-supermodular):

    rows sorted ascending elementwise, columns ascending left->right, AND for
    consecutive users the speedup *ratio* w_{l+1,j}/w_{l,j} is non-decreasing
    in j (comparative advantage aligns with absolute advantage). Without the
    ratio condition the fastest-user-takes-fastest-type staircase can be
    suboptimal (see tests), and we fall back to the LP.
    """
    if not (np.all(np.diff(Ws, axis=0) >= -tol) and np.all(np.diff(Ws, axis=1) >= -tol)):
        return False
    ratios = Ws[1:] / np.maximum(Ws[:-1], 1e-300)
    return bool(np.all(np.diff(ratios, axis=1) >= -tol))


def classify_staircase(
    W: Array, tol: float = 1e-9
) -> Optional[Tuple[str, Array, Array]]:
    """Staircase-class classifier for the water-filling tiers.

    Returns ``(instance_class, order, Ws)`` — the row order (slowest first)
    under which the fastest-user-takes-fastest-type greedy is provably exact
    — or ``None`` when the instance is outside the class (solve the LP).

    Two nested classes are recognized, checked in order so the historical
    behavior on the first is bit-identical:

    - ``"monge"`` — the consistently-ordered class: rows sorted by the
      fastest-type speedup are elementwise totally ordered, columns ascend,
      and consecutive-user speedup ratios are non-decreasing in the type
      index (:func:`_consistently_ordered`).
    - ``"piecewise-monge"`` — the block-ordered extension: elementwise row
      domination is dropped. Rows are sorted by *comparative advantage*
      (the fast/slow speedup ratio ``w[:, -1] / w[:, 0]``); the class needs
      each row non-decreasing across types and the consecutive-user ratio
      rows non-decreasing in the type index. Users tied in comparative
      advantage form interchangeable blocks — hence the name — and the
      exchange argument for greedy optimality goes through per block
      boundary exactly as in the Monge case (validated against the LP on
      randomized block-ordered suites; see docs/solvers.md for a worked
      example and tests/test_oef.py for the counterexample kept outside).
    """
    Wv = np.asarray(W, dtype=np.float64)
    order = np.argsort(Wv[:, -1], kind="stable")  # slowest ... fastest on top type
    Ws = Wv[order]
    if _consistently_ordered(Ws, tol=tol):
        return "monge", order, Ws
    order = np.argsort(Wv[:, -1] / np.maximum(Wv[:, 0], 1e-300), kind="stable")
    Ws = Wv[order]
    if np.all(np.diff(Ws, axis=1) >= -tol):
        ratios = Ws[1:] / np.maximum(Ws[:-1], 1e-300)
        if bool(np.all(np.diff(ratios, axis=1) >= -tol)):
            return "piecewise-monge", order, Ws
    return None


# ---------------------------------------------------------------------------
# Weighted OEF & multi-job-type tenants (row replication, §4.2.3/4.2.4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TenantAllocation:
    """Tenant-level allocation: folded rows plus per-job-type breakdown."""

    tenants: Tuple[str, ...]
    X: Array  # (n_tenants, k) folded shares
    per_job_type: Dict[str, Dict[str, Array]]  # tenant -> job type -> share vec
    row_alloc: Allocation  # virtual-user level result
    replication: Dict[str, int]  # virtual row name -> count

    def tenant_throughput(self, tenant: str, W_by_jobtype: Dict[str, Array]) -> float:
        total = 0.0
        for jt, x in self.per_job_type[tenant].items():
            total += float(np.dot(W_by_jobtype[jt], x))
        return total


def expand_virtual_users(
    tenants: Sequence[Tenant], k: int, *, max_rows: int = 4096
) -> Tuple[Array, List[Tuple[int, str, str]], Dict[str, int]]:
    """Replicate job-type rows per weight (§4.2.3).

    A tenant with weight ``pi`` and ``t`` job types contributes, for each job
    type, ``pi * L / t`` identical rows, where ``L`` clears all denominators
    across tenants. Returns (W_virtual, row_map, replication) where row_map[i]
    = (tenant_index, tenant_name, job_type_name) for each *distinct* row and
    replication counts identical rows instead of materializing them — the LP
    is solved on distinct rows with replication folded into the equality /
    envy structure by exact equivalence (identical rows receive identical
    throughput in both OEF programs, so c replicas of a row are equivalent to
    one row whose throughput target is c times smaller... we keep it simple
    and *materialize* replicas; max_rows guards pathological weights).
    """
    fracs = []
    for t in tenants:
        fracs.append(Fraction(t.weight).limit_denominator(1024) / len(t.job_types))
    denom_lcm = 1
    for f in fracs:
        denom_lcm = denom_lcm * f.denominator // math.gcd(denom_lcm, f.denominator)
    counts = [int(f * denom_lcm) for f in fracs]
    # Reduce by common gcd to keep replication minimal.
    g = 0
    for c in counts:
        g = math.gcd(g, c)
    if g > 1:
        counts = [c // g for c in counts]
    rows: List[Array] = []
    row_map: List[Tuple[int, str, str]] = []
    replication: Dict[str, int] = {}
    for (ti, tenant), cnt in zip(enumerate(tenants), counts):
        if cnt <= 0:
            raise ValueError(f"tenant {tenant.name}: weight too small to replicate")
        for jt in tenant.job_types:
            vec = jt.speedup_vec()
            if vec.shape[0] != k:
                raise ValueError(f"speedup vector of {tenant.name}/{jt.name} has wrong length")
            for r in range(cnt):
                rows.append(vec)
                row_map.append((ti, tenant.name, jt.name))
                replication[f"{tenant.name}/{jt.name}#{r}"] = cnt
    if len(rows) > max_rows:
        raise ValueError(f"virtual-user expansion too large ({len(rows)} rows)")
    return np.vstack(rows), row_map, replication


def evaluate_tenants(
    tenants: Sequence[Tenant],
    cluster: ClusterSpec,
    *,
    mode: str = "noncooperative",
    method: str = "highs",
    fast: bool = False,
    prev: Optional[Allocation] = None,
    backend: Optional[str] = None,
    failsafe: bool = False,
    max_retries: int = 0,
    time_budget_s: Optional[float] = None,
    device=None,
) -> TenantAllocation:
    """Tenant-level fair-share evaluation with weights and multi-job types.

    ``prev`` (the previous round's *row-level* allocation, i.e.
    ``TenantAllocation.row_alloc``) enables the incremental-solve path: when
    the expanded virtual-user instance is unchanged the old allocation is
    reused outright, otherwise it seeds the warm start. ``backend`` names a
    registry backend chain (see :mod:`repro_torch.core.backends`); None picks each
    program's default. ``failsafe`` / ``max_retries`` forward to
    :func:`repro_torch.core.backends.dispatch` (solver guardrails for the online
    service); ``device`` reaches the backends that take one.
    """
    W_virt, row_map, replication = expand_virtual_users(tenants, cluster.k)
    m = cluster.m_vec
    if prev is not None:
        alloc = solve_incremental(W_virt, m, policy=mode, prev=prev, method=method,
                                  fast=fast, backend=backend,
                                  failsafe=failsafe, max_retries=max_retries,
                                  time_budget_s=time_budget_s, device=device)
    elif mode == "noncooperative":
        if fast:
            alloc = backends.dispatch("oef-noncoop", W_virt, m, backend=backend,
                                      failsafe=failsafe, max_retries=max_retries,
                                      time_budget_s=time_budget_s, device=device)
            alloc.meta.setdefault("fast_path", alloc.meta.get("backend") != "lp")
        else:
            alloc = solve_noncoop(W_virt, m, method=method)
    elif mode == "cooperative":
        alloc = backends.dispatch(
            "oef-coop", W_virt, m, backend=coop_backend(backend), method=method,
            failsafe=failsafe, max_retries=max_retries,
            time_budget_s=time_budget_s, device=device)
    else:
        raise ValueError(f"unknown mode: {mode}")
    n_t = len(tenants)
    X_fold = np.zeros((n_t, cluster.k))
    per_jt: Dict[str, Dict[str, Array]] = {t.name: {} for t in tenants}
    for row_idx, (ti, tname, jtname) in enumerate(row_map):
        X_fold[ti] += alloc.X[row_idx]
        per_jt[tname][jtname] = per_jt[tname].get(jtname, np.zeros(cluster.k)) + alloc.X[row_idx]
    return TenantAllocation(
        tenants=tuple(t.name for t in tenants),
        X=X_fold,
        per_job_type=per_jt,
        row_alloc=alloc,
        replication=replication,
    )


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _capacity_constraints(n: int, k: int, m: Array) -> Tuple[Array, Array]:
    A = np.zeros((k, n * k))
    for j in range(k):
        A[j, j::k] = 1.0
    return A, np.asarray(m, dtype=np.float64)


def _solve(c, A_ub, b_ub, A_eq, b_eq, method: str) -> LPResult:
    res = solve_lp(c, A_ub, b_ub, A_eq, b_eq, method=method)
    if not res.ok:
        raise LPError(f"LP failed: status={res.status} ({res.message})")
    return res


# ---------------------------------------------------------------------------
# Backend registry wiring (see repro_torch.core.backends).
# ---------------------------------------------------------------------------

backends.register_backend("efficiency-only", "lp", solve_efficiency_only,
                          default=True)
backends.register_backend("oef-noncoop", "lp", solve_noncoop)
backends.register_backend("oef-noncoop", "numpy", solve_noncoop_waterfill,
                          instance_class="piecewise-monge", fallback="lp",
                          default=True)
backends.register_backend("oef-noncoop", "torch", solve_noncoop_waterfill_torch,
                          instance_class="piecewise-monge", fallback="lp")
backends.register_backend("oef-coop", "lp", solve_coop, default=True)
