"""Job-level elastic OEF — the extension sketched in the paper's §8.

With elastic DL training, a job can run on any worker count w with concave
scaling eff(w) (synchronization overheads give diminishing returns). We model
eff(w) = w**alpha (alpha in (0, 1]) up to ``max_workers`` and allocate at job
granularity: each job contributes per-worker *segments* with decreasing
marginal throughput

    marg(w) = speedup_t * (eff(w) - eff(w-1)),

which keeps the OEF program a pure LP (the LP fills segments greedily, so an
optimal solution never uses segment w+1 before w). Envy-freeness is enforced
between *tenants* on total utility, exactly like cooperative OEF; tenant
weights split over their jobs as in §4.2.4.

``solve_elastic_coop`` reduces to standard cooperative OEF when alpha=1 and
max_workers is not binding (property-tested).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .lp import LPError, solve_lp
from .types import Allocation

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class ElasticJob:
    name: str
    speedup: Tuple[float, ...]  # per device type
    max_workers: int = 8
    alpha: float = 0.9  # eff(w) = w**alpha

    def eff(self, w: int) -> float:
        return float(w) ** self.alpha

    def marginals(self) -> List[float]:
        return [self.eff(w) - self.eff(w - 1) for w in range(1, self.max_workers + 1)]


@dataclasses.dataclass(frozen=True)
class ElasticTenant:
    name: str
    jobs: Tuple[ElasticJob, ...]


@dataclasses.dataclass
class ElasticAllocation:
    tenants: Tuple[str, ...]
    X: Dict[str, Dict[str, Array]]  # tenant -> job -> (k,) device shares
    utility: Dict[str, float]
    total_utility: float


def solve_elastic_coop(tenants: Sequence[ElasticTenant], m: Array,
                       *, method: str = "highs",
                       envy_free: bool = True) -> ElasticAllocation:
    """Cooperative (EF-constrained) elastic OEF.

    Variables: x[t][j][seg][type] in [0, 1] device of ``type`` for the seg-th
    worker of job j. Utility of tenant t = sum over jobs/segs/types of
    marg(seg) * speedup[type] * x. EF: U_t(own) >= U_t(swap with tenant s)
    where the swap evaluates s's *device bundle per type* under t's best job
    assignment — we use the standard bundle-based EF (t's utility if handed
    s's per-type totals, filling its own jobs greedily); since greedy filling
    is itself the LP optimum for concave segments, the constraint lower-bounds
    with the aggregate-rate relaxation: U_t(x_s_totals) computed with t's
    best marginal rate per type (conservative, keeps the program linear).
    """
    m = np.asarray(m, dtype=np.float64)
    k = m.shape[0]
    # flatten variables
    idx: List[Tuple[int, int, int, int]] = []  # (tenant, job, seg, type)
    rates: List[float] = []
    for ti, t in enumerate(tenants):
        for ji, job in enumerate(t.jobs):
            margs = job.marginals()
            for si, mg in enumerate(margs):
                for ty in range(k):
                    idx.append((ti, ji, si, ty))
                    rates.append(mg * job.speedup[ty])
    n_var = len(idx)
    c = np.asarray(rates)

    rows, rhs = [], []
    # capacity per type
    for ty in range(k):
        row = np.zeros(n_var)
        for v, (ti, ji, si, vty) in enumerate(idx):
            if vty == ty:
                row[v] = 1.0
        rows.append(row)
        rhs.append(m[ty])
    # each segment holds at most one worker (across types)
    seg_ids: Dict[Tuple[int, int, int], List[int]] = {}
    for v, (ti, ji, si, ty) in enumerate(idx):
        seg_ids.setdefault((ti, ji, si), []).append(v)
    for vs in seg_ids.values():
        row = np.zeros(n_var)
        row[vs] = 1.0
        rows.append(row)
        rhs.append(1.0)
    # envy-freeness between tenants (aggregate-rate bundle comparison):
    # U_t >= sum_type best_rate_t[type] * total_s[type]
    best_rate = np.zeros((len(tenants), k))
    for ti, t in enumerate(tenants):
        for ty in range(k):
            best_rate[ti, ty] = max(
                job.marginals()[0] * job.speedup[ty] for job in t.jobs)
    util_row = [np.zeros(n_var) for _ in tenants]
    totals_rows = [[np.zeros(n_var) for _ in range(k)] for _ in tenants]
    for v, (ti, ji, si, ty) in enumerate(idx):
        util_row[ti][v] = c[v]
        totals_rows[ti][ty][v] = 1.0
    if envy_free:
        # NOTE: this bound is *conservative* (values the rival bundle at the
        # envious tenant's FIRST-segment marginal rate), so it implies true
        # (diminishing-returns) envy-freeness but can cost some efficiency
        # relative to an exact concave-EF formulation.
        for ti in range(len(tenants)):
            for si_ in range(len(tenants)):
                if si_ == ti:
                    continue
                row = -util_row[ti].copy()
                for ty in range(k):
                    row += best_rate[ti, ty] * totals_rows[si_][ty]
                rows.append(row)
                rhs.append(0.0)

    res = solve_lp(c, np.vstack(rows), np.asarray(rhs), method=method)
    if not res.ok:
        raise LPError(f"elastic OEF LP failed: {res.message}")
    X: Dict[str, Dict[str, Array]] = {}
    utility = {t.name: 0.0 for t in tenants}
    for v, (ti, ji, si, ty) in enumerate(idx):
        t = tenants[ti]
        job = t.jobs[ji]
        X.setdefault(t.name, {}).setdefault(job.name, np.zeros(k))[ty] += res.x[v]
        utility[t.name] += c[v] * res.x[v]
    return ElasticAllocation(
        tenants=tuple(t.name for t in tenants),
        X=X,
        utility=utility,
        total_utility=float(sum(utility.values())),
    )


def segment_utility(job: ElasticJob, x: Array) -> float:
    """Utility of device shares ``x`` (per type) under the segment model:
    the w-th worker contributes marg(w) x (speedup of the w-th best device
    it occupies) — i.e. fast devices fill the early (high-marginal) segments."""
    x = np.asarray(x, dtype=np.float64)
    margs = job.marginals()
    order = np.argsort(-np.asarray(job.speedup))
    total, seg, left_in_seg = 0.0, 0, 1.0
    for ty in order:
        amount = float(x[ty])
        while amount > 1e-12 and seg < len(margs):
            take = min(amount, left_in_seg)
            total += margs[seg] * job.speedup[ty] * take
            amount -= take
            left_in_seg -= take
            if left_in_seg <= 1e-12:
                seg += 1
                left_in_seg = 1.0
    return total


def rigid_equivalent(tenants: Sequence[ElasticTenant], m: Array) -> float:
    """Total segment-model utility of the *scaling-unaware* allocation:
    standard cooperative OEF (which assumes linear scaling) evaluated under
    the true concave utilities — the rigid baseline an elasticity-aware
    scheduler improves upon."""
    from . import oef
    from .types import ClusterSpec, JobTypeProfile, Tenant

    ten = []
    for t in tenants:
        jts = tuple(JobTypeProfile(j.name, j.speedup) for j in t.jobs)
        ten.append(Tenant(t.name, jts))
    cluster = ClusterSpec(types=tuple(f"t{i}" for i in range(len(m))),
                          m=tuple(int(x) for x in m))
    ta = oef.evaluate_tenants(ten, cluster, mode="cooperative")
    total = 0.0
    for t in tenants:
        for j in t.jobs:
            x = np.minimum(ta.per_job_type[t.name][j.name], j.max_workers)
            total += segment_utility(j, x)
    return total
