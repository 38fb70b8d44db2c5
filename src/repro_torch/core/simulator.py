"""Round-based cluster simulator (the paper's testbed, in silico).

Reproduces the evaluation environment of §6: a heterogeneous cluster scheduled
in rounds (default 300 s, §6.1.1), tenants owning batches of DL jobs, with:

  - pluggable fair-share policy (OEF non-coop/coop, Gavel, Gandiva_fair,
    max-min);
  - the deviation-accumulating rounding placer and host packing (§4.3);
  - straggler effect for cross-type data-parallel jobs — synchronous SGD runs
    at the *slowest* participating device's speed (§4.4);
  - network-contention penalty for jobs spanning hosts;
  - checkpoint/restart overhead when a job migrates between hosts/types
    (the paper moves checkpoints with rsync);
  - host-failure injection: failed hosts drop out of the capacity vector the
    scheduler sees next round (fault tolerance at the control plane);
  - Philly-trace-like contention: tenant arrival waves keep the cluster
    oversubscribed (§6.1.2).

Progress accounting uses "slowest-device-seconds" as the work unit: one device
of the slowest type completes 1 unit/s, a type-j device ``w^j`` units/s.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import baselines, oef
from .placement import JobRequest, PlacementResult, RoundingPlacer
from .types import Allocation, ClusterSpec, JobTypeProfile, Tenant

Array = np.ndarray


@dataclasses.dataclass
class SimJob:
    job_id: str
    tenant: str
    job_type: str
    workers: int
    total_work: float  # slowest-device-seconds of work
    done: float = 0.0
    submit_round: int = 0
    finish_time: Optional[float] = None
    starvation: float = 0.0
    last_assignment: Optional[Tuple[Tuple[int, int, int], ...]] = None

    @property
    def finished(self) -> bool:
        return self.done >= self.total_work - 1e-9


@dataclasses.dataclass
class SimTenant:
    name: str
    job_types: Dict[str, JobTypeProfile]
    jobs: List[SimJob]
    weight: float = 1.0
    submit_round: int = 0

    def active(self, rnd: int) -> bool:
        return rnd >= self.submit_round and any(not j.finished for j in self.jobs)


@dataclasses.dataclass
class RoundRecord:
    rnd: int
    tenants: Tuple[str, ...]
    ideal: Array  # fractional shares (n_active, k)
    real: Array  # integer grants
    tenant_efficiency: Dict[str, float]  # W.x estimated (algorithmic)
    tenant_actual: Dict[str, float]  # realized work-rate incl. placement effects
    cross_type_workers: int
    cross_host_jobs: int
    failed_hosts: Tuple[Tuple[int, int], ...]
    solver_seconds: float


@dataclasses.dataclass
class SimResult:
    records: List[RoundRecord]
    jcts: Dict[str, float]
    makespan_rounds: int
    total_work_done: float

    def mean_jct(self) -> float:
        return float(np.mean(list(self.jcts.values()))) if self.jcts else 0.0

    def total_cross_type(self) -> int:
        return int(sum(r.cross_type_workers for r in self.records))

    def total_cross_host(self) -> int:
        return int(sum(r.cross_host_jobs for r in self.records))


PolicyFn = Callable[[Array, Array], Allocation]

POLICIES: Dict[str, PolicyFn] = {
    "max-min": lambda W, m: baselines.solve_maxmin(W, m),
    "gavel": lambda W, m: baselines.solve_gavel(W, m),
    "gandiva-fair": lambda W, m: baselines.solve_gandiva_fair(W, m),
    "oef-noncoop": lambda W, m: oef.solve_noncoop(W, m),
    "oef-coop": lambda W, m: oef.solve_coop(W, m),
    "efficiency-only": lambda W, m: oef.solve_efficiency_only(W, m),
}


class ClusterSimulator:
    def __init__(
        self,
        cluster: ClusterSpec,
        tenants: Sequence[SimTenant],
        policy: str = "oef-coop",
        *,
        round_len_s: float = 300.0,
        devices_per_host: int = 4,
        contention_penalty: float = 0.92,
        migration_overhead_s: float = 30.0,
        host_failure_prob: float = 0.0,
        seed: int = 0,
        use_weighted_oef: bool = True,
        placer_mode: str = "auto",  # auto: OEF -> optimized, baselines -> naive
    ) -> None:
        self.cluster = cluster
        self.tenants = list(tenants)
        self.policy_name = policy
        self.round_len_s = round_len_s
        self.contention_penalty = contention_penalty
        self.migration_overhead_s = migration_overhead_s
        self.host_failure_prob = host_failure_prob
        self.rng = np.random.default_rng(seed)
        self.devices_per_host = devices_per_host
        self.use_weighted_oef = use_weighted_oef and policy.startswith("oef")
        if placer_mode == "auto":
            # The optimized placer (§4.3) is an OEF contribution; the paper's
            # baselines run their native placement without contention
            # alleviation or cross-type avoidance (§6.3.1).
            self.naive_placement = not policy.startswith("oef")
        else:
            self.naive_placement = placer_mode == "naive"
        self._placers: Dict[Tuple[str, ...], RoundingPlacer] = {}

    # -- speedup matrix of the active tenants -------------------------------
    def _tenant_rows(self, active: List[SimTenant]) -> Array:
        rows = []
        for t in active:
            vecs = np.stack([jt.speedup_vec() for jt in t.job_types.values()])
            rows.append(vecs.mean(axis=0))  # baselines: single vector per tenant
        return np.stack(rows)

    def _evaluate(self, active: List[SimTenant], m: Array):
        from ..obs import clock as _obs_clock

        t0 = _obs_clock.wall()  # telemetry only — never feeds decisions
        if self.use_weighted_oef and any(len(t.job_types) > 1 or t.weight != 1.0 for t in active):
            ten = [
                Tenant(name=t.name, job_types=tuple(t.job_types.values()), weight=t.weight)
                for t in active
            ]
            mode = "cooperative" if self.policy_name == "oef-coop" else "noncooperative"
            ta = oef.evaluate_tenants(ten, ClusterSpec(self.cluster.types, tuple(int(x) for x in m)), mode=mode)
            W = self._tenant_rows(active)
            ideal, est = ta.X, np.einsum("lk,lk->l", W, ta.X)
        else:
            W = self._tenant_rows(active)
            alloc = POLICIES[self.policy_name](W, m)
            ideal, est = alloc.X, alloc.throughput
        return ideal, est, W, _obs_clock.wall() - t0

    # -- one scheduling round ------------------------------------------------
    def run(self, max_rounds: int = 10_000) -> SimResult:
        records: List[RoundRecord] = []
        jcts: Dict[str, float] = {}
        total_work = 0.0
        rnd = 0
        while rnd < max_rounds:
            active = [t for t in self.tenants if t.active(rnd)]
            pending = [t for t in self.tenants if t.submit_round > rnd]
            if not active:
                if pending:
                    rnd += 1
                    continue
                break

            # --- failure injection: hosts down this round ---
            failed: List[Tuple[int, int]] = []
            m_eff = self.cluster.m_vec.copy()
            if self.host_failure_prob > 0:
                for j in range(self.cluster.k):
                    n_hosts = int(np.ceil(self.cluster.m[j] / self.devices_per_host))
                    for h in range(n_hosts):
                        if self.rng.random() < self.host_failure_prob:
                            failed.append((j, h))
                            m_eff[j] = max(0.0, m_eff[j] - self.devices_per_host)

            ideal, est, W, solver_s = self._evaluate(active, m_eff)

            key = tuple(t.name for t in active)
            placer = self._placers.get(key)
            if placer is None or placer.n != len(active):
                placer = RoundingPlacer(len(active), self.cluster.m, self.devices_per_host)
                self._placers = {key: placer}
            min_dem = np.array(
                [min(jt.min_demand for jt in t.job_types.values()) for t in active]
            )
            real = placer.round_shares(ideal, min_dem)

            # --- per-tenant job selection: longest starvation first (§6.1.3)
            reqs: List[JobRequest] = []
            for ui, t in enumerate(active):
                budget = int(real[ui].sum())
                for job in sorted(
                    (j for j in t.jobs if not j.finished and j.submit_round <= rnd),
                    key=lambda j: (-j.starvation, j.job_id),
                ):
                    if budget < job.workers:
                        job.starvation += 1
                        continue
                    budget -= job.workers
                    reqs.append(JobRequest(user=ui, job_id=job.job_id, workers=job.workers,
                                           starvation=job.starvation))
            prev_assign = getattr(self, "_prev_assignments", None)
            placement = placer.place(real, reqs, naive=self.naive_placement,
                                     prev=prev_assign)
            self._prev_assignments = placement.assignments

            # --- progress accounting ---
            job_by_id = {j.job_id: (t, j) for t in active for j in t.jobs}
            actual: Dict[str, float] = {t.name: 0.0 for t in active}
            failed_set = set(failed)
            for job_id, assignment in placement.assignments.items():
                t, job = job_by_id[job_id]
                prof = t.job_types[job.job_type]
                w = prof.speedup_vec()
                live = [(j, h, c) for (j, h, c) in assignment if (j, h) not in failed_set]
                if not live:
                    job.starvation += 1
                    continue
                types_used = sorted({j for j, _, _ in live})
                hosts_used = {(j, h) for j, h, _ in live}
                n_workers = sum(c for _, _, c in live)
                # straggler: sync training paced by the slowest device type
                rate = n_workers * float(w[types_used[0]])
                if len(hosts_used) > 1:
                    rate *= self.contention_penalty
                t_avail = self.round_len_s
                assign_key = tuple(sorted(assignment))
                if job.last_assignment is not None and job.last_assignment != assign_key:
                    t_avail = max(0.0, t_avail - self.migration_overhead_s)
                job.last_assignment = assign_key
                gained = rate * t_avail
                before = job.done
                job.done = min(job.total_work, job.done + gained)
                work = job.done - before
                total_work += work
                actual[t.name] += work / self.round_len_s
                job.starvation = 0.0
                if job.finished and job.finish_time is None:
                    frac = work / max(gained, 1e-12)
                    job.finish_time = (rnd + min(frac, 1.0)) * self.round_len_s
                    jcts[job.job_id] = job.finish_time - job.submit_round * self.round_len_s
            for t in active:
                for job in t.jobs:
                    if not job.finished and job.job_id not in placement.assignments:
                        job.starvation += 1

            records.append(
                RoundRecord(
                    rnd=rnd,
                    tenants=key,
                    ideal=ideal,
                    real=real,
                    tenant_efficiency={t.name: float(e) for t, e in zip(active, est)},
                    tenant_actual=actual,
                    cross_type_workers=placement.cross_type_workers,
                    cross_host_jobs=placement.cross_host_jobs,
                    failed_hosts=tuple(failed),
                    solver_seconds=solver_s,
                )
            )
            rnd += 1
        return SimResult(records=records, jcts=jcts, makespan_rounds=rnd, total_work_done=total_work)


def make_synthetic_tenants(
    n_tenants: int,
    job_types: Sequence[JobTypeProfile],
    *,
    jobs_per_tenant: int = 20,
    mean_work_s: float = 3600.0,
    workers_choices: Sequence[int] = (1, 1, 2, 4),
    seed: int = 0,
    arrival_spread_rounds: int = 0,
) -> List[SimTenant]:
    """Philly-like synthetic tenant population (§6.1.2): each tenant runs a
    batch of same-type jobs with randomized sizes/demands."""
    rng = np.random.default_rng(seed)
    tenants = []
    for i in range(n_tenants):
        jt = job_types[int(rng.integers(len(job_types)))]
        n_jobs = max(1, int(rng.poisson(jobs_per_tenant)))
        submit = int(rng.integers(arrival_spread_rounds + 1))
        jobs = [
            SimJob(
                job_id=f"t{i}-j{q}",
                tenant=f"tenant{i}",
                job_type=jt.name,
                workers=int(rng.choice(workers_choices)),
                total_work=float(rng.exponential(mean_work_s)) + 300.0,
                submit_round=submit,
            )
            for q in range(n_jobs)
        ]
        tenants.append(
            SimTenant(name=f"tenant{i}", job_types={jt.name: jt}, jobs=jobs, submit_round=submit)
        )
    return tenants
