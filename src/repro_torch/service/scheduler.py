"""Event-driven continuous-time OEF scheduler (the online control plane).

``OnlineScheduler`` maintains live cluster state — tenants, jobs, host
health — and reacts to events from an :class:`~repro_torch.service.events.EventQueue`:

  - world changes (submit/finish/join/leave/fail/recover/profile update) mark
    the state *dirty*;
  - a re-solve throttle bounds decision latency under arrival storms: dirty
    events within ``min_resolve_interval_s`` of the last solve are batched
    and a single deferred RESOLVE timer fires for the whole burst;
  - re-solves go through the incremental hooks
    (``core.oef.solve_incremental`` / ``core.baselines.solve_incremental``):
    an unchanged instance reuses the previous :class:`Allocation` outright,
    and non-cooperative OEF warm-starts its water-filling bisection from the
    previous tau;
  - fractional shares are rounded and packed by the same
    :class:`~repro_torch.core.placement.RoundingPlacer` the round simulator uses
    (deviation accumulation preserved across solves), with failed hosts
    masked out of packing;
  - progress accounting matches the simulator's model — straggler pacing by
    the slowest participating type (§4.4), cross-host contention penalty,
    checkpoint/migration overhead — but in continuous time: each job carries
    a rate, job completions are *predicted* as version-tagged JOB_FINISH
    events and lazily invalidated when a re-solve changes the rate.

:func:`crossval_static` is the cross-validation harness: on a static
workload the service's steady-state per-tenant throughput estimates must
agree with ``core.simulator.ClusterSimulator``'s (tested to within 1%).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core import backends, baselines, oef, properties
from ..core.torch_solve import resolve_device
from ..kernels import KernelError, waterfill
from ..obs import clock as _obs_clock
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..core.placement import JobRequest, RoundingPlacer
from ..core.simulator import SimTenant
from ..core.types import Allocation, ClusterSpec, JobTypeProfile, Tenant
from .events import Event, EventKind, EventQueue
from .metrics import MetricsCollector, ServiceReport, SolveRecord

Array = np.ndarray

OEF_POLICIES = ("oef-noncoop", "oef-coop", "efficiency-only")
BASELINE_POLICIES = ("max-min", "gavel", "gandiva-fair")
SERVICE_POLICIES = OEF_POLICIES + BASELINE_POLICIES

#: span labels for the event loop, precomputed so the per-event trace site
#: does no string work.
_EVENT_LABELS = {kind: "event/" + kind.value for kind in EventKind}


@dataclasses.dataclass
class ServiceJob:
    job_id: str
    tenant: str
    job_type: str
    workers: int
    total_work: float  # slowest-device-seconds
    submit_time: float
    done: float = 0.0
    rate: float = 0.0  # slowest-device-units per second under current placement
    resume_at: float = 0.0  # progress credited only after this (migration stall)
    version: int = 0  # bumped on re-solve; invalidates stale JOB_FINISH events
    assignment: Optional[Tuple[Tuple[int, int, int], ...]] = None
    starvation: float = 0.0  # consecutive solves without a grant
    first_scheduled: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def finished(self) -> bool:
        return self.finish_time is not None


@dataclasses.dataclass
class ServiceTenant:
    name: str
    job_types: Dict[str, JobTypeProfile]
    weight: float = 1.0
    joined_at: float = 0.0
    left_at: Optional[float] = None
    # cached mean of the job-type speedup vectors: rebuilding the solver's W
    # row per re-solve is O(|job_types|) numpy calls per tenant, which at
    # 1024 tenants costs more than the solve itself. Invalidated on
    # PROFILE_UPDATE (the only post-join job_types mutation).
    _mean_speedup: Optional[Array] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def present(self) -> bool:
        return self.left_at is None

    def mean_speedup(self) -> Array:
        if self._mean_speedup is None:
            self._mean_speedup = np.stack(
                [jt.speedup_vec() for jt in self.job_types.values()]).mean(axis=0)
        return self._mean_speedup

    def invalidate_profile_cache(self) -> None:
        self._mean_speedup = None


def _tenant_weighted(t: ServiceTenant) -> bool:
    """Does this tenant force the weighted-OEF (virtual-user) path?"""
    return len(t.job_types) > 1 or t.weight != 1.0


class OnlineScheduler:
    def __init__(
        self,
        cluster: ClusterSpec,
        policy: str = "oef-coop",
        *,
        devices_per_host: int = 4,
        min_resolve_interval_s: float = 30.0,
        contention_penalty: float = 0.92,
        migration_overhead_s: float = 30.0,
        audit_every: int = 0,
        use_weighted_oef: bool = True,
        fast_noncoop: bool = True,
        solver_backend: Optional[str] = None,
        placer_mode: str = "auto",
        guardrails: bool = True,
        solver_max_retries: int = 1,
        solver_time_budget_s: Optional[float] = None,
        device=None,
    ) -> None:
        """``guardrails`` enables the robustness layer (on by default): solver
        dispatch runs failsafe (crashing tier -> next backend -> LP), transient
        declines get ``solver_max_retries`` deterministic same-backend
        retries, a solve that still fails floors on the last-known-good
        allocation (or equal share) instead of raising into the event loop,
        and tenants with invalid profiles (wrong length / non-finite /
        non-positive speedups) are quarantined out of the batched solve until
        a valid PROFILE_UPDATE arrives. ``solver_time_budget_s`` adds an
        opt-in per-solve wall-clock budget (non-deterministic — leave None in
        bit-exact replays; see docs/robustness.md).

        ``device`` is where the ``"torch"`` backend solves (default
        ``"cuda"``). It is checked here: a CUDA device that torch cannot see
        raises now, and when the ``"torch"`` backend will solve on the card
        its kernel is built and loaded now, so a missing ``nvcc`` or a failed
        build raises ``KernelError`` at construction. A kernel failure
        during a run raises too: the guardrails never hand the card's work
        to the LP. ``oef-coop`` with the ``"torch"`` backend raises: the
        cooperative tier has no torch counterpart yet.
        """
        if policy not in SERVICE_POLICIES:
            raise ValueError(f"unknown policy {policy!r}; choose from {SERVICE_POLICIES}")
        if solver_backend is not None and solver_backend not in backends.backend_names():
            raise ValueError(
                f"unknown solver backend {solver_backend!r}; registered: "
                f"{backends.backend_names()}")
        if policy == "oef-coop":
            oef.coop_backend(solver_backend)
        self.device = resolve_device(device)
        if (self.device.type == "cuda" and policy == "oef-noncoop"
                and backends.resolve_backend(policy, solver_backend).backend == "torch"):
            waterfill.load()
        self.cluster = cluster
        self.policy = policy
        self.devices_per_host = devices_per_host
        self.min_resolve_interval_s = min_resolve_interval_s
        self.contention_penalty = contention_penalty
        self.migration_overhead_s = migration_overhead_s
        self.audit_every = audit_every
        self.use_weighted_oef = use_weighted_oef and policy.startswith("oef")
        self.fast_noncoop = fast_noncoop
        self.solver_backend = solver_backend
        self.guardrails = guardrails
        self.solver_max_retries = solver_max_retries
        self.solver_time_budget_s = solver_time_budget_s
        if placer_mode == "auto":
            self.naive_placement = not policy.startswith("oef")
        else:
            self.naive_placement = placer_mode == "naive"

        self.tenants: Dict[str, ServiceTenant] = {}
        self.jobs: Dict[str, ServiceJob] = {}
        self.down_hosts: Set[Tuple[int, int]] = set()
        self.quarantined: Set[str] = set()
        self.metrics = MetricsCollector()
        self.last_estimate: Dict[str, float] = {}
        # last successful fair-share solve: (tenant names, ideal X, est) — the
        # floor of the degradation ladder when every solver tier fails.
        self._last_good: Optional[Tuple[Tuple[str, ...], Array, Array]] = None

        self._placer: Optional[RoundingPlacer] = None
        self._placer_key: Tuple[str, ...] = ()
        # solver-input cache: the stacked W matrix and the weighted-OEF flag
        # are pure functions of (active membership, tenant profiles); rebuild
        # only when a join/leave changes the roster or a PROFILE_UPDATE bumps
        # the epoch — at 1024 tenants the rebuild costs ~1 ms per re-solve.
        self._profile_epoch = 0
        self._solver_cache_key: Optional[Tuple[int, Tuple[str, ...]]] = None
        self._solver_cache: Optional[Tuple[Array, bool]] = None
        # count of present tenants needing the weighted-OEF path (multiple
        # job types or weight != 1): when zero — the common case at large
        # tenant counts — the per-solve any() scan is skipped entirely.
        self._weighted_present = 0
        self._prev_alloc: Optional[Allocation] = None
        self._prev_assignments: Optional[Dict[str, List[Tuple[int, int, int]]]] = None
        self._running_jobs: List[ServiceJob] = []  # rate > 0 as of last solve
        self._dirty = False
        self._dirty_count = 0
        self._resolve_pending = False
        # next time a solve is allowed; the RESOLVE timer is scheduled at
        # exactly this float so the pop-time comparison is ==, never a
        # subtraction (last + dt - last < dt can round down and live-lock)
        self._next_solve_ok = -math.inf
        self._last_advance = 0.0
        self._clock = 0.0
        self._n_solves = 0

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def run(self, events: Sequence[Event], *,
            until: Optional[float] = None) -> ServiceReport:
        """Replay ``events`` (stopping the clock at ``until`` if given) and
        return the run's report."""
        queue = EventQueue(events)
        tracer = obs_trace.get_tracer()
        if tracer is not None:
            tracer.set_sim_clock(lambda: self._clock)
            _begin, _end = tracer.begin, tracer.end
        try:
            while True:
                if not queue:
                    if self._dirty:
                        # e.g. the last popped event was a stale finish: solve
                        # so runnable jobs get rates (may push finish events).
                        self._resolve(self._clock, queue)
                        continue
                    break
                ev = queue.pop()
                if until is not None and ev.time > until:
                    self._advance(until)
                    self._clock = until
                    break
                self._advance(ev.time)
                self._clock = max(self._clock, ev.time)
                if tracer is None:
                    self._handle(ev, queue)
                elif (ev.kind is EventKind.JOB_FINISH
                      and self._finish_is_stale(ev)):
                    # Stale predicted finishes dominate pops (every re-solve
                    # invalidates the predictions queued by the previous one)
                    # and their handling is a cheap early return; tally them
                    # instead of recording thousands of near-zero spans.
                    # Staleness is deterministic, so the span set stays
                    # replay-stable.
                    tracer.bump("event/job_finish:stale")
                    self._handle(ev, queue)
                else:
                    # begin/end (not span()): this is the per-event hot path
                    # and the context-manager machinery would roughly double
                    # the enabled tracing cost (see benchmarks/obs_overhead).
                    tok = _begin(_EVENT_LABELS[ev.kind], "service",
                                 self._clock)
                    try:
                        self._handle(ev, queue)
                    finally:
                        _end(tok)
        finally:
            if tracer is not None:
                tracer.set_sim_clock(None)
        unfinished = sum(1 for j in self.jobs.values() if not j.finished)
        horizon = until if until is not None else self._clock
        return self.metrics.report(
            policy=self.policy,
            horizon_s=horizon,
            jobs_unfinished=unfinished,
            steady_state_estimate=dict(self.last_estimate),
        )

    # ------------------------------------------------------------------
    # progress accounting (continuous time)
    # ------------------------------------------------------------------
    def _advance(self, t: float) -> None:
        if t <= self._last_advance:
            return
        # only jobs granted a rate at the last solve can progress (rates are
        # only raised inside _resolve, which rebuilds this snapshot)
        for job in self._running_jobs:
            if job.finished or job.rate <= 0.0:
                continue
            start = max(self._last_advance, job.resume_at)
            if t <= start:
                continue
            gained = job.rate * (t - start)
            credited = min(job.total_work - job.done, gained)
            if credited > 0:
                job.done += credited
                self.metrics.add_delivered(job.tenant, credited)
        self._last_advance = t

    # ------------------------------------------------------------------
    # event handling
    # ------------------------------------------------------------------
    def _finish_is_stale(self, ev: Event) -> bool:
        """A predicted JOB_FINISH is stale when its job is gone, already
        finished, or was re-planned since (version bump). Deterministic —
        the trace elision in ``_run`` relies on that."""
        job = self.jobs.get(ev.job_id)
        return (job is None or job.finished
                or job.version != ev.payload.get("version"))

    def _handle(self, ev: Event, queue: EventQueue) -> None:
        k = ev.kind
        if k == EventKind.JOB_FINISH:
            if self._finish_is_stale(ev):
                # stale prediction — but it may have been the same-instant
                # event that deferred an earlier dirty batch: give the
                # throttle a chance to fire now
                self._maybe_resolve(ev.time, queue)
                return
            job = self.jobs[ev.job_id]
            remaining = job.total_work - job.done
            if remaining > 1e-6 * max(job.total_work, 1.0) + 1e-9:
                # drift (e.g. migration stall pushed the finish out): re-predict
                if job.rate > 0:
                    t_fin = max(ev.time, job.resume_at) + remaining / job.rate
                    queue.push(Event(t_fin, EventKind.JOB_FINISH, tenant=job.tenant,
                                     job_id=job.job_id, payload={"version": job.version}))
                self._maybe_resolve(ev.time, queue)
                return
            job.done = job.total_work
            job.rate = 0.0
            job.finish_time = ev.time
            self.metrics.on_event()
            self.metrics.on_job_finish(job.job_id, job.tenant, job.submit_time, ev.time)
            self._mark_dirty()
            self._maybe_resolve(ev.time, queue)
            return

        self.metrics.on_event()
        if k == EventKind.RESOLVE:
            self._resolve_pending = False
            self._maybe_resolve(ev.time, queue)
            return
        if k == EventKind.TENANT_JOIN:
            jts = {
                d["name"]: JobTypeProfile(
                    name=d["name"], speedup=tuple(float(s) for s in d["speedup"]),
                    min_demand=int(d.get("min_demand", 1)))
                for d in ev.payload.get("job_types", [])
            }
            old = self.tenants.get(ev.tenant)
            if old is not None and old.present and _tenant_weighted(old):
                self._weighted_present -= 1
            t = ServiceTenant(
                name=ev.tenant, job_types=jts,
                weight=float(ev.payload.get("weight", 1.0)), joined_at=ev.time)
            self.tenants[ev.tenant] = t
            if _tenant_weighted(t):
                self._weighted_present += 1
            self.metrics.on_tenant_join(ev.tenant, ev.time)
            self._refresh_quarantine(t, ev.time)
        elif k == EventKind.TENANT_LEAVE:
            t = self.tenants.get(ev.tenant)
            if t is not None:
                if t.left_at is None and _tenant_weighted(t):
                    self._weighted_present -= 1
                t.left_at = ev.time
                for job in self.jobs.values():
                    if job.tenant == ev.tenant and not job.finished:
                        job.rate = 0.0
                        job.version += 1
                self.metrics.on_tenant_leave(ev.tenant, ev.time)
        elif k == EventKind.JOB_SUBMIT:
            if ev.tenant not in self.tenants:
                raise ValueError(f"job submit for unknown tenant {ev.tenant!r} at t={ev.time}")
            jt = ev.payload["job_type"]
            if jt not in self.tenants[ev.tenant].job_types:
                raise ValueError(f"unknown job type {jt!r} for tenant {ev.tenant!r}")
            self.jobs[ev.job_id] = ServiceJob(
                job_id=ev.job_id, tenant=ev.tenant, job_type=jt,
                workers=int(ev.payload["workers"]),
                total_work=float(ev.payload["total_work"]), submit_time=ev.time)
        elif k == EventKind.HOST_FAIL:
            pair = (int(ev.payload["type"]), int(ev.payload["host"]))
            if not self._known_host(pair):
                self.metrics.on_anomaly("unknown_host")
                self._maybe_resolve(ev.time, queue)
                return
            if pair in self.down_hosts:
                # already down: a duplicate FAIL must not re-dirty the solver
                # (and on a set it cannot double-count capacity loss)
                self.metrics.on_anomaly("duplicate_host_fail")
                self._maybe_resolve(ev.time, queue)
                return
            self.down_hosts.add(pair)
            self._drop_dead_workers(pair)
        elif k == EventKind.HOST_RECOVER:
            pair = (int(ev.payload["type"]), int(ev.payload["host"]))
            if pair not in self.down_hosts:
                self.metrics.on_anomaly("spurious_host_recover")
                self._maybe_resolve(ev.time, queue)
                return
            self.down_hosts.discard(pair)
        elif k == EventKind.PROFILE_UPDATE:
            t = self.tenants.get(ev.tenant)
            if t is not None:
                was_weighted = t.present and _tenant_weighted(t)
                jt = ev.payload["job_type"]
                t.job_types[jt] = JobTypeProfile(
                    name=jt, speedup=tuple(float(s) for s in ev.payload["speedup"]),
                    min_demand=t.job_types[jt].min_demand if jt in t.job_types else 1)
                t.invalidate_profile_cache()
                self._profile_epoch += 1
                now_weighted = t.present and _tenant_weighted(t)
                self._weighted_present += int(now_weighted) - int(was_weighted)
                self._refresh_quarantine(t, ev.time)
        else:
            raise ValueError(f"unhandled event kind: {k}")
        self._mark_dirty()
        self._maybe_resolve(ev.time, queue)

    def _known_host(self, pair: Tuple[int, int]) -> bool:
        j, h = pair
        if not 0 <= j < len(self.cluster.types):
            return False
        n_hosts = int(math.ceil(int(self.cluster.m[j]) / self.devices_per_host))
        return 0 <= h < n_hosts

    # ------------------------------------------------------------------
    # input sanitization: profile quarantine
    # ------------------------------------------------------------------
    def _profile_invalid_reason(self, t: ServiceTenant) -> Optional[str]:
        """Why this tenant's profiles would poison a batched solve (or None)."""
        k = len(self.cluster.types)
        for name in sorted(t.job_types):
            v = np.asarray(t.job_types[name].speedup, dtype=np.float64)
            if v.shape != (k,):
                return (f"job type {name!r}: speedup has {v.size} entries, "
                        f"cluster has {k} device types")
            if not bool(np.all(np.isfinite(v))):
                return f"job type {name!r}: non-finite speedup"
            if bool(np.any(v <= 0.0)):
                return f"job type {name!r}: non-positive speedup"
        return None

    def _refresh_quarantine(self, t: ServiceTenant, now: float) -> None:
        """Quarantine tenants whose profiles would poison the solve; release
        them as soon as every job type validates again. Quarantined tenants
        keep their jobs queued but are excluded from the fair-share solve."""
        if not self.guardrails:
            return
        reason = self._profile_invalid_reason(t)
        if reason is not None and t.name not in self.quarantined:
            self.quarantined.add(t.name)
            self.metrics.on_quarantine(t.name, now, reason)
            for job in self.jobs.values():
                if job.tenant == t.name and not job.finished:
                    job.rate = 0.0
                    job.version += 1  # invalidate stale finish predictions
        elif reason is None and t.name in self.quarantined:
            self.quarantined.discard(t.name)
            self.metrics.on_unquarantine(t.name, now)

    def _drop_dead_workers(self, pair: Tuple[int, int]) -> None:
        """A host died: immediately stop crediting workers placed on it
        (straggler model on the survivors) until the next re-solve."""
        for job in self.jobs.values():
            if job.finished or not job.assignment or job.rate <= 0:
                continue
            live = [(j, h, c) for (j, h, c) in job.assignment if (j, h) not in self.down_hosts]
            if len(live) == len(job.assignment):
                continue
            job.version += 1  # old finish prediction is now wrong
            if not live:
                job.rate = 0.0
                continue
            w = self.tenants[job.tenant].job_types[job.job_type].speedup_vec()
            job.rate = self._job_rate(live, w)

    def _job_rate(self, assignment: Sequence[Tuple[int, int, int]], w: Array) -> float:
        types_used = sorted({j for j, _, _ in assignment})
        hosts_used = {(j, h) for j, h, _ in assignment}
        n_workers = sum(c for _, _, c in assignment)
        rate = n_workers * float(w[types_used[0]])  # slowest type paces sync SGD
        if len(hosts_used) > 1:
            rate *= self.contention_penalty
        return rate

    # ------------------------------------------------------------------
    # re-solve throttle + dirty batching
    # ------------------------------------------------------------------
    def _mark_dirty(self) -> None:
        self._dirty = True
        self._dirty_count += 1

    def _maybe_resolve(self, now: float, queue: EventQueue) -> None:
        if not self._dirty:
            return
        nxt = queue.peek_time()
        if nxt is not None and nxt <= now:
            return  # more events at this instant: batch them into one solve
        if now >= self._next_solve_ok:
            self._resolve(now, queue)
        elif not self._resolve_pending:
            self._resolve_pending = True
            obs_trace.instant("dirty/defer", "service",
                              pending=self._dirty_count,
                              fire_at=self._next_solve_ok)
            queue.push(Event(self._next_solve_ok, EventKind.RESOLVE))

    # ------------------------------------------------------------------
    # the decision: fair-share solve -> rounding -> packing -> rates
    # ------------------------------------------------------------------
    def _effective_capacity(self) -> Array:
        m_eff = self.cluster.m_vec.copy()
        for (j, h) in sorted(self.down_hosts):
            host_size = min(self.devices_per_host,
                            max(0, int(self.cluster.m[j]) - h * self.devices_per_host))
            m_eff[j] = max(0.0, m_eff[j] - host_size)
        return m_eff

    def _active_tenants(self, now: float) -> List[ServiceTenant]:
        has_work: Set[str] = set()
        for job in self.jobs.values():
            if not job.finished and job.submit_time <= now:
                has_work.add(job.tenant)
        # Tenant registration order, restricted to the (sorted) worked set —
        # never hash order, so replay is independent of PYTHONHASHSEED.
        worked = frozenset(sorted(has_work - self.quarantined))
        return [t for t in self.tenants.values() if t.present and t.name in worked]

    def _solve_allocation(self, active: List[ServiceTenant], m_eff: Array):
        key = (self._profile_epoch, tuple(t.name for t in active))
        if self._solver_cache_key == key:
            W, weighted = self._solver_cache
        else:
            W = np.empty((len(active), len(self.cluster.types)))
            for i, t in enumerate(active):
                W[i] = t.mean_speedup()
            weighted = (self.use_weighted_oef and self._weighted_present > 0
                        and any(_tenant_weighted(t) for t in active))
            self._solver_cache_key, self._solver_cache = key, (W, weighted)
        if weighted:
            ten = [Tenant(name=t.name, job_types=tuple(t.job_types.values()), weight=t.weight)
                   for t in active]
            mode = "cooperative" if self.policy == "oef-coop" else "noncooperative"
            ta = oef.evaluate_tenants(
                ten, ClusterSpec(self.cluster.types, tuple(int(x) for x in m_eff)),
                mode=mode, prev=self._prev_alloc,
                fast=self.fast_noncoop and mode == "noncooperative",
                backend=self.solver_backend,
                failsafe=self.guardrails,
                max_retries=self.solver_max_retries if self.guardrails else 0,
                time_budget_s=self.solver_time_budget_s, device=self.device)
            self._prev_alloc = ta.row_alloc
            ideal = ta.X
            est = np.einsum("lk,lk->l", W, ta.X)
            reused = bool(ta.row_alloc.meta.get("reused", False))
        else:
            if self.policy in OEF_POLICIES:
                alloc = oef.solve_incremental(
                    W, m_eff, policy=self.policy, prev=self._prev_alloc,
                    fast=self.fast_noncoop, backend=self.solver_backend,
                    failsafe=self.guardrails,
                    max_retries=self.solver_max_retries if self.guardrails else 0,
                    time_budget_s=self.solver_time_budget_s, device=self.device)
            else:
                alloc = baselines.solve_incremental(
                    W, m_eff, policy=self.policy, prev=self._prev_alloc)
            self._prev_alloc = alloc
            ideal, est = alloc.X, alloc.throughput
            reused = bool(alloc.meta.get("reused", False))
        return ideal, est, W, reused

    def _fallback_allocation(self, active: List[ServiceTenant], m_eff: Array):
        """Last rung of the degradation ladder: reuse the last-known-good
        fair shares when the tenant roster still matches (rounding against
        the *current* effective capacity keeps grants feasible), else fall
        back to an equal per-type split. Never raises."""
        names = tuple(t.name for t in active)
        W = np.empty((len(active), len(self.cluster.types)))
        for i, t in enumerate(active):
            W[i] = t.mean_speedup()
        if self._last_good is not None and self._last_good[0] == names:
            ideal = self._last_good[1]
            est = self._last_good[2]
        else:
            ideal = np.tile(m_eff / max(len(active), 1), (len(active), 1))
            est = np.einsum("lk,lk->l", W, ideal)
        self.metrics.on_anomaly("solver_floor")
        return ideal, np.asarray(est, dtype=np.float64), W

    def _resolve(self, now: float, queue: EventQueue) -> None:
        dirty_batch = self._dirty_count
        self._dirty = False
        self._dirty_count = 0
        self._next_solve_ok = now + self.min_resolve_interval_s
        active = self._active_tenants(now)
        if not active:
            self.last_estimate = {}
            for job in self.jobs.values():
                if not job.finished:
                    job.rate = 0.0
                    job.version += 1
            self._running_jobs = []
            return
        m_eff = self._effective_capacity()

        with obs_trace.span("resolve", "service", dirty=dirty_batch,
                            tenants=len(active)):
            t0 = _obs_clock.wall()
            degraded = False
            try:
                with obs_trace.span("solve", "service"):
                    ideal, est, W, reused = self._solve_allocation(active, m_eff)
                if not reused:
                    meta = self._prev_alloc.meta if self._prev_alloc is not None else {}
                    degraded = bool(meta.get("degraded", False))
                self._last_good = (tuple(t.name for t in active), ideal, est)
            except KernelError:
                raise  # the card's path failed: never floored away
            except Exception:
                # the floor of the ladder: every solver tier failed (or
                # guardrails are off and something raised) — fall back to the
                # last-known-good allocation rather than killing the event loop.
                if not self.guardrails:
                    raise
                obs_trace.instant("guardrail/floor", "guardrail")
                ideal, est, W = self._fallback_allocation(active, m_eff)
                reused = False
                degraded = True
                floored = True
            else:
                floored = False
            solver_s = _obs_clock.wall() - t0

            with obs_trace.span("placement", "service"):
                key = tuple(t.name for t in active)
                if self._placer is None or self._placer_key != key:
                    self._placer = RoundingPlacer(len(active), self.cluster.m,
                                                  self.devices_per_host)
                    self._placer_key = key
                min_dem = np.array([min(jt.min_demand for jt in t.job_types.values())
                                    for t in active])
                real = self._placer.round_shares(ideal, min_dem, capacity=m_eff)

                reqs: List[JobRequest] = []
                tenant_jobs: Dict[str, List[ServiceJob]] = {}
                for job in self.jobs.values():
                    if not job.finished and job.submit_time <= now:
                        tenant_jobs.setdefault(job.tenant, []).append(job)
                for ui, t in enumerate(active):
                    budget = int(real[ui].sum())
                    for job in sorted(tenant_jobs.get(t.name, []),
                                      key=lambda j: (-j.starvation, j.job_id)):
                        if budget < job.workers:
                            job.starvation += 1
                            continue
                        budget -= job.workers
                        reqs.append(JobRequest(user=ui, job_id=job.job_id,
                                               workers=job.workers,
                                               starvation=job.starvation))
                placement = self._placer.place(real, reqs, naive=self.naive_placement,
                                               prev=self._prev_assignments,
                                               down_hosts=self.down_hosts)
                self._prev_assignments = placement.assignments

            # -- convert placements into continuous rates + predicted finishes --
            placed_ids = frozenset(sorted(placement.assignments))
            req_ids = {r.job_id for r in reqs}
            for ui, t in enumerate(active):
                for job in tenant_jobs.get(t.name, []):
                    if job.job_id not in placed_ids:
                        if job.job_id in req_ids:
                            # requested but rejected by the packer (fragmentation,
                            # failed hosts): age it like the budget-skipped jobs
                            # so its priority rises (matches the round simulator)
                            job.starvation += 1
                        if job.rate > 0 or job.assignment is not None:
                            job.version += 1  # invalidate stale finish predictions
                        job.rate = 0.0
                        continue
                    assignment = tuple(sorted(placement.assignments[job.job_id]))
                    w = t.job_types[job.job_type].speedup_vec()
                    migrated = job.assignment is not None and job.assignment != assignment
                    job.version += 1
                    job.assignment = assignment
                    job.rate = self._job_rate(assignment, w)
                    # never refund an in-progress migration stall: a re-solve that
                    # keeps the assignment must not pull resume_at back to `now`
                    job.resume_at = max(job.resume_at,
                                        now + (self.migration_overhead_s if migrated else 0.0))
                    job.starvation = 0.0
                    if job.first_scheduled is None:
                        job.first_scheduled = now
                        self.metrics.on_first_scheduled(job.job_id, job.submit_time, now)
                    if job.rate > 0:
                        t_fin = job.resume_at + (job.total_work - job.done) / job.rate
                        queue.push(Event(t_fin, EventKind.JOB_FINISH, tenant=job.tenant,
                                         job_id=job.job_id, payload={"version": job.version}))

            self._running_jobs = [j for j in self.jobs.values()
                                  if not j.finished and j.rate > 0]
            self._n_solves += 1
            self.last_estimate = {t.name: float(e) for t, e in zip(active, est)}
            meta = ({} if floored else
                    self._prev_alloc.meta if self._prev_alloc is not None else {})
            backend_name = ("last-known-good" if floored
                            else str(meta.get("backend", "")))
            fallback_reason = meta.get("fallback_reason")
            self.metrics.on_solve(SolveRecord(
                time=now, n_tenants=len(active), latency_s=solver_s, reused=reused,
                dirty_events=dirty_batch, policy=self.policy,
                backend=backend_name,
                fallback_reason=fallback_reason,
                degraded=degraded, quarantined=len(self.quarantined),
                warm_started=not reused and bool(meta.get("warm_started", False))))
            audit = None
            if self.audit_every > 0 and self._n_solves % self.audit_every == 0:
                audit = properties.property_report(W, ideal, m_eff)
                self.metrics.on_audit(now, audit)

        reg = obs_metrics.get_metrics()
        if reg is not None:
            self._emit_metrics(reg, now, queue, solver_s=solver_s,
                               backend=backend_name, reused=reused,
                               degraded=degraded, floored=floored,
                               fallback=fallback_reason is not None,
                               n_active=len(active), audit=audit)

    def _emit_metrics(self, reg, now: float, queue: EventQueue, *,
                      solver_s: float, backend: str, reused: bool,
                      degraded: bool, floored: bool, fallback: bool,
                      n_active: int, audit: Optional[Dict[str, object]]) -> None:
        """Refresh the obs instruments and emit one time-series sample.

        Called once per re-solve (the control plane's natural heartbeat), so
        every sample row reflects a consistent post-solve state at sim-time
        ``now``."""
        reg.counter("service.solves").inc()
        if reused:
            reg.counter("service.reused_solves").inc()
        if degraded:
            reg.counter("service.degraded_solves").inc()
        if floored:
            reg.counter("service.floored_solves").inc()
        if fallback:
            reg.counter("service.fallbacks").inc()
        reg.gauge("service.queue_depth", "events").set(len(queue))
        reg.gauge("service.quarantine_size", "tenants").set(len(self.quarantined))
        reg.gauge("service.active_tenants", "tenants").set(n_active)
        reg.gauge("service.down_hosts", "hosts").set(len(self.down_hosts))
        if not reused:
            reg.histogram(
                "service.solve_latency_ms." + (backend or "default")
            ).observe(solver_s * 1e3)
        if audit is not None:
            reg.counter("service.audits").inc()
            reg.gauge("fairness.max_envy").set(float(audit["max_envy"]))
            reg.gauge("fairness.total_efficiency").set(
                float(audit["total_efficiency"]))
            reg.gauge("fairness.min_si_slack").set(float(audit["min_si_slack"]))
        reg.sample(now)


# ---------------------------------------------------------------------------
# Cross-validation harness: online service vs. round simulator
# ---------------------------------------------------------------------------


def crossval_static(
    tenants: Sequence[SimTenant],
    cluster: ClusterSpec,
    policy: str = "oef-coop",
    *,
    rounds: int = 5,
    round_len_s: float = 300.0,
    **sched_kw,
) -> Dict[str, object]:
    """Run both engines on the same static workload; compare steady state.

    The workload must be static over the horizon (every tenant active with
    unfinished jobs throughout). Returns the per-tenant steady-state
    normalized-throughput estimates of each engine plus the max relative
    error — the acceptance check asserts < 1%.
    """
    from ..core.simulator import ClusterSimulator
    from .traces import static_trace_from_sim_tenants

    sim = ClusterSimulator(cluster, copy.deepcopy(list(tenants)), policy=policy,
                           round_len_s=round_len_s)
    simres = sim.run(max_rounds=rounds)
    if not simres.records:
        raise ValueError("simulator produced no rounds — workload not static?")
    sim_est = simres.records[-1].tenant_efficiency

    trace = static_trace_from_sim_tenants(tenants, round_len_s=round_len_s)
    sched = OnlineScheduler(cluster, policy, **sched_kw)
    sched.run(trace, until=rounds * round_len_s)
    svc_est = sched.last_estimate

    common = sorted(set(sim_est) & set(svc_est))
    if not common or set(sim_est) != set(svc_est):
        raise ValueError(f"tenant sets diverged: sim={sorted(sim_est)} svc={sorted(svc_est)}")
    max_rel = max(abs(svc_est[t] - sim_est[t]) / max(abs(sim_est[t]), 1e-12) for t in common)
    return {"simulator": sim_est, "service": svc_est, "max_rel_err": float(max_rel)}
