"""Telemetry for the online service, emitted as JSON.

Per tenant: delivered work (slowest-device-seconds), realized throughput
(work / membership time), job completions + JCTs, queue delays (submit ->
first scheduled). Per re-solve: wall-clock latency, dirty-event batch size,
whether the incremental hook reused the previous allocation, which registry
backend produced the answer and — when a fast tier declined the instance —
the fallback reason (aggregated as ``fallback_count`` / ``fallback_reasons``
in the report, so LP-fallback rates are first-class telemetry). Fairness audits
run ``core.properties.property_report`` on the fractional allocation every
``audit_every``-th solve — the same checkers the offline benchmarks use, now
as runtime telemetry.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from ..obs import json_safe, tally


@dataclasses.dataclass
class SolveRecord:
    time: float
    n_tenants: int
    latency_s: float
    reused: bool
    dirty_events: int
    policy: str
    #: registry backend that produced the allocation ("" for legacy callers).
    backend: str = ""
    #: first declined backend's reason when the chain fell through, else None.
    fallback_reason: Optional[str] = None
    #: a guardrail engaged for this solve: dispatch escalated past a timeout /
    #: crash / exhausted transient retries, or the scheduler floored on the
    #: last-known-good allocation. Routine off-class fallbacks stay False.
    degraded: bool = False
    #: tenants quarantined (invalid profiles) at the time of this solve.
    quarantined: int = 0
    #: a water-filling tier probed the previous tau before bisecting (False
    #: for reused solves, which run no solver).
    warm_started: bool = False


@dataclasses.dataclass
class ServiceReport:
    """Final JSON-serializable report of one service run."""

    policy: str
    horizon_s: float
    n_events: int
    n_solves: int
    n_reused_solves: int
    fallback_count: int
    fallback_reasons: Dict[str, int]
    solver_backends: Dict[str, int]
    jobs_finished: int
    jobs_unfinished: int
    mean_jct_s: float
    p95_jct_s: float
    mean_queue_delay_s: float
    resolve_latency_ms_mean: float
    resolve_latency_ms_p95: float
    tenant_throughput: Dict[str, float]
    tenant_delivered_work: Dict[str, float]
    tenant_jct_s: Dict[str, float]
    fairness_audits: List[Dict[str, object]]
    steady_state_estimate: Dict[str, float]
    #: solves where a guardrail engaged (escalation ladder / last-known-good).
    degraded_solves: int = 0
    #: quarantine/release log: {"time", "tenant", "action", "reason"}.
    quarantine_events: List[Dict[str, object]] = dataclasses.field(
        default_factory=list)
    #: ignored anomalous events by kind (duplicate_host_fail, ...).
    anomalies: Dict[str, int] = dataclasses.field(default_factory=dict)

    def to_json(self, indent: Optional[int] = 2) -> str:
        # json_safe: audits and steady_state_estimate can carry numpy
        # scalars (np.float64 / np.int64 / np.bool_) nested arbitrarily
        # deep — json.dumps rejects them without recursive coercion.
        return json.dumps(json_safe(dataclasses.asdict(self)),
                          indent=indent, sort_keys=True)


class MetricsCollector:
    def __init__(self) -> None:
        self.delivered: Dict[str, float] = {}
        self.joined_at: Dict[str, float] = {}
        self.left_at: Dict[str, float] = {}
        self.jcts: Dict[str, float] = {}
        self.jct_tenant: Dict[str, str] = {}
        self.queue_delays: Dict[str, float] = {}
        self.solves: List[SolveRecord] = []
        self.audits: List[Dict[str, object]] = []
        self.quarantine_log: List[Dict[str, object]] = []
        self.anomalies: Dict[str, int] = {}
        self.n_events = 0

    # -- event hooks --------------------------------------------------------
    def on_event(self) -> None:
        self.n_events += 1

    def on_tenant_join(self, tenant: str, time: float) -> None:
        self.joined_at.setdefault(tenant, time)
        self.delivered.setdefault(tenant, 0.0)
        # rejoin: the membership window reopens (throughput divides by first
        # join -> final leave/horizon; a stale left_at would shrink it)
        self.left_at.pop(tenant, None)

    def on_tenant_leave(self, tenant: str, time: float) -> None:
        self.left_at[tenant] = time

    def on_first_scheduled(self, job_id: str, submit_time: float, time: float) -> None:
        self.queue_delays.setdefault(job_id, max(0.0, time - submit_time))

    def on_job_finish(self, job_id: str, tenant: str, submit_time: float, time: float) -> None:
        self.jcts[job_id] = time - submit_time
        self.jct_tenant[job_id] = tenant

    def add_delivered(self, tenant: str, work: float) -> None:
        self.delivered[tenant] = self.delivered.get(tenant, 0.0) + work

    def on_solve(self, rec: SolveRecord) -> None:
        self.solves.append(rec)

    def on_quarantine(self, tenant: str, time: float, reason: str) -> None:
        self.quarantine_log.append(
            {"time": time, "tenant": tenant, "action": "quarantine",
             "reason": reason})

    def on_unquarantine(self, tenant: str, time: float) -> None:
        self.quarantine_log.append(
            {"time": time, "tenant": tenant, "action": "release", "reason": ""})

    def on_anomaly(self, kind: str) -> None:
        self.anomalies[kind] = self.anomalies.get(kind, 0) + 1

    def on_audit(self, time: float, report: Dict[str, object]) -> None:
        # sanitize at ingestion (not just in to_json) so journal snapshots
        # of the audit log serialize identically before and after recovery
        self.audits.append(json_safe({"time": time, **report}))

    # -- final report -------------------------------------------------------
    def report(self, *, policy: str, horizon_s: float, jobs_unfinished: int,
               steady_state_estimate: Dict[str, float]) -> ServiceReport:
        jct_vals = np.asarray(list(self.jcts.values()), dtype=np.float64)
        lat_ms = np.asarray([s.latency_s * 1e3 for s in self.solves], dtype=np.float64)
        delays = np.asarray(list(self.queue_delays.values()), dtype=np.float64)
        tenant_tp = {}
        for t, work in self.delivered.items():
            t0 = self.joined_at.get(t, 0.0)
            t1 = self.left_at.get(t, horizon_s)
            tenant_tp[t] = work / max(t1 - t0, 1e-9)
        tenant_jct: Dict[str, List[float]] = {}
        for job_id, jct in self.jcts.items():
            tenant_jct.setdefault(self.jct_tenant[job_id], []).append(jct)
        return ServiceReport(
            policy=policy,
            horizon_s=horizon_s,
            n_events=self.n_events,
            n_solves=len(self.solves),
            n_reused_solves=sum(1 for s in self.solves if s.reused),
            fallback_count=sum(1 for s in self.solves if s.fallback_reason),
            fallback_reasons=tally(s.fallback_reason for s in self.solves
                                   if s.fallback_reason),
            solver_backends=tally(s.backend for s in self.solves if s.backend),
            jobs_finished=len(self.jcts),
            jobs_unfinished=jobs_unfinished,
            mean_jct_s=float(jct_vals.mean()) if jct_vals.size else 0.0,
            p95_jct_s=float(np.percentile(jct_vals, 95)) if jct_vals.size else 0.0,
            mean_queue_delay_s=float(delays.mean()) if delays.size else 0.0,
            resolve_latency_ms_mean=float(lat_ms.mean()) if lat_ms.size else 0.0,
            resolve_latency_ms_p95=float(np.percentile(lat_ms, 95)) if lat_ms.size else 0.0,
            tenant_throughput=tenant_tp,
            tenant_delivered_work=dict(self.delivered),
            tenant_jct_s={t: float(np.mean(v)) for t, v in tenant_jct.items()},
            fairness_audits=self.audits,
            steady_state_estimate=steady_state_estimate,
            degraded_solves=sum(1 for s in self.solves if s.degraded),
            quarantine_events=list(self.quarantine_log),
            anomalies=dict(self.anomalies),
        )
