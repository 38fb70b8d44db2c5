"""Trace generation and replay for the online service.

Two sources feed the event queue:
  - :func:`synthetic_trace` — a Philly-like continuous-time workload (§6.1.2
    adapted from rounds to Poisson arrivals): tenants join, each submits an
    initial burst plus a Poisson stream of jobs with exponential work sizes;
    optional host fail/recover churn. Fully seeded and deterministic.
  - :func:`read_trace_csv` — replay adapter for CSV traces
    (``time,kind,tenant,job_id,payload``; payload is a JSON object), the
    interchange format :func:`write_trace_csv` emits. Floats are serialized
    with ``repr`` so generate -> dump -> replay round-trips bit-exactly.

:func:`static_trace_from_sim_tenants` converts a round-simulator tenant
population into an equivalent trace — the cross-validation harness runs both
engines on literally the same workload.
"""
from __future__ import annotations

import csv
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.profiler import PAPER_WORKLOAD_SPEEDUPS, ProfilingAgent, WorkloadCost
from ..core.simulator import SimTenant
from ..core.types import ClusterSpec, JobTypeProfile, TPU_FLEET
from .events import Event, EventKind, TRACE_KINDS

TRACE_HEADER = ("time", "kind", "tenant", "job_id", "payload")


# ---------------------------------------------------------------------------
# Job-type catalogs
# ---------------------------------------------------------------------------


def default_job_types(cluster_kind: str = "paper") -> List[JobTypeProfile]:
    """Catalog of job types matching a cluster's device-type count.

    ``paper``: the six Fig-1 workloads on RTX 3070/3080/3090 (k=3).
    ``tpu``: four synthetic roofline workloads profiled across the TPU fleet
    (k=4) by the ProfilingAgent — compute-bound, memory-bound, balanced and
    collective-heavy, spanning the speedup-vector shapes the fleet produces.
    """
    if cluster_kind == "paper":
        return [JobTypeProfile(name, vec) for name, vec in PAPER_WORKLOAD_SPEEDUPS.items()]
    if cluster_kind == "tpu":
        agent = ProfilingAgent(TPU_FLEET)
        costs = [
            WorkloadCost("dense-train", flops=8e13, hbm_bytes=1.2e11, collective_bytes=2e9),
            WorkloadCost("membound-embed", flops=4e12, hbm_bytes=9e11),
            WorkloadCost("balanced-mlm", flops=3e13, hbm_bytes=3e11, collective_bytes=1e9),
            WorkloadCost("allreduce-heavy", flops=2e13, hbm_bytes=1e11,
                         collective_bytes=2e10, min_demand=2),
        ]
        return [agent.profile(c) for c in costs]
    raise ValueError(f"unknown cluster kind: {cluster_kind}")


def default_cluster(cluster_kind: str = "paper") -> ClusterSpec:
    if cluster_kind == "paper":
        return ClusterSpec.paper_cluster()
    if cluster_kind == "tpu":
        return ClusterSpec(types=tuple(d.name for d in TPU_FLEET), m=(16, 16, 8, 8))
    raise ValueError(f"unknown cluster kind: {cluster_kind}")


def _job_type_payload(jt: JobTypeProfile) -> Dict[str, object]:
    return {"name": jt.name, "speedup": [float(s) for s in jt.speedup],
            "min_demand": int(jt.min_demand)}


# ---------------------------------------------------------------------------
# Synthetic generator
# ---------------------------------------------------------------------------


def synthetic_trace(
    n_tenants: int = 4,
    *,
    job_types: Optional[Sequence[JobTypeProfile]] = None,
    cluster: Optional[ClusterSpec] = None,
    duration_s: float = 7200.0,
    mean_interarrival_s: float = 600.0,
    jobs_at_join: int = 3,
    mean_work_s: float = 1800.0,
    workers_choices: Sequence[int] = (1, 1, 2, 4),
    weight_choices: Sequence[float] = (1.0,),
    join_spread_s: float = 0.0,
    host_failures_per_hour: float = 0.0,
    mean_outage_s: float = 600.0,
    devices_per_host: int = 4,
    seed: int = 0,
) -> List[Event]:
    """Seeded Philly-like trace: tenant joins, job arrival streams, failures."""
    rng = np.random.default_rng(seed)
    job_types = list(job_types) if job_types is not None else default_job_types("paper")
    events: List[Event] = []
    for i in range(n_tenants):
        name = f"tenant{i}"
        jt = job_types[int(rng.integers(len(job_types)))]
        weight = float(rng.choice(np.asarray(weight_choices, dtype=np.float64)))
        join_t = float(rng.uniform(0.0, join_spread_s)) if join_spread_s > 0 else 0.0
        events.append(Event(join_t, EventKind.TENANT_JOIN, tenant=name, payload={
            "weight": weight, "job_types": [_job_type_payload(jt)]}))
        q = 0
        for _ in range(jobs_at_join):
            events.append(_submit(join_t, name, jt, q, rng, workers_choices, mean_work_s))
            q += 1
        t = join_t
        while True:
            t += float(rng.exponential(mean_interarrival_s))
            if t >= duration_s:
                break
            events.append(_submit(t, name, jt, q, rng, workers_choices, mean_work_s))
            q += 1
    if host_failures_per_hour > 0:
        if cluster is None:
            raise ValueError("host_failures_per_hour needs a cluster spec")
        events.extend(paired_host_churn(
            cluster, duration_s=duration_s,
            failures_per_hour=host_failures_per_hour,
            mean_outage_s=mean_outage_s,
            devices_per_host=devices_per_host, rng=rng))
    events.sort(key=lambda e: e.time)  # stable: same-time order = generation order
    bad = validate_host_pairing(events)
    if bad:
        raise RuntimeError(f"generated trace has unpaired host churn: {bad}")
    return events


def paired_host_churn(
    cluster: ClusterSpec,
    *,
    duration_s: float,
    failures_per_hour: float,
    mean_outage_s: float,
    devices_per_host: int = 4,
    rng: np.random.Generator,
) -> List[Event]:
    """Per-host alternating FAIL/RECOVER churn — strictly paired by design.

    Each host runs its own renewal process: exponential time-to-failure,
    exponential outage, and the next failure clock only starts after the
    recovery, so a host can never be re-failed while already down. Every
    emitted FAIL has its matching RECOVER in the stream (an outage that
    outlives ``duration_s`` still emits the RECOVER past the horizon rather
    than leaving the pair dangling — replays bounded by ``until=`` simply
    never pop it). The JAX package's chaos harness reuses this helper and the same
    invariant when merging storm churn into a base trace.
    """
    events: List[Event] = []
    rate = failures_per_hour / 3600.0
    for j in range(cluster.k):
        n_hosts = int(np.ceil(cluster.m[j] / devices_per_host))
        for h in range(n_hosts):
            t = float(rng.exponential(1.0 / rate))
            while t < duration_s:
                up = t + float(rng.exponential(mean_outage_s))
                events.append(Event(t, EventKind.HOST_FAIL,
                                    payload={"type": j, "host": h}))
                events.append(Event(up, EventKind.HOST_RECOVER,
                                    payload={"type": j, "host": h}))
                t = up + float(rng.exponential(1.0 / rate))
    return events


def validate_host_pairing(events: Sequence[Event]) -> List[str]:
    """Check HOST_FAIL/HOST_RECOVER alternation per host in time order.

    Returns human-readable violations (empty = clean): a FAIL for a host
    already down, a RECOVER for a host that is up, or a FAIL left dangling
    with no matching RECOVER anywhere in the stream. Trace generators assert
    on this; the scheduler additionally tolerates violating streams at
    runtime (counted under ``report.anomalies``) since merged or hand-edited
    traces may break the invariant.
    """
    violations: List[str] = []
    down: set = set()
    for ev in sorted(events, key=lambda e: e.time):
        if ev.kind == EventKind.HOST_FAIL:
            pair = (int(ev.payload["type"]), int(ev.payload["host"]))
            if pair in down:
                violations.append(
                    f"t={ev.time}: host {pair} re-failed while already down")
            down.add(pair)
        elif ev.kind == EventKind.HOST_RECOVER:
            pair = (int(ev.payload["type"]), int(ev.payload["host"]))
            if pair not in down:
                violations.append(
                    f"t={ev.time}: host {pair} recovered while not down")
            down.discard(pair)
    for pair in sorted(down):
        violations.append(f"host {pair} failed but never recovers in-stream")
    return violations


def _submit(t, tenant, jt, q, rng, workers_choices, mean_work_s) -> Event:
    return Event(t, EventKind.JOB_SUBMIT, tenant=tenant, job_id=f"{tenant}-j{q}",
                 payload={"job_type": jt.name,
                          "workers": int(rng.choice(np.asarray(workers_choices))),
                          "total_work": float(rng.exponential(mean_work_s)) + 60.0})


def static_trace_from_sim_tenants(
    tenants: Sequence[SimTenant], *, round_len_s: float = 300.0
) -> List[Event]:
    """Express a round-simulator tenant population as a trace (cross-val)."""
    events: List[Event] = []
    for t in tenants:
        join_t = t.submit_round * round_len_s
        events.append(Event(join_t, EventKind.TENANT_JOIN, tenant=t.name, payload={
            "weight": float(t.weight),
            "job_types": [_job_type_payload(jt) for jt in t.job_types.values()]}))
        for job in t.jobs:
            events.append(Event(max(job.submit_round, t.submit_round) * round_len_s,
                                EventKind.JOB_SUBMIT, tenant=t.name, job_id=job.job_id,
                                payload={"job_type": job.job_type,
                                         "workers": int(job.workers),
                                         "total_work": float(job.total_work)}))
    events.sort(key=lambda e: e.time)
    return events


# ---------------------------------------------------------------------------
# CSV replay adapter
# ---------------------------------------------------------------------------


def write_trace_csv(events: Sequence[Event], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(TRACE_HEADER)
        for ev in events:
            if ev.kind not in TRACE_KINDS:
                raise ValueError(f"internal event kind {ev.kind} is not serializable")
            w.writerow([repr(float(ev.time)), ev.kind.value, ev.tenant, ev.job_id,
                        json.dumps(ev.payload, sort_keys=True)])


def read_trace_csv(path: str) -> List[Event]:
    events: List[Event] = []
    with open(path, newline="") as f:
        r = csv.reader(f)
        header = next(r)
        if tuple(header) != TRACE_HEADER:
            raise ValueError(f"bad trace header: {header}")
        for row in r:
            if not row:
                continue
            t, kind, tenant, job_id, payload = row
            ev = Event(float(t), EventKind(kind), tenant=tenant, job_id=job_id,
                       payload=json.loads(payload))
            if ev.kind not in TRACE_KINDS:
                raise ValueError(f"trace contains internal event kind {ev.kind}")
            events.append(ev)
    return events
