"""Online event-driven cluster service (beyond-paper subsystem).

The paper's evaluation (§6) — and ``repro_torch.core.simulator`` — is round-batch
and offline: the whole workload is known up front and the world only changes
every 300 s. This package is the *online* operating mode of real cluster
managers (the setting of Gavel's online policies and Themis' auction rounds):
a continuous-time, event-driven resource manager that reacts to job arrivals,
completions, tenant churn, host failures and profile updates as events, and
re-solves the OEF fair-share programs incrementally on dirty state.

Modules:
  - events    — deterministic seeded event queue (submit/finish/join/leave/
    host fail/recover/profile update) with stable same-time ordering;
  - traces    — Philly-like synthetic trace generator + CSV replay adapter;
  - scheduler — ``OnlineScheduler``: cluster state, dirty-set batching, a
    re-solve throttle, warm-started incremental OEF solves
    (``core.oef.solve_incremental`` / ``core.baselines.solve_incremental``),
    placement via ``core.placement.RoundingPlacer``;
  - metrics   — per-tenant throughput / JCT / queue delay, re-solve latency,
    and fairness-property telemetry emitted as JSON.

The JAX package's chaos engine (``faults``) and crash-recovery journal
(``journal``) are not ported yet.

CLI:  ``python -m repro_torch.service [--device cuda] [--replay trace.csv]``
"""
from .events import Event, EventKind, EventQueue  # noqa: F401
from .metrics import MetricsCollector, ServiceReport  # noqa: F401
from .scheduler import OnlineScheduler, ServiceJob, ServiceTenant  # noqa: F401
from .traces import (  # noqa: F401
    default_job_types,
    read_trace_csv,
    static_trace_from_sim_tenants,
    synthetic_trace,
    write_trace_csv,
)
