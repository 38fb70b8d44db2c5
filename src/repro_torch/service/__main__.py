"""CLI for the online cluster service, solving on the GPU.

Replay a CSV trace (or generate a synthetic one) through the event-driven
OEF scheduler and emit JSON metrics. By default the policy is
``oef-noncoop`` and its re-solves run on the ``torch`` backend on
``--device cuda``; ``--policy oef-coop`` runs the cooperative re-solves on
the torch primal–dual tier the same way:

    PYTHONPATH=src python -m repro_torch.service --tenants 4 --duration 7200
    PYTHONPATH=src python -m repro_torch.service --device cpu --tenants 4
    PYTHONPATH=src python -m repro_torch.service --policy oef-coop --tenants 64
    PYTHONPATH=src python -m repro_torch.service --replay trace.csv --policy gavel
    PYTHONPATH=src python -m repro_torch.service --emit-trace trace.csv --tenants 8
    PYTHONPATH=src python -m repro_torch.service --trace t.json --metrics m.jsonl
    PYTHONPATH=src python -m repro_torch.service --chaos --journal j/ --until 3600

Exit code 0 on a completed replay; the JSON report goes to stdout (or
``--out``). ``--trace``/``--metrics`` write observability artifacts (Chrome
trace JSON for Perfetto, metrics JSONL) readable via
``python -m repro_torch.obs report`` — see docs/observability.md.
``--chaos`` merges the standard seeded fault storm into the trace and puts
the solver-fault wrapper on the ``--backend`` chain (so with ``torch``
every planned fault fires on the torch tier); its summary goes to stderr.
``--journal DIR`` journals the run; a directory that already holds
snapshots resumes it. ``--device cuda`` (the default) raises when torch
sees no GPU, for a resumed run too.
"""
from __future__ import annotations

import argparse
import sys

from .. import obs
from ..core import backends
from .faults import ChaosEngine, standard_plan
from .journal import Journal, recover_scheduler
from .scheduler import OnlineScheduler, SERVICE_POLICIES
from .traces import (
    default_cluster,
    default_job_types,
    read_trace_csv,
    synthetic_trace,
    write_trace_csv,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.service",
                                 description="Online event-driven OEF cluster service")
    ap.add_argument("--policy", choices=SERVICE_POLICIES, default="oef-noncoop")
    ap.add_argument("--replay", type=str, default=None,
                    help="CSV trace to replay (default: generate a synthetic one)")
    ap.add_argument("--cluster", choices=("paper", "tpu"), default="paper")
    ap.add_argument("--tenants", type=int, default=4, help="synthetic: tenant count")
    ap.add_argument("--duration", type=float, default=7200.0,
                    help="synthetic: arrival horizon in seconds")
    ap.add_argument("--until", type=float, default=None,
                    help="stop the replay clock at this time (default: drain)")
    ap.add_argument("--mean-interarrival", type=float, default=600.0)
    ap.add_argument("--mean-work", type=float, default=1800.0)
    ap.add_argument("--host-failures-per-hour", type=float, default=0.0)
    ap.add_argument("--resolve-interval", type=float, default=30.0,
                    help="re-solve throttle: min seconds between solves")
    ap.add_argument("--backend", choices=backends.backend_names(), default="torch",
                    help="registry backend for OEF re-solves (default torch: "
                         "the water-filling tier for oef-noncoop and the "
                         "primal-dual tier for oef-coop, on --device; numpy: "
                         "the numpy water-filling, or the LP for oef-coop; "
                         "lp: the scipy LP). Baseline policies ignore this")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve tier: cuda (default; "
                         "raises when torch sees no GPU) or cpu")
    ap.add_argument("--audit-every", type=int, default=10,
                    help="fairness-property audit every Nth solve (0 = off)")
    ap.add_argument("--chaos", action="store_true",
                    help="inject the standard seeded fault storm (host-burst "
                         "storms, corrupt profiles, solver faults on the "
                         "--backend chain; see "
                         "repro_torch.service.faults.standard_plan)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the chaos fault plan (with --chaos)")
    ap.add_argument("--journal", type=str, default=None,
                    help="journal directory: write-ahead event log + periodic "
                         "state snapshots; if it already holds a journal, the "
                         "run resumes from the latest snapshot (crash recovery)")
    ap.add_argument("--snapshot-every", type=int, default=50,
                    help="snapshot the full scheduler state every N journaled "
                         "events (with --journal)")
    ap.add_argument("--no-guardrails", action="store_true",
                    help="disable the robustness layer (solver escalation "
                         "ladder, retries, profile quarantine)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None, help="write JSON report here")
    ap.add_argument("--emit-trace", type=str, default=None,
                    help="write the (synthetic) trace as CSV and exit")
    ap.add_argument("--trace", type=str, default=None, metavar="OUT.json",
                    help="record spans and write a Chrome trace_event JSON "
                         "(load in Perfetto; see docs/observability.md)")
    ap.add_argument("--metrics", type=str, default=None, metavar="OUT.jsonl",
                    help="stream per-solve metric samples (counters/gauges/"
                         "histograms) to a JSONL file")
    ap.add_argument("--flame", action="store_true",
                    help="print a text flamegraph summary to stderr "
                         "(requires --trace)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    cluster = default_cluster(args.cluster)
    if args.replay:
        events = read_trace_csv(args.replay)
    else:
        events = synthetic_trace(
            args.tenants,
            job_types=default_job_types(args.cluster),
            cluster=cluster,
            duration_s=args.duration,
            mean_interarrival_s=args.mean_interarrival,
            mean_work_s=args.mean_work,
            host_failures_per_hour=args.host_failures_per_hour,
            seed=args.seed,
        )
    engine = None
    if args.chaos:
        engine = ChaosEngine(standard_plan(seed=args.chaos_seed), cluster)
        events = engine.chaos_trace(events)
    if args.emit_trace:
        write_trace_csv(events, args.emit_trace)
        print(f"wrote {len(events)} events -> {args.emit_trace}", file=sys.stderr)
        return 0
    journal = None
    sched = None
    if args.journal:
        if Journal(args.journal,
                   snapshot_every=args.snapshot_every).available_snapshots():
            sched, journal, n_applied = recover_scheduler(
                args.journal, snapshot_every=args.snapshot_every,
                device=args.device)
            tail = journal.events(journal.n_applied)
            events = list(tail) + list(events)[n_applied:]
            print(f"recovered from {args.journal}: {n_applied} events "
                  f"journaled, replaying {len(tail)}-event tail", file=sys.stderr)
        else:
            journal = Journal(args.journal, snapshot_every=args.snapshot_every)
    if sched is None:
        try:
            sched = OnlineScheduler(
                cluster,
                args.policy,
                min_resolve_interval_s=args.resolve_interval,
                audit_every=args.audit_every,
                solver_backend=args.backend,
                guardrails=not args.no_guardrails,
                device=args.device,
            )
        except ValueError as e:
            ap.error(str(e))
    tracer = None
    if args.trace:
        tracer = obs.Tracer()
        obs.set_tracer(tracer)
    sink = None
    if args.metrics:
        sink = obs.JsonlSink(args.metrics)
        obs.set_metrics(obs.MetricsRegistry(sink=sink))
    try:
        if engine is not None:
            # the chain the scheduler dispatches: a resumed run's comes from
            # its snapshot
            with engine.installed(backend=sched.solver_backend):
                report = sched.run(events, until=args.until, journal=journal)
        else:
            report = sched.run(events, until=args.until, journal=journal)
    finally:
        if tracer is not None:
            obs.set_tracer(None)
        if sink is not None:
            obs.set_metrics(None)
            sink.close()
        if journal is not None:
            journal.close()
    if tracer is not None:
        tracer.save(args.trace)
        print(f"trace -> {args.trace} ({len(tracer.spans)} spans, "
              f"{len(tracer.instants)} instants)", file=sys.stderr)
        if args.flame:
            print("\n".join(tracer.flame_lines()), file=sys.stderr)
    if sink is not None:
        print(f"metrics -> {args.metrics} ({sink.rows_written} samples)",
              file=sys.stderr)
    text = report.to_json()
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"report -> {args.out}", file=sys.stderr)
    else:
        print(text)
    backends_used = ", ".join(
        f"{b}={c}" for b, c in sorted(report.solver_backends.items())) or "n/a"
    reasons = "; ".join(sorted(report.fallback_reasons)) or "none"
    quarantines = sum(1 for e in report.quarantine_events
                      if e["action"] == "quarantine")
    print(
        f"solves={report.n_solves} (reused {report.n_reused_solves}) "
        f"backends: {backends_used} | lp-fallbacks={report.fallback_count} "
        f"({reasons}) | degraded={report.degraded_solves} "
        f"quarantines={quarantines} anomalies={sum(report.anomalies.values())}",
        file=sys.stderr)
    if engine is not None:
        print(f"chaos: {engine.summary()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
