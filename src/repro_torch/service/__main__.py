"""CLI for the online cluster service, solving on the GPU.

Replay a CSV trace (or generate a synthetic one) through the event-driven
OEF scheduler and emit JSON metrics. By default the policy is
``oef-noncoop`` and its re-solves run on the ``torch`` backend on
``--device cuda``:

    PYTHONPATH=src python -m repro_torch.service --tenants 4 --duration 7200
    PYTHONPATH=src python -m repro_torch.service --device cpu --tenants 4
    PYTHONPATH=src python -m repro_torch.service --replay trace.csv --policy gavel
    PYTHONPATH=src python -m repro_torch.service --emit-trace trace.csv --tenants 8
    PYTHONPATH=src python -m repro_torch.service --trace t.json --metrics m.jsonl

Exit code 0 on a completed replay; the JSON report goes to stdout (or
``--out``). ``--trace``/``--metrics`` write observability artifacts (Chrome
trace JSON for Perfetto, metrics JSONL) readable via
``python -m repro.obs report`` — see docs/observability.md. ``--device
cuda`` (the default) raises when torch sees no GPU.
"""
from __future__ import annotations

import argparse
import sys

from .. import obs
from ..core import backends
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
                         "the water-filling tier on --device; numpy: the "
                         "numpy water-filling; lp: the scipy LP). oef-coop has "
                         "no torch tier yet: pass numpy or lp with it. "
                         "Baseline policies ignore this")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve tier: cuda (default; "
                         "raises when torch sees no GPU) or cpu")
    ap.add_argument("--audit-every", type=int, default=10,
                    help="fairness-property audit every Nth solve (0 = off)")
    ap.add_argument("--chaos", action="store_true",
                    help="not available yet: the chaos engine is not ported")
    ap.add_argument("--journal", type=str, default=None,
                    help="not available yet: the crash-recovery journal is "
                         "not ported")
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
    if args.chaos or args.journal:
        ap.error("--chaos and --journal need the chaos engine and the journal "
                 "(service/faults.py, service/journal.py), which the torch "
                 "port does not have yet; use python -m repro.service for them")
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
    if args.emit_trace:
        write_trace_csv(events, args.emit_trace)
        print(f"wrote {len(events)} events -> {args.emit_trace}", file=sys.stderr)
        return 0
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
        report = sched.run(events, until=args.until)
    finally:
        if tracer is not None:
            obs.set_tracer(None)
        if sink is not None:
            obs.set_metrics(None)
            sink.close()
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
