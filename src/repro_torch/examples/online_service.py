"""Online cluster service walkthrough: generate a trace, replay it through
the event-driven OEF scheduler, dump + replay the CSV, and cross-validate
the steady state against the round simulator.

The twin of the JAX package's ``examples/online_service.py``, step for
step, with the scheduler's cooperative solves on the ``torch`` backend on
``--device`` (on the card fused PD segments of the envy-gap kernel).

Run:  PYTHONPATH=src python -m repro_torch.examples.online_service [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.profiler import paper_job_type
from repro_torch.core.simulator import SimJob, SimTenant
from repro_torch.core.torch_solve import resolve_device
from repro_torch.core.types import ClusterSpec
from repro_torch.service import (
    OnlineScheduler,
    read_trace_csv,
    synthetic_trace,
    write_trace_csv,
)
from repro_torch.service.scheduler import crossval_static
from repro_torch.service.traces import default_job_types


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Print the walkthrough; return ``{"events", "csv", "scheduler",
    "report", "crossval"}``: the trace, its CSV text, the replay's
    ``OnlineScheduler`` and ``ServiceReport`` and ``crossval_static``'s
    result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    cluster = ClusterSpec.paper_cluster()

    # 1. a Philly-like synthetic trace: 4 tenants, Poisson arrivals, one
    #    host outage per simulated hour on average
    events = synthetic_trace(
        4, job_types=default_job_types("paper"), cluster=cluster,
        duration_s=3600.0, mean_interarrival_s=400.0, mean_work_s=900.0,
        host_failures_per_hour=1.0, seed=0)
    print(f"trace: {len(events)} events over 1h")

    # 2. CSV round-trip (the replay adapter is bit-exact)
    with tempfile.TemporaryDirectory(prefix="oef-trace-") as d:
        path = os.path.join(d, "trace.csv")
        write_trace_csv(events, path)
        if read_trace_csv(path) != events:
            raise RuntimeError("the CSV round trip changed the trace")
        with open(path) as f:
            csv_text = f.read()
    print("csv round-trip ok")

    # 3. replay through the online scheduler, its coop solves on the device
    sched = OnlineScheduler(cluster, "oef-coop", min_resolve_interval_s=30.0,
                            audit_every=5, solver_backend="torch", device=dev)
    report = sched.run(events)
    print(f"replay on {dev}: {report.n_solves} solves ({report.n_reused_solves} reused), "
          f"{report.jobs_finished} jobs finished, mean JCT {report.mean_jct_s:.0f}s, "
          f"mean queue delay {report.mean_queue_delay_s:.0f}s, backends "
          f"{report.solver_backends}, {report.fallback_count} fallbacks, "
          f"{report.degraded_solves} degraded")
    for audit in report.fairness_audits[-1:]:
        print(f"last fairness audit @t={audit['time']:.0f}: "
              f"EF={audit['envy_free']} SI={audit['sharing_incentive']} "
              f"PE={audit['pareto_efficient']}")

    # 4. cross-validate against the round simulator on a static workload
    rng = np.random.default_rng(0)
    tenants = []
    for i, name in enumerate(("vgg", "lstm", "resnet")):
        jt = paper_job_type(name)
        tenants.append(SimTenant(
            name=f"tenant{i}", job_types={jt.name: jt},
            jobs=[SimJob(f"t{i}-j{q}", f"tenant{i}", jt.name,
                         int(rng.choice([1, 2, 4])), 1e9) for q in range(5)]))
    xv = crossval_static(tenants, cluster, "oef-coop", rounds=5,
                         solver_backend="torch", device=dev)
    print(f"cross-val vs round simulator: max rel err "
          f"{xv['max_rel_err']:.2e} (must be < 1%)")
    if not xv["max_rel_err"] < 0.01:
        raise RuntimeError(f"cross-validation error {xv['max_rel_err']:.2e} is not < 1%")
    return {"events": events, "csv": csv_text, "scheduler": sched, "report": report,
            "crossval": xv}


if __name__ == "__main__":
    main()
