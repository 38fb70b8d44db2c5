"""repro_torch.obs — deterministic tracing + streaming metrics for the control plane.

Three pieces, copied from the JAX package with their schemas unchanged (see
``docs/observability.md``):

  - :mod:`repro_torch.obs.trace` — process-global span tracer (sim-time + wall
    time), Chrome ``trace_event`` export and a text flamegraph;
  - :mod:`repro_torch.obs.metrics` — typed counters/gauges/histograms sampled
    periodically into JSONL;
  - :mod:`repro_torch.obs.report` / ``python -m repro_torch.obs report`` — the
    offline reader (per-stage latency breakdown, fairness-over-time table).

Layering rule: ``repro_torch.service`` and ``repro_torch.core`` import
``repro_torch.obs``, never the reverse — this package is stdlib+numpy only (no
torch, no solver imports) so it can wrap any tier without cycles. All
instrumentation is a no-op until a tracer/registry is installed
(``set_tracer``/``set_metrics``).
"""
from . import clock
from .metrics import (Counter, Gauge, Histogram, JsonlSink, MetricsRegistry,
                      SAMPLE_SCHEMA, get_metrics, set_metrics)
from .trace import (CHROME_SCHEMA, NULL_SPAN, Tracer, get_tracer, instant,
                    set_tracer, span)
from .util import json_safe, tally

__all__ = [
    "clock",
    "CHROME_SCHEMA", "NULL_SPAN", "Tracer", "get_tracer", "set_tracer",
    "span", "instant",
    "SAMPLE_SCHEMA", "Counter", "Gauge", "Histogram", "JsonlSink",
    "MetricsRegistry", "get_metrics", "set_metrics",
    "json_safe", "tally",
]
