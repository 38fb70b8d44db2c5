"""The observability clock — the one sanctioned wall-clock source.

Everything under ``repro_torch/service/`` and ``repro_torch/core/`` runs in *virtual*
(event / round) time; a stray ``time.time()`` that leaks into state or a
decision silently breaks bit-exact replay (analysis rules D104 and C306).
Telemetry still needs real durations, so wall-clock reads for spans, solve
latency and budgets are funnelled through this module: one place to audit,
and one seam tests can monkeypatch to make timing-dependent
code deterministic.

``wall()`` is a monotonic high-resolution timer (not epoch time): good for
durations and intra-process ordering, meaningless across processes.
"""
from __future__ import annotations

# This module is the wall-clock seam itself. repro.analysis runs every rule
# on paths outside its ``repro/`` scopes, so C306 sees this import too.
import time as _time  # repro: noqa[C306]

#: monotonic wall-clock read, seconds as float. Bound once so the hot path
#: (two reads per span) costs one global load + the C call.
wall = _time.perf_counter

#: epoch timestamp for export headers only — never for durations.
epoch = _time.time


def sleep(seconds: float) -> None:
    """Explicit pass-through, so control-plane code that genuinely must
    sleep (none today) still routes through the audited clock module."""
    _time.sleep(seconds)
