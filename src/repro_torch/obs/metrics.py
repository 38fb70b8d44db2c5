"""Streaming metrics: typed counters/gauges/histograms + JSONL samples.

The instruments are deliberately boring and allocation-free on the observe
path:

  - :class:`Counter` — monotone float/int accumulator;
  - :class:`Gauge`   — last-value instrument;
  - :class:`Histogram` — fixed bucket edges (no dynamic rebinning), integer
    bucket counts, plus a preallocated ring buffer of recent raw values so
    samples can report *windowed* p50/p95 without keeping every observation.

A :class:`MetricsRegistry` owns the instruments and turns them into periodic
time-series samples: :meth:`MetricsRegistry.sample` snapshots every
instrument into one JSON-serializable row stamped with *sim time* and writes
it to the attached sink (``--metrics out.jsonl`` on the service CLI attaches
a :class:`JsonlSink`); with no sink the rows accumulate on
``registry.samples`` for tests and in-process readers. Rows are
self-describing — ``schema``, ``units`` — and parsed back by
``python -m repro.obs report``, which reads the same schema.

Like the tracer, the registry is installed process-globally
(:func:`set_metrics`) and everything degrades to a no-op when absent.
"""
from __future__ import annotations

import json
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

from .util import json_safe

#: one JSONL row schema tag, bumped on breaking changes.
SAMPLE_SCHEMA = "repro.obs.metrics/v1"

#: default latency bucket edges, milliseconds (last bucket is overflow).
LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0)

#: ring-buffer length for windowed quantiles.
WINDOW = 256


class Counter:
    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = "1") -> None:
        self.name = name
        self.unit = unit
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = "") -> None:
        self.name = name
        self.unit = unit
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram + ring buffer of the last ``window`` values.

    ``observe`` is allocation-free: a bisect into the static edge tuple, two
    integer bumps, and a slot write into the preallocated ring. Quantiles
    are computed only at sample time, over the ring window.
    """

    __slots__ = ("name", "unit", "edges", "counts", "count", "total",
                 "_ring", "_n")

    def __init__(self, name: str, unit: str = "ms",
                 edges: Sequence[float] = LATENCY_BUCKETS_MS,
                 window: int = WINDOW) -> None:
        if list(edges) != sorted(edges) or len(edges) < 1:
            raise ValueError(f"histogram edges must be sorted/non-empty: {edges!r}")
        if window < 1:
            raise ValueError("window must be >= 1")
        self.name = name
        self.unit = unit
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.total = 0.0
        self._ring: List[float] = [0.0] * window
        self._n = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.edges, v)] += 1
        self.count += 1
        self.total += v
        ring = self._ring
        ring[self._n % len(ring)] = v
        self._n += 1

    def window_values(self) -> List[float]:
        """The (unordered) retained window — last ``len(ring)`` observations."""
        if self._n >= len(self._ring):
            return list(self._ring)
        return self._ring[:self._n]

    @staticmethod
    def _quantile(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
        return sorted_vals[idx]

    def snapshot(self) -> Dict[str, object]:
        win = sorted(self.window_values())
        return {
            "unit": self.unit,
            "count": self.count,
            "mean": self.total / self.count if self.count else 0.0,
            "p50": self._quantile(win, 0.50),
            "p95": self._quantile(win, 0.95),
            "max": win[-1] if win else 0.0,
            "buckets": list(self.edges),
            "counts": list(self.counts),
        }


class JsonlSink:
    """Append metric sample rows to a JSONL file, one flushed line each."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh = open(path, "w")
        self.rows_written = 0

    def write(self, row: Dict[str, object]) -> None:
        self._fh.write(json.dumps(json_safe(row), sort_keys=True) + "\n")
        self.rows_written += 1

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class MetricsRegistry:
    """Instrument factory + periodic sampler.

    Instruments are created lazily by name (``registry.counter("x").inc()``)
    and live for the registry's lifetime; ``sample(t)`` snapshots them all
    into one row at sim-time ``t``.
    """

    def __init__(self, sink: Optional[JsonlSink] = None) -> None:
        self.sink = sink
        self.samples: List[Dict[str, object]] = []  # retained when no sink
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._seq = 0
        # rebuilt on new instrument: units map + sorted name orders, so
        # sample() does no sorting in the steady state
        self._units: Optional[Dict[str, str]] = None
        self._order: Optional[Tuple[List[str], List[str], List[str]]] = None

    # -- instrument accessors (get-or-create) ------------------------------
    def counter(self, name: str, unit: str = "1") -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, unit)
            self._units = self._order = None
        return c

    def gauge(self, name: str, unit: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, unit)
            self._units = self._order = None
        return g

    def histogram(self, name: str, unit: str = "ms",
                  edges: Sequence[float] = LATENCY_BUCKETS_MS) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name, unit, edges)
            self._units = self._order = None
        return h

    # -- sampling ----------------------------------------------------------
    def units(self) -> Dict[str, str]:
        if self._units is None:
            out = {c.name: c.unit for c in self._counters.values()}
            out.update({g.name: g.unit for g in self._gauges.values()})
            out.update({h.name: h.unit for h in self._hists.values()})
            self._units = out
        return self._units

    def sample(self, t: float) -> Dict[str, object]:
        """Snapshot every instrument into one row at sim-time ``t``; write it
        to the sink (or retain it on ``samples``). Returns the row."""
        if self._order is None:
            self._order = (sorted(self._counters), sorted(self._gauges),
                           sorted(self._hists))
        c_names, g_names, h_names = self._order
        row: Dict[str, object] = {
            "schema": SAMPLE_SCHEMA,
            "seq": self._seq,
            "t": float(t),
            "counters": {n: self._counters[n].value for n in c_names},
            "gauges": {n: self._gauges[n].value for n in g_names},
            "histograms": {n: self._hists[n].snapshot() for n in h_names},
            # copy: the cached units dict must not be shared by retained rows
            "units": dict(self.units()),
        }
        self._seq += 1
        if self.sink is not None:
            self.sink.write(row)
        else:
            self.samples.append(row)
        return row


# ---------------------------------------------------------------------------
# module-level registry (the instrumentation surface)
# ---------------------------------------------------------------------------

_METRICS: Optional[MetricsRegistry] = None


def get_metrics() -> Optional[MetricsRegistry]:
    return _METRICS


def set_metrics(registry: Optional[MetricsRegistry]) -> Optional[MetricsRegistry]:
    """Install (or with ``None`` remove) the process-global registry;
    returns the previous one so callers can restore it."""
    global _METRICS
    prev, _METRICS = _METRICS, registry
    return prev
