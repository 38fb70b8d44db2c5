"""Zero-dependency span tracer with Chrome ``trace_event`` export.

One process-global :class:`Tracer` (installed via :func:`set_tracer`,
``None`` by default) records *spans* — named, nested intervals measured on
the :mod:`repro_torch.obs.clock` wall clock, each stamped with the scheduler's
sim-time when a sim clock is installed — and *instants* (point events such
as guardrail engagements). The control plane is instrumented with
:func:`span` at module level::

    from repro_torch.obs import trace as obs_trace

    with obs_trace.span("resolve", "service", sim=now, dirty=batch):
        ...

When no tracer is installed, :func:`span` returns a shared no-op context —
the disabled cost is one global load and a dict build, so instrumentation
can stay on the hot path permanently (the JAX package's
``benchmarks/obs_overhead.py`` measures the same code at <= 3% events/s).

Exports:
  - :meth:`Tracer.to_chrome` — the Chrome ``trace_event`` JSON dict
    (``{"traceEvents": [...]}``): complete (``"ph": "X"``) events in
    microseconds since tracer creation, instants as ``"ph": "i"``. Load the
    saved file in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.
  - :meth:`Tracer.flame_lines` — a text flamegraph: one line per distinct
    span *path* (``resolve;solve;dispatch;backend/torch;execute``) with call
    count, total/mean and self time (total minus direct children).

Memory is bounded: past ``max_events`` spans the tracer counts drops
instead of growing (the drop count lands in the export's ``otherData`` and
the flame summary — truncation is never silent).
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Tuple

from . import clock

#: schema tag written into the export so readers can detect drift.
CHROME_SCHEMA = "repro.obs.trace/v1"


class _NullSpan:
    """Shared no-op context returned when tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_sim", "_path")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, object]]) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        tr = self._tracer
        stack = tr._stack
        self._path = stack[-1] + ";" + self.name if stack else self.name
        stack.append(self._path)
        sim = tr.sim_clock
        self._sim = sim() if sim is not None else None
        self._t0 = clock.wall()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = clock.wall() - self._t0
        tr = self._tracer
        tr._stack.pop()
        tr._record(self.name, self.cat, self._path, self._t0, dur,
                   self._sim, self.args)
        return False


class Tracer:
    """Span/instant recorder for one run (single-threaded control plane)."""

    def __init__(self, *, max_events: int = 1_000_000) -> None:
        self.max_events = max_events
        #: completed spans: (name, cat, path, t0_wall, dur_s, sim_t, args).
        self.spans: List[Tuple] = []
        #: instant events: (name, cat, parent_path, t_wall, sim_t, args).
        self.instants: List[Tuple] = []
        self.dropped = 0
        #: aggregate counts from call sites too hot to span individually
        #: (e.g. stale predicted-finish pops in the scheduler's event loop);
        #: surfaced in :meth:`flame_lines` and the Chrome export's
        #: ``otherData`` so the elision is never silent.
        self.tallies: Dict[str, int] = {}
        self.sim_clock: Optional[Callable[[], float]] = None
        self._stack: List[str] = []
        self._t_zero = clock.wall()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, cat: str = "",
             args: Optional[Dict[str, object]] = None) -> _Span:
        return _Span(self, name, cat, args)

    def begin(self, name: str, cat: str = "",
              sim: Optional[float] = None) -> Tuple:
        """Open a span without the context-manager machinery (~2x cheaper;
        for per-event call sites in the scheduler's hot loop). Returns an
        opaque token; pass it to :meth:`end` in a ``finally`` block. Callers
        that already hold the sim-time pass it as ``sim`` to skip the
        sim-clock callback."""
        stack = self._stack
        path = stack[-1] + ";" + name if stack else name
        stack.append(path)
        if sim is None:
            sc = self.sim_clock
            if sc is not None:
                sim = sc()
        return (name, cat, path, sim, clock.wall())

    def end(self, token: Tuple) -> None:
        """Close a span opened with :meth:`begin` and record it."""
        t1 = clock.wall()
        name, cat, path, sim, t0 = token
        self._stack.pop()
        spans = self.spans
        if len(spans) < self.max_events:
            spans.append((name, cat, path, t0, t1 - t0, sim, None))
        else:
            self.dropped += 1

    def bump(self, name: str, n: int = 1) -> None:
        """Count an occurrence without recording a span. For event classes
        that dominate the loop but whose handling is a trivial early return
        (recording thousands of near-zero spans would blow the overhead
        budget); the tally is still exported, so nothing disappears."""
        self.tallies[name] = self.tallies.get(name, 0) + n

    def instant(self, name: str, cat: str = "",
                args: Optional[Dict[str, object]] = None) -> None:
        if len(self.instants) >= self.max_events:
            self.dropped += 1
            return
        sim = self.sim_clock() if self.sim_clock is not None else None
        parent = self._stack[-1] if self._stack else ""
        self.instants.append((name, cat, parent, clock.wall(), sim, args))

    def set_sim_clock(self, fn: Optional[Callable[[], float]]) -> None:
        """Install the virtual-time source (the scheduler's event clock) so
        every span carries sim-time alongside wall time."""
        self.sim_clock = fn

    def _record(self, name, cat, path, t0, dur, sim, args) -> None:
        if len(self.spans) >= self.max_events:
            self.dropped += 1
            return
        self.spans.append((name, cat, path, t0, dur, sim, args))

    # -- export ------------------------------------------------------------
    def chrome_events(self) -> List[Dict[str, object]]:
        t_zero = self._t_zero
        out: List[Dict[str, object]] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 1,
             "args": {"name": "repro-oef"}},
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
             "args": {"name": "control-plane"}},
        ]
        for name, cat, _path, t0, dur, sim, args in self.spans:
            a: Dict[str, object] = dict(args) if args else {}
            if sim is not None:
                a["sim_t"] = sim
            out.append({
                "name": name, "cat": cat or "span", "ph": "X",
                "ts": (t0 - t_zero) * 1e6, "dur": dur * 1e6,
                "pid": 1, "tid": 1, "args": a,
            })
        for name, cat, _parent, t, sim, args in self.instants:
            a = dict(args) if args else {}
            if sim is not None:
                a["sim_t"] = sim
            out.append({
                "name": name, "cat": cat or "instant", "ph": "i", "s": "t",
                "ts": (t - t_zero) * 1e6, "pid": 1, "tid": 1, "args": a,
            })
        return out

    def to_chrome(self) -> Dict[str, object]:
        return {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            "otherData": {"schema": CHROME_SCHEMA,
                          "dropped_events": self.dropped,
                          "tallies": dict(self.tallies)},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    # -- flamegraph summary ------------------------------------------------
    def flame_stats(self) -> Dict[str, Dict[str, float]]:
        """Per span-path aggregate: count, total_s, self_s (total minus
        direct children)."""
        agg: Dict[str, List[float]] = {}
        for _name, _cat, path, _t0, dur, _sim, _args in self.spans:
            st = agg.setdefault(path, [0, 0.0])
            st[0] += 1
            st[1] += dur
        child_total: Dict[str, float] = {}
        for path, (_c, total) in agg.items():
            if ";" in path:
                parent = path.rsplit(";", 1)[0]
                child_total[parent] = child_total.get(parent, 0.0) + total
        return {
            path: {"count": int(c), "total_s": total,
                   "self_s": total - child_total.get(path, 0.0)}
            for path, (c, total) in agg.items()
        }

    def flame_lines(self) -> List[str]:
        stats = self.flame_stats()
        lines = [f"{'count':>7}  {'total_ms':>10}  {'self_ms':>10}  path"]
        for path in sorted(stats, key=lambda p: (-stats[p]["total_s"], p)):
            s = stats[path]
            lines.append(f"{s['count']:>7}  {s['total_s'] * 1e3:>10.2f}  "
                         f"{s['self_s'] * 1e3:>10.2f}  {path}")
        for name in sorted(self.tallies):
            lines.append(f"{self.tallies[name]:>7}  {'-':>10}  {'-':>10}  "
                         f"{name} (tallied, not spanned)")
        if self.dropped:
            lines.append(f"(dropped {self.dropped} events past "
                         f"max_events={self.max_events})")
        return lines


# ---------------------------------------------------------------------------
# module-level tracer (the instrumentation surface)
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or with ``None`` remove) the process-global tracer; returns
    the previous one so callers can restore it."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def span(name: str, cat: str = "", **args):
    """Open a span on the installed tracer (shared no-op when disabled)."""
    tr = _TRACER
    if tr is None:
        return NULL_SPAN
    return tr.span(name, cat, args or None)


def instant(name: str, cat: str = "", **args) -> None:
    """Record a point event on the installed tracer (no-op when disabled)."""
    tr = _TRACER
    if tr is not None:
        tr.instant(name, cat, args or None)
