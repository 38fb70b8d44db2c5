"""Offline reader for obs artifacts: ``python -m repro_torch.obs report <files>``.

Accepts any mix of

  - Chrome trace JSON written by ``Tracer.save`` / ``--trace out.json``
    (detected by the top-level ``traceEvents`` key) — rebuilt into a span
    tree by time containment and summarized as a per-stage latency table
    (count / total / mean / p95 / self-time per span path);
  - metrics JSONL written by ``--metrics out.jsonl`` — summarized as final
    counter values, histogram digests, and a fairness-over-time table (one
    row per sample in which the ``service.audits`` counter advanced, i.e.
    per fairness audit).

Everything here is pure stdlib + already-parsed dicts; the heavy lifting
(nesting) is the same containment rule Perfetto uses for ``"ph": "X"``
events sharing one pid/tid.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# trace: rebuild span paths by containment
# ---------------------------------------------------------------------------

def load_chrome_trace(path: str) -> Dict[str, object]:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome trace (missing 'traceEvents')")
    return doc


def span_paths(doc: Dict[str, object]) -> List[Tuple[str, float, float]]:
    """Flatten ``"ph": "X"`` events into ``(path, ts_us, dur_us)`` rows,
    where ``path`` is the ``;``-joined ancestry recovered by containment:
    sorted by start (ties: longer first), an event is a child of the
    innermost open event whose interval contains its start."""
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    rows: List[Tuple[str, float, float]] = []
    stack: List[Tuple[str, float]] = []  # (path, end_ts)
    for e in events:
        ts, dur = float(e["ts"]), float(e["dur"])
        while stack and ts >= stack[-1][1] - 1e-9:
            stack.pop()
        path = stack[-1][0] + ";" + e["name"] if stack else e["name"]
        rows.append((path, ts, dur))
        stack.append((path, ts + dur))
    return rows


def stage_stats(rows: Sequence[Tuple[str, float, float]]
                ) -> Dict[str, Dict[str, float]]:
    """Aggregate path rows into per-stage stats (durations in ms)."""
    durs: Dict[str, List[float]] = {}
    for path, _ts, dur in rows:
        durs.setdefault(path, []).append(dur / 1e3)
    child_total: Dict[str, float] = {}
    totals = {p: sum(d) for p, d in durs.items()}
    for path, total in totals.items():
        if ";" in path:
            parent = path.rsplit(";", 1)[0]
            child_total[parent] = child_total.get(parent, 0.0) + total
    out: Dict[str, Dict[str, float]] = {}
    for path, d in durs.items():
        d_sorted = sorted(d)
        p95 = d_sorted[min(len(d_sorted) - 1, int(0.95 * (len(d_sorted) - 1) + 0.5))]
        out[path] = {
            "count": len(d),
            "total_ms": totals[path],
            "mean_ms": totals[path] / len(d),
            "p95_ms": p95,
            "self_ms": totals[path] - child_total.get(path, 0.0),
        }
    return out


def trace_report_lines(path: str) -> List[str]:
    doc = load_chrome_trace(path)
    rows = span_paths(doc)
    stats = stage_stats(rows)
    other = doc.get("otherData", {}) if isinstance(doc.get("otherData"), dict) else {}
    lines = [f"== per-stage latency breakdown ({path}) ==",
             f"{'count':>7}  {'total_ms':>10}  {'mean_ms':>9}  "
             f"{'p95_ms':>9}  {'self_ms':>10}  stage"]
    for p in sorted(stats, key=lambda p: (-stats[p]["total_ms"], p)):
        s = stats[p]
        lines.append(f"{s['count']:>7.0f}  {s['total_ms']:>10.2f}  "
                     f"{s['mean_ms']:>9.3f}  {s['p95_ms']:>9.3f}  "
                     f"{s['self_ms']:>10.2f}  {p}")
    n_inst = sum(1 for e in doc["traceEvents"] if e.get("ph") == "i")
    lines.append(f"spans: {len(rows)}  instants: {n_inst}  "
                 f"dropped: {other.get('dropped_events', 0)}  "
                 f"schema: {other.get('schema', '?')}")
    return lines


# ---------------------------------------------------------------------------
# metrics JSONL
# ---------------------------------------------------------------------------

def load_metrics_jsonl(path: str) -> List[Dict[str, object]]:
    rows: List[Dict[str, object]] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if not isinstance(row, dict) or "counters" not in row:
                raise ValueError(f"{path}:{i + 1}: not a metrics sample row")
            rows.append(row)
    return rows


#: gauges carried into the fairness-over-time table, in column order.
FAIRNESS_GAUGES = ("fairness.max_envy", "fairness.total_efficiency",
                   "fairness.min_si_slack")


def fairness_series(rows: Sequence[Dict[str, object]]
                    ) -> List[Dict[str, float]]:
    """One point per sample in which ``service.audits`` advanced — i.e. the
    fairness gauges were refreshed from a ``property_report`` audit."""
    out: List[Dict[str, float]] = []
    prev_audits = 0.0
    for row in rows:
        audits = float(row["counters"].get("service.audits", 0))
        if audits > prev_audits:
            point = {"t": float(row["t"]), "audits": audits}
            for g in FAIRNESS_GAUGES:
                if g in row["gauges"]:
                    point[g] = float(row["gauges"][g])
            out.append(point)
        prev_audits = audits
    return out


def metrics_report_lines(path: str) -> List[str]:
    rows = load_metrics_jsonl(path)
    lines = [f"== metrics summary ({path}; {len(rows)} samples) =="]
    if not rows:
        return lines + ["(empty)"]
    last = rows[-1]
    lines.append("-- counters (final) --")
    for name in sorted(last["counters"]):
        lines.append(f"  {name:<40} {last['counters'][name]:>12g}")
    lines.append("-- gauges (final) --")
    for name in sorted(last["gauges"]):
        lines.append(f"  {name:<40} {last['gauges'][name]:>12.6g}")
    hists = last.get("histograms", {})
    if hists:
        lines.append("-- histograms (windowed p50/p95) --")
        lines.append(f"  {'name':<40} {'count':>8}  {'mean':>9}  "
                     f"{'p50':>9}  {'p95':>9}  {'max':>9}  unit")
        for name in sorted(hists):
            h = hists[name]
            lines.append(f"  {name:<40} {h['count']:>8}  {h['mean']:>9.3f}  "
                         f"{h['p50']:>9.3f}  {h['p95']:>9.3f}  "
                         f"{h['max']:>9.3f}  {h.get('unit', '')}")
    series = fairness_series(rows)
    lines.append(f"-- fairness over time ({len(series)} audits) --")
    if series:
        cols = [g for g in FAIRNESS_GAUGES if g in series[0]]
        header = f"  {'t':>10}  {'audits':>7}"
        for g in cols:
            header += f"  {g.split('.', 1)[1]:>17}"
        lines.append(header)
        for pt in series:
            line = f"  {pt['t']:>10.2f}  {pt['audits']:>7.0f}"
            for g in cols:
                line += f"  {pt.get(g, float('nan')):>17.6g}"
            lines.append(line)
    else:
        lines.append("  (no audit samples — run the service with "
                     "--audit-every > 0 to populate this table)")
    return lines


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def classify(path: str) -> str:
    """'trace' | 'metrics', sniffed from the first non-space byte."""
    with open(path) as f:
        head = f.read(4096).lstrip()
    if head.startswith("{") and '"traceEvents"' in head:
        return "trace"
    return "metrics"


def report_lines(paths: Sequence[str]) -> List[str]:
    lines: List[str] = []
    for i, path in enumerate(paths):
        if i:
            lines.append("")
        kind = classify(path)
        if kind == "trace":
            lines.extend(trace_report_lines(path))
        else:
            lines.extend(metrics_report_lines(path))
    return lines
