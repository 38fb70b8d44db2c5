"""Carry state into the port from plain data.

The port shares no objects with the JAX package. These helpers rebuild the
port's own types from plain Python and numpy values, so a caller that holds
the JAX package's trace or allocation can hand the same inputs to both:

  - :func:`events_from_rows` — trace rows as tuples in ``TRACE_HEADER``'s
    schema ``(time, kind, tenant, job_id, payload)``;
  - :func:`allocation_from_arrays` — an :class:`Allocation` from its arrays,
    keeping ``meta["tau"]``, the water-filling warm-start hint.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .core.types import Allocation
from .service.events import Event, EventKind, TRACE_KINDS


def events_from_rows(rows: Iterable[Tuple[object, ...]]) -> List[Event]:
    """Build trace events from ``(time, kind, tenant, job_id, payload)`` rows.

    ``kind`` is an event-kind value such as ``"job_submit"``; ``payload`` is
    a dict or its JSON text. Internal kinds (predicted finishes, resolve
    timers) are rejected, as in a CSV replay.
    """
    events = []
    for time, kind, tenant, job_id, payload in rows:
        if isinstance(payload, str):
            payload = json.loads(payload)
        ev = Event(float(time), EventKind(kind), tenant=str(tenant),
                   job_id=str(job_id), payload=dict(payload))
        if ev.kind not in TRACE_KINDS:
            raise ValueError(f"trace rows contain internal event kind {ev.kind}")
        events.append(ev)
    return events


def allocation_from_arrays(X, W, m, rows: Sequence[str],
                           meta: Dict[str, object]) -> Allocation:
    """Build the port's :class:`Allocation`; ``meta`` (including ``tau``) is
    copied, with ``tau`` as a Python float so it seeds the warm start."""
    meta = dict(meta)
    if meta.get("tau") is not None:
        meta["tau"] = float(meta["tau"])
    return Allocation(X=np.array(X, dtype=np.float64), rows=tuple(rows),
                      W=np.array(W, dtype=np.float64),
                      m=np.array(m, dtype=np.float64), meta=meta)
