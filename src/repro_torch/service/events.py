"""Deterministic event queue for the online cluster service.

Events are totally ordered by ``(time, seq)`` where ``seq`` is the push
order: two events at the same timestamp pop in the order they were pushed.
That makes every service run a pure function of the input trace — replaying
the same trace (same seed) yields bit-identical schedules, which the tests
assert.

External events (from a trace) and internal events (predicted job finishes,
deferred RESOLVE timers) share one queue. Predicted finishes are *lazily
invalidated*: each carries the job's rate ``version`` at prediction time and
is dropped on pop when the job has been re-solved since (the standard
event-driven-simulation technique — cheaper than heap deletion).
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


class EventKind(str, enum.Enum):
    TENANT_JOIN = "tenant_join"
    TENANT_LEAVE = "tenant_leave"
    JOB_SUBMIT = "job_submit"
    JOB_FINISH = "job_finish"  # internal: predicted completion (version-tagged)
    HOST_FAIL = "host_fail"
    HOST_RECOVER = "host_recover"
    PROFILE_UPDATE = "profile_update"
    RESOLVE = "resolve"  # internal: deferred re-solve timer (throttle)


# Kinds that may appear in an external trace (internal kinds are synthesized
# by the scheduler and never serialized).
TRACE_KINDS = (
    EventKind.TENANT_JOIN,
    EventKind.TENANT_LEAVE,
    EventKind.JOB_SUBMIT,
    EventKind.HOST_FAIL,
    EventKind.HOST_RECOVER,
    EventKind.PROFILE_UPDATE,
)


@dataclasses.dataclass(frozen=True)
class Event:
    """One world change at an instant.

    ``payload`` carries kind-specific fields and must stay JSON-serializable
    (lists, not tuples) so traces round-trip through CSV exactly:
      - TENANT_JOIN:    {"weight": float, "job_types": [{"name", "speedup",
                         "min_demand"}]}
      - JOB_SUBMIT:     {"job_type": str, "workers": int, "total_work": float}
      - HOST_FAIL/RECOVER: {"type": int, "host": int}
      - PROFILE_UPDATE: {"job_type": str, "speedup": [float]}
      - JOB_FINISH (internal): {"version": int}
    """

    time: float
    kind: EventKind
    tenant: str = ""
    job_id: str = ""
    payload: Dict[str, object] = dataclasses.field(default_factory=dict)


class EventQueue:
    """Min-heap of events keyed ``(time, seq)``; push order breaks time ties."""

    def __init__(self, events: Optional[Iterable[Event]] = None) -> None:
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = 0
        if events is not None:
            for ev in events:
                self.push(ev)

    def push(self, ev: Event) -> None:
        heapq.heappush(self._heap, (ev.time, self._seq, ev))
        self._seq += 1

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        while self._heap:
            yield self.pop()
