"""Crash-safe control plane: append-only event journal + state snapshots.

The online scheduler is a deterministic function of its event stream, so
crash recovery is replay: persist (a) every *external* event in the order it
was applied (``journal.jsonl``, written ahead of the state change) and (b) a
periodic full-state snapshot (``snap_<n>/state.json``, staged in ``.tmp`` and
committed with ``os.replace`` — the same atomic-commit convention as
:mod:`repro_torch.checkpoint.manager`). A restarted scheduler then

  1. rebuilds itself from the latest snapshot (:func:`recover_scheduler`) —
     tenants, jobs, placer deviation state, warm-start allocation, metrics,
     and the *internal* events (predicted JOB_FINISH, deferred RESOLVE) that
     were pending in the queue;
  2. replays the journal tail (external events applied after the snapshot)
     through the ordinary event loop — each replayed record is verified
     against the journal instead of re-appended;
  3. continues with the not-yet-applied remainder of the trace.

The result is bit-exact: the queue ordering invariant (externals carry lower
sequence numbers than every internal event, and snapshots store internals in
``(time, seq)`` order) means the recovered queue pops events in exactly the
pre-crash order, and every float crosses JSON via ``repr`` shortest-repr so
state round-trips without drift. ``tests/test_torch_journal.py`` kills a run
at its midpoint and asserts the resumed report equals the uninterrupted one.

The snapshot is the JAX package's (version 1, the same keys), so the
port's own state must fit in it: a restored scheduler is built for a
``device`` the caller names (default ``"cuda"``, through
``torch_solve.resolve_device``: a journal is never resumed on the CPU
unless asked), its solver-input cache is rebuilt on its first solve (a pure
function of the roster and the profiles), and the warm-start state in the
previous allocation's meta (``tau``, the cooperative tier's float64
``pd_state``) is numpy and crosses JSON exactly.

Nothing here depends on wall clock.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.placement import RoundingPlacer
from ..core.types import Allocation, ClusterSpec, JobTypeProfile
from ..obs import trace as obs_trace
from .events import Event, EventKind, EventQueue, TRACE_KINDS
from .metrics import MetricsCollector, ServiceReport, SolveRecord
from .scheduler import OnlineScheduler, ServiceJob, ServiceTenant

SNAP_RE = re.compile(r"^snap_(\d{8})$")


# ---------------------------------------------------------------------------
# JSON codecs (exact float round-trip: json emits repr shortest-repr)
# ---------------------------------------------------------------------------


def _json_default(o):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not journal-serializable: {type(o)!r}")


def _dumps_record(obj) -> str:
    # canonical form for journal lines so verify-mode replay compares equal
    return json.dumps(obj, sort_keys=True, default=_json_default)


def _dumps_state(obj) -> str:
    # snapshots must PRESERVE key order: dict insertion order (tenants, jobs,
    # jcts, delivered, ...) is part of the replay contract — float summation
    # order in the final report depends on it, and sort_keys would silently
    # reorder every dict on restore.
    return json.dumps(obj, default=_json_default)


def event_to_json(ev: Event) -> Dict[str, object]:
    return {"time": float(ev.time), "kind": ev.kind.value, "tenant": ev.tenant,
            "job_id": ev.job_id, "payload": ev.payload}


def event_from_json(d: Dict[str, object]) -> Event:
    return Event(float(d["time"]), EventKind(d["kind"]), tenant=d["tenant"],
                 job_id=d["job_id"], payload=dict(d["payload"]))


def _meta_to_json(meta: Dict[str, object]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in meta.items():
        if k == "pd_state" and isinstance(v, dict):
            out[k] = {kk: np.asarray(vv, dtype=np.float64).tolist()
                      for kk, vv in v.items()}
        elif k == "objective_bounds" and isinstance(v, (tuple, list)):
            out[k] = [float(x) for x in v]
        elif isinstance(v, (str, bool, int, float)) or v is None:
            out[k] = v
    return out


def _meta_from_json(d: Dict[str, object]) -> Dict[str, object]:
    out = dict(d)
    if "pd_state" in out:
        out["pd_state"] = {k: np.asarray(v, dtype=np.float64)
                           for k, v in out["pd_state"].items()}
    if "objective_bounds" in out:
        out["objective_bounds"] = tuple(out["objective_bounds"])
    return out


def _alloc_to_json(alloc: Optional[Allocation]) -> Optional[Dict[str, object]]:
    if alloc is None:
        return None
    return {"X": alloc.X.tolist(), "rows": list(alloc.rows),
            "W": alloc.W.tolist(), "m": alloc.m.tolist(),
            "meta": _meta_to_json(alloc.meta)}


def _alloc_from_json(d: Optional[Dict[str, object]]) -> Optional[Allocation]:
    if d is None:
        return None
    return Allocation(
        X=np.asarray(d["X"], dtype=np.float64), rows=tuple(d["rows"]),
        W=np.asarray(d["W"], dtype=np.float64),
        m=np.asarray(d["m"], dtype=np.float64),
        meta=_meta_from_json(d["meta"]))


def _assignment_to_json(a) -> Optional[List[List[int]]]:
    return None if a is None else [[int(j), int(h), int(c)] for j, h, c in a]


def _assignment_from_json(a, *, as_tuple: bool):
    if a is None:
        return None
    items = [(int(j), int(h), int(c)) for j, h, c in a]
    return tuple(items) if as_tuple else items


# ---------------------------------------------------------------------------
# scheduler state <-> snapshot dict
# ---------------------------------------------------------------------------


def scheduler_state(sched: OnlineScheduler, queue: Optional[EventQueue],
                    n_applied: int) -> Dict[str, object]:
    """Serialize the full scheduler state (insertion orders preserved —
    ``tenants``/``jobs`` iteration order is part of the replay contract)."""
    internals: List[Dict[str, object]] = []
    if queue is not None:
        for _, _, ev in sorted(queue._heap, key=lambda x: (x[0], x[1])):
            if ev.kind not in TRACE_KINDS:
                internals.append(event_to_json(ev))
    return {
        "version": 1,
        "n_applied": int(n_applied),
        "config": {
            "types": list(sched.cluster.types),
            "m": [int(x) for x in sched.cluster.m],
            "policy": sched.policy,
            "devices_per_host": sched.devices_per_host,
            "min_resolve_interval_s": sched.min_resolve_interval_s,
            "contention_penalty": sched.contention_penalty,
            "migration_overhead_s": sched.migration_overhead_s,
            "audit_every": sched.audit_every,
            "use_weighted_oef": sched.use_weighted_oef,
            "fast_noncoop": sched.fast_noncoop,
            "solver_backend": sched.solver_backend,
            "placer_mode": "naive" if sched.naive_placement else "optimized",
            "guardrails": sched.guardrails,
            "solver_max_retries": sched.solver_max_retries,
            "solver_time_budget_s": sched.solver_time_budget_s,
        },
        "tenants": [
            {"name": t.name,
             "job_types": [[name, {"speedup": [float(s) for s in jt.speedup],
                                   "min_demand": int(jt.min_demand)}]
                           for name, jt in t.job_types.items()],
             "weight": t.weight, "joined_at": t.joined_at, "left_at": t.left_at}
            for t in sched.tenants.values()
        ],
        "jobs": [
            {"job_id": j.job_id, "tenant": j.tenant, "job_type": j.job_type,
             "workers": j.workers, "total_work": j.total_work,
             "submit_time": j.submit_time, "done": j.done, "rate": j.rate,
             "resume_at": j.resume_at, "version": j.version,
             "assignment": _assignment_to_json(j.assignment),
             "starvation": j.starvation, "first_scheduled": j.first_scheduled,
             "finish_time": j.finish_time}
            for j in sched.jobs.values()
        ],
        "down_hosts": sorted([int(a), int(b)] for a, b in sched.down_hosts),
        "quarantined": sorted(sched.quarantined),
        "last_estimate": dict(sched.last_estimate),
        "last_good": None if sched._last_good is None else {
            "names": list(sched._last_good[0]),
            "ideal": np.asarray(sched._last_good[1]).tolist(),
            "est": np.asarray(sched._last_good[2]).tolist()},
        "placer": None if sched._placer is None else {
            "key": list(sched._placer_key),
            "n": sched._placer.n,
            "dev": sched._placer.dev.tolist()},
        "prev_alloc": _alloc_to_json(sched._prev_alloc),
        "prev_assignments": None if sched._prev_assignments is None else {
            job_id: _assignment_to_json(a)
            for job_id, a in sched._prev_assignments.items()},
        "running_jobs": [j.job_id for j in sched._running_jobs],
        "profile_epoch": sched._profile_epoch,
        "weighted_present": sched._weighted_present,
        "dirty": sched._dirty,
        "dirty_count": sched._dirty_count,
        "resolve_pending": sched._resolve_pending,
        "next_solve_ok": sched._next_solve_ok,
        "last_advance": sched._last_advance,
        "clock": sched._clock,
        "n_solves": sched._n_solves,
        "metrics": {
            "delivered": dict(sched.metrics.delivered),
            "joined_at": dict(sched.metrics.joined_at),
            "left_at": dict(sched.metrics.left_at),
            "jcts": dict(sched.metrics.jcts),
            "jct_tenant": dict(sched.metrics.jct_tenant),
            "queue_delays": dict(sched.metrics.queue_delays),
            "solves": [dataclasses.asdict(s) for s in sched.metrics.solves],
            "audits": sched.metrics.audits,
            "quarantine_log": sched.metrics.quarantine_log,
            "anomalies": dict(sched.metrics.anomalies),
            "n_events": sched.metrics.n_events,
        },
        "internals": internals,
    }


def restore_scheduler(state: Dict[str, object], *,
                      device=None) -> OnlineScheduler:
    """Rebuild an :class:`OnlineScheduler` at the snapshotted state, solving
    on ``device`` (default ``"cuda"``; it raises when torch sees no GPU)."""
    cfg = state["config"]
    cluster = ClusterSpec(types=tuple(cfg["types"]), m=tuple(cfg["m"]))
    sched = OnlineScheduler(
        cluster, cfg["policy"],
        devices_per_host=cfg["devices_per_host"],
        min_resolve_interval_s=cfg["min_resolve_interval_s"],
        contention_penalty=cfg["contention_penalty"],
        migration_overhead_s=cfg["migration_overhead_s"],
        audit_every=cfg["audit_every"],
        use_weighted_oef=cfg["use_weighted_oef"],
        fast_noncoop=cfg["fast_noncoop"],
        solver_backend=cfg["solver_backend"],
        placer_mode=cfg["placer_mode"],
        guardrails=cfg["guardrails"],
        solver_max_retries=cfg["solver_max_retries"],
        solver_time_budget_s=cfg["solver_time_budget_s"],
        device=device)
    # use_weighted_oef is policy-gated in the ctor; restore the exact flag
    sched.use_weighted_oef = cfg["use_weighted_oef"]

    for td in state["tenants"]:
        t = ServiceTenant(
            name=td["name"],
            job_types={name: JobTypeProfile(
                name=name, speedup=tuple(d["speedup"]),
                min_demand=int(d["min_demand"]))
                for name, d in td["job_types"]},
            weight=td["weight"], joined_at=td["joined_at"],
            left_at=td["left_at"])
        sched.tenants[t.name] = t
    for jd in state["jobs"]:
        sched.jobs[jd["job_id"]] = ServiceJob(
            job_id=jd["job_id"], tenant=jd["tenant"], job_type=jd["job_type"],
            workers=int(jd["workers"]), total_work=jd["total_work"],
            submit_time=jd["submit_time"], done=jd["done"], rate=jd["rate"],
            resume_at=jd["resume_at"], version=int(jd["version"]),
            assignment=_assignment_from_json(jd["assignment"], as_tuple=True),
            starvation=jd["starvation"], first_scheduled=jd["first_scheduled"],
            finish_time=jd["finish_time"])
    sched.down_hosts = {(int(a), int(b)) for a, b in state["down_hosts"]}
    sched.quarantined = set(state["quarantined"])
    sched.last_estimate = dict(state["last_estimate"])
    lg = state["last_good"]
    if lg is not None:
        sched._last_good = (tuple(lg["names"]),
                            np.asarray(lg["ideal"], dtype=np.float64),
                            np.asarray(lg["est"], dtype=np.float64))
    pl = state["placer"]
    if pl is not None:
        placer = RoundingPlacer(int(pl["n"]), sched.cluster.m,
                                sched.devices_per_host)
        placer.dev = np.asarray(pl["dev"], dtype=np.float64)
        sched._placer = placer
        sched._placer_key = tuple(pl["key"])
    sched._prev_alloc = _alloc_from_json(state["prev_alloc"])
    pa = state["prev_assignments"]
    if pa is not None:
        sched._prev_assignments = {
            job_id: _assignment_from_json(a, as_tuple=False)
            for job_id, a in pa.items()}
    sched._running_jobs = [sched.jobs[j] for j in state["running_jobs"]]
    sched._profile_epoch = int(state["profile_epoch"])
    sched._weighted_present = int(state["weighted_present"])
    sched._dirty = bool(state["dirty"])
    sched._dirty_count = int(state["dirty_count"])
    sched._resolve_pending = bool(state["resolve_pending"])
    sched._next_solve_ok = float(state["next_solve_ok"])
    sched._last_advance = float(state["last_advance"])
    sched._clock = float(state["clock"])
    sched._n_solves = int(state["n_solves"])

    mt = state["metrics"]
    m = MetricsCollector()
    m.delivered = dict(mt["delivered"])
    m.joined_at = dict(mt["joined_at"])
    m.left_at = dict(mt["left_at"])
    m.jcts = dict(mt["jcts"])
    m.jct_tenant = dict(mt["jct_tenant"])
    m.queue_delays = dict(mt["queue_delays"])
    m.solves = [SolveRecord(**s) for s in mt["solves"]]
    m.audits = list(mt["audits"])
    m.quarantine_log = list(mt["quarantine_log"])
    m.anomalies = dict(mt["anomalies"])
    m.n_events = int(mt["n_events"])
    sched.metrics = m
    return sched


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


class Journal:
    """Append-only external-event journal + periodic snapshots.

    Pass an instance to :meth:`OnlineScheduler.run`; it records each external
    event *before* the scheduler applies it (write-ahead) and snapshots the
    full state every ``snapshot_every`` records. During recovery the same
    ``record()`` path runs in *verify* mode against already-journaled lines,
    so tail replay is idempotent — a crash during recovery recovers again.
    """

    def __init__(self, directory: str, *, snapshot_every: int = 50) -> None:
        if snapshot_every <= 0:
            raise ValueError("snapshot_every must be positive")
        self.directory = directory
        self.snapshot_every = snapshot_every
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "journal.jsonl")
        self._lines: List[str] = []
        if os.path.exists(self.path):
            with open(self.path) as f:
                self._lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        self._cursor = 0  # records verified/written so far this process
        self._fh = None
        #: internal queue events restored from a snapshot, consumed by the
        #: scheduler when the run (re)starts.
        self.pending_internals: List[Event] = []

    # -- record / verify ---------------------------------------------------
    @property
    def n_recorded(self) -> int:
        """Total external events in the journal (pre-crash + this run)."""
        return len(self._lines)

    @property
    def n_applied(self) -> int:
        return self._cursor

    def record(self, ev: Event) -> None:
        with obs_trace.span("journal/append", "journal"):
            line = _dumps_record(event_to_json(ev))
            if self._cursor < len(self._lines):
                if self._lines[self._cursor] != line:
                    raise RuntimeError(
                        f"journal divergence at record {self._cursor}: replaying "
                        f"{line} over journaled {self._lines[self._cursor]} — "
                        f"the trace does not match the journaled run")
                self._cursor += 1
                return
            if self._fh is None:
                self._fh = open(self.path, "a")
            self._fh.write(line + "\n")
            self._fh.flush()
            self._lines.append(line)
            self._cursor += 1

    def events(self, start: int = 0, stop: Optional[int] = None) -> List[Event]:
        return [event_from_json(json.loads(ln))
                for ln in self._lines[start:stop]]

    # -- snapshots ---------------------------------------------------------
    def _snap_dir(self, n: int) -> str:
        return os.path.join(self.directory, f"snap_{n:08d}")

    def available_snapshots(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            match = SNAP_RE.match(name)
            if match and os.path.exists(
                    os.path.join(self.directory, name, "state.json")):
                out.append(int(match.group(1)))
        return sorted(out)

    def snapshot(self, sched: OnlineScheduler, queue: Optional[EventQueue],
                 *, n: Optional[int] = None) -> str:
        """Atomic snapshot at ``n`` applied events (.tmp + os.replace)."""
        n = self._cursor if n is None else n
        with obs_trace.span("journal/snapshot", "journal", n=n):
            final = self._snap_dir(n)
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "state.json"), "w") as f:
                f.write(_dumps_state(scheduler_state(sched, queue, n)))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        return final

    def load_snapshot(self, n: int) -> Dict[str, object]:
        with open(os.path.join(self._snap_dir(n), "state.json")) as f:
            return json.load(f)

    def ensure_initial(self, sched: OnlineScheduler,
                       queue: Optional[EventQueue]) -> None:
        if not self.available_snapshots():
            self.snapshot(sched, queue, n=0)

    def maybe_snapshot(self, sched: OnlineScheduler,
                       queue: Optional[EventQueue]) -> None:
        if self._cursor % self.snapshot_every == 0 \
                and self._cursor not in self.available_snapshots():
            self.snapshot(sched, queue)

    def take_restored_internals(self) -> List[Event]:
        out, self.pending_internals = self.pending_internals, []
        return out

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------


def recover_scheduler(directory: str,
                      *, snapshot_every: int = 50, device=None
                      ) -> Tuple[OnlineScheduler, Journal, int]:
    """Rebuild a crashed run from its journal directory, solving on
    ``device`` (default ``"cuda"``).

    Returns ``(sched, journal, n_applied)``: the scheduler at the latest
    snapshot, a journal primed for verified tail replay (its
    ``pending_internals`` carry the snapshotted queue), and the total number
    of external events the crashed run had applied. Feed
    ``journal.events(snapshot_n) + trace[n_applied:]`` back through
    ``sched.run(..., journal=journal)`` — or call :func:`resume_scheduler`.
    """
    with obs_trace.span("journal/recover", "journal"):
        journal = Journal(directory, snapshot_every=snapshot_every)
        snaps = journal.available_snapshots()
        if not snaps:
            raise FileNotFoundError(f"no snapshots under {directory!r}")
        snap_n = snaps[-1]
        if snap_n > journal.n_recorded:
            raise RuntimeError(
                f"snapshot {snap_n} is ahead of the journal "
                f"({journal.n_recorded} records) — directory corrupt")
        state = journal.load_snapshot(snap_n)
        sched = restore_scheduler(state, device=device)
        journal._cursor = snap_n  # tail records snap_n.. replay in verify mode
        journal.pending_internals = [
            event_from_json(d) for d in state["internals"]]
        return sched, journal, journal.n_recorded


def resume_scheduler(directory: str, events: Sequence[Event],
                     *, until: Optional[float] = None,
                     snapshot_every: int = 50, device=None) -> ServiceReport:
    """One-call crash recovery: replay the journal tail, then continue with
    the rest of ``events`` (the same full trace the crashed run was given),
    solving on ``device`` (default ``"cuda"``).

    The first ``n_applied`` events of ``events`` must be the ones the
    journal recorded (verified during tail replay); the remainder continues
    the run. Returns the final report — bit-identical to an uninterrupted
    ``run(events, until=until)`` of the original scheduler.
    """
    sched, journal, n_applied = recover_scheduler(
        directory, snapshot_every=snapshot_every, device=device)
    tail = journal.events(journal.n_applied)
    remaining = list(tail) + list(events)[n_applied:]
    try:
        return sched.run(remaining, until=until, journal=journal)
    finally:
        journal.close()
