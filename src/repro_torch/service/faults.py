"""Seeded chaos engine for the online service (deterministic fault injection).

A :class:`FaultPlan` describes *what* misbehaves; :class:`ChaosEngine`
compiles it into the two injection surfaces the service already has, so a
chaos run needs no monkey-patching and is bit-exact replayable from
``(plan, base trace)``:

  - **ordinary events** — :meth:`ChaosEngine.chaos_trace` merges correlated
    host fail/recover storms (``storm_span_s=0`` produces same-timestamp
    bursts) and corrupt ``PROFILE_UPDATE`` events (NaN / negative / zero /
    stale-length speedups, each followed by a repair update) into a base
    trace. Storm churn is pairing-aware: a storm never re-fails a host that
    the base trace (or an earlier storm) already has down — see
    :func:`repro_torch.service.traces.validate_host_pairing`;
  - **solver faults** — :meth:`ChaosEngine.installed` puts a wrapper on the
    backend chain the service dispatches, through
    :func:`repro_torch.core.backends.register_backend`: for the default chain
    a ``"chaos"`` backend becomes the temporary default of each wrapped
    program, with the previous default as its fallback; for a named chain
    (``OnlineScheduler(solver_backend="torch")``, the port's CLI default) the
    wrapper takes that backend's place under its name and keeps its
    fallback. The wrapper counts dispatches and, at the solve indices
    named by ``FaultPlan.solver_faults``, raises a transient
    :class:`~repro_torch.core.backends.BackendError`, a (virtual)
    :class:`~repro_torch.core.backends.SolveTimeout`, or an unexpected
    ``RuntimeError`` crash — driving every rung of the dispatch guardrail
    ladder deterministically, with no wall clock involved. A dispatch-level
    hook (:func:`repro_torch.core.backends.add_dispatch_hook`) counts per-backend
    attempts as cross-checkable telemetry.

Determinism: all randomness comes from ``numpy.default_rng(plan.seed)`` and
the engine's counters reset per instance, so constructing a fresh engine
from the same plan and replaying the same merged trace reproduces the run
bit-exactly (``tests/test_torch_chaos.py`` asserts this).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core import backends, oef
from ..core.backends import BackendError, SolveTimeout
from ..core.properties import audited_solver
from ..core.types import ClusterSpec
from .events import Event, EventKind
from .traces import validate_host_pairing

#: solver fault kinds -> which guardrail they exercise.
SOLVER_FAULT_KINDS = ("transient", "timeout", "crash")

#: corrupt-profile kinds -> how the speedup vector is poisoned.
CORRUPT_KINDS = ("nan", "negative", "zero", "stale")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A declarative, seed-keyed description of one chaos scenario.

    Everything is plain data (tuples, not dicts/arrays) so plans hash, print
    and compare — two runs with equal plans over equal base traces are
    bit-identical.
    """

    seed: int = 0
    #: injection window [start, end) for storms and corrupt profiles.
    window: Tuple[float, float] = (300.0, 3300.0)

    # -- correlated host fail/recover storms -------------------------------
    storms: int = 2
    #: hosts failing per storm (correlated failure, e.g. a rack/PDU event).
    storm_size: int = 3
    #: spread of fail times inside one storm; 0.0 = same-timestamp burst.
    storm_span_s: float = 0.0
    mean_outage_s: float = 900.0

    # -- corrupt profile updates ------------------------------------------
    #: number of (corrupt update, repair update) pairs to inject.
    corrupt_profiles: int = 2
    corrupt_kinds: Tuple[str, ...] = CORRUPT_KINDS
    #: delay from the corrupt update to its repairing valid update.
    repair_delay_s: float = 600.0

    # -- solver faults (dispatch-indexed) ----------------------------------
    #: ``(solve_index, kind)`` pairs; kind in :data:`SOLVER_FAULT_KINDS`.
    #: The index counts dispatches through the chaos wrapper backend.
    solver_faults: Tuple[Tuple[int, str], ...] = ((2, "transient"),
                                                  (4, "crash"),
                                                  (6, "timeout"))

    def __post_init__(self) -> None:
        for _, kind in self.solver_faults:
            if kind not in SOLVER_FAULT_KINDS:
                raise ValueError(f"unknown solver fault kind {kind!r}; "
                                 f"choose from {SOLVER_FAULT_KINDS}")
        for kind in self.corrupt_kinds:
            if kind not in CORRUPT_KINDS:
                raise ValueError(f"unknown corrupt-profile kind {kind!r}; "
                                 f"choose from {CORRUPT_KINDS}")


def standard_plan(seed: int = 0) -> FaultPlan:
    """The 'standard seeded fault storm' the acceptance criteria gate on."""
    return FaultPlan(
        seed=seed,
        window=(300.0, 3000.0),
        storms=3, storm_size=3, storm_span_s=0.0, mean_outage_s=600.0,
        corrupt_profiles=3, repair_delay_s=450.0,
        solver_faults=((1, "transient"), (3, "crash"), (5, "timeout"),
                       (8, "crash"), (11, "transient")),
    )


class ChaosEngine:
    """Compiles a :class:`FaultPlan` into events and a wrapper backend."""

    def __init__(self, plan: FaultPlan, cluster: ClusterSpec,
                 *, devices_per_host: int = 4) -> None:
        self.plan = plan
        self.cluster = cluster
        self.devices_per_host = devices_per_host
        self._solve_index = 0
        self._faults: Dict[int, str] = dict(plan.solver_faults)
        #: injection/observation counters, reset per engine instance.
        self.stats: Dict[str, int] = {
            "storm_fails": 0, "storm_skipped": 0, "corrupt_updates": 0,
            "repair_updates": 0, "transient": 0, "timeout": 0, "crash": 0,
        }
        self.attempts: Dict[Tuple[str, str], int] = {}

    # ------------------------------------------------------------------
    # event-stream injection
    # ------------------------------------------------------------------
    def chaos_trace(self, base_events: Sequence[Event]) -> List[Event]:
        """Merge the plan's storm + corrupt-profile events into a base trace.

        The merge is stable-sorted by time (ties: base events first, then
        injected events in generation order) and the combined stream keeps
        the HOST_FAIL/HOST_RECOVER pairing invariant.
        """
        rng = np.random.default_rng(self.plan.seed)
        injected = self._storm_events(base_events, rng)
        injected += self._corrupt_profile_events(base_events, rng)
        merged = list(base_events) + injected
        merged.sort(key=lambda e: e.time)  # stable
        bad = validate_host_pairing(
            [e for e in merged
             if e.kind in (EventKind.HOST_FAIL, EventKind.HOST_RECOVER)])
        if bad:
            raise RuntimeError(f"chaos merge broke host pairing: {bad}")
        return merged

    def _busy_intervals(
            self, events: Sequence[Event]
    ) -> Dict[Tuple[int, int], List[Tuple[float, float]]]:
        """Per-host [fail, recover) intervals already present in a stream."""
        busy: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
        open_at: Dict[Tuple[int, int], float] = {}
        for ev in sorted(events, key=lambda e: e.time):
            if ev.kind not in (EventKind.HOST_FAIL, EventKind.HOST_RECOVER):
                continue
            pair = (int(ev.payload["type"]), int(ev.payload["host"]))
            if ev.kind == EventKind.HOST_FAIL:
                open_at.setdefault(pair, ev.time)
            elif pair in open_at:
                busy.setdefault(pair, []).append((open_at.pop(pair), ev.time))
        for pair, t in open_at.items():
            busy.setdefault(pair, []).append((t, float("inf")))
        return busy

    def _storm_events(self, base_events: Sequence[Event],
                      rng: np.random.Generator) -> List[Event]:
        p = self.plan
        if p.storms <= 0 or p.storm_size <= 0:
            return []
        hosts: List[Tuple[int, int]] = []
        for j in range(self.cluster.k):
            n_hosts = int(np.ceil(int(self.cluster.m[j]) / self.devices_per_host))
            hosts.extend((j, h) for h in range(n_hosts))
        busy = self._busy_intervals(base_events)
        out: List[Event] = []
        lo, hi = p.window
        for _ in range(p.storms):
            start = float(rng.uniform(lo, hi))
            idx = rng.permutation(len(hosts))[: p.storm_size]
            for hi_idx in idx:
                pair = hosts[int(hi_idx)]
                t_fail = start if p.storm_span_s <= 0 else (
                    start + float(rng.uniform(0.0, p.storm_span_s)))
                t_rec = t_fail + float(rng.exponential(p.mean_outage_s))
                # pairing-aware: never re-fail a host that is already down
                # (base churn or an earlier storm) during [t_fail, t_rec)
                if any(a < t_rec and t_fail < b
                       for a, b in busy.get(pair, ())):
                    self.stats["storm_skipped"] += 1
                    continue
                busy.setdefault(pair, []).append((t_fail, t_rec))
                out.append(Event(t_fail, EventKind.HOST_FAIL,
                                 payload={"type": pair[0], "host": pair[1]}))
                out.append(Event(t_rec, EventKind.HOST_RECOVER,
                                 payload={"type": pair[0], "host": pair[1]}))
                self.stats["storm_fails"] += 1
        return out

    def _corrupt_profile_events(self, base_events: Sequence[Event],
                                rng: np.random.Generator) -> List[Event]:
        p = self.plan
        if p.corrupt_profiles <= 0:
            return []
        # tenants and their (valid) job-type vectors, from the base trace
        profiles: Dict[str, Dict[str, List[float]]] = {}
        for ev in base_events:
            if ev.kind == EventKind.TENANT_JOIN:
                profiles[ev.tenant] = {
                    d["name"]: [float(s) for s in d["speedup"]]
                    for d in ev.payload.get("job_types", [])}
        tenants = sorted(profiles)
        if not tenants:
            return []
        out: List[Event] = []
        lo, hi = p.window
        for i in range(p.corrupt_profiles):
            tname = tenants[i % len(tenants)]
            jt_names = sorted(profiles[tname])
            if not jt_names:
                continue
            jt = jt_names[int(rng.integers(len(jt_names)))]
            good = profiles[tname][jt]
            kind = p.corrupt_kinds[i % len(p.corrupt_kinds)]
            bad = list(good)
            slot = int(rng.integers(len(bad)))
            if kind == "nan":
                bad[slot] = float("nan")
            elif kind == "negative":
                bad[slot] = -abs(bad[slot]) or -1.0
            elif kind == "zero":
                bad[slot] = 0.0
            elif kind == "stale":
                bad = bad[:-1] if len(bad) > 1 else bad + [1.0]
            t = float(rng.uniform(lo, hi))
            out.append(Event(t, EventKind.PROFILE_UPDATE, tenant=tname,
                             payload={"job_type": jt, "speedup": bad}))
            out.append(Event(t + p.repair_delay_s, EventKind.PROFILE_UPDATE,
                             tenant=tname,
                             payload={"job_type": jt, "speedup": list(good)}))
            self.stats["corrupt_updates"] += 1
            self.stats["repair_updates"] += 1
        return out

    # ------------------------------------------------------------------
    # solver-fault injection (wrapper backend + dispatch hook)
    # ------------------------------------------------------------------
    def _fault_for(self, idx: int) -> Optional[str]:
        return self._faults.get(idx)

    def _make_chaos_solver(self, inner: backends.BackendSpec):
        engine = self

        @audited_solver
        def solve_chaos(W, m, *, iters: int = 80, tau_hint=None,
                        method: str = "highs", prev_state=None, device=None):
            # explicit keyword params (not **kw): dispatch filters kwargs by
            # signature, so a VAR_KEYWORD-only wrapper would receive nothing.
            # A KernelError of the inner solver passes through untouched.
            idx = engine._solve_index
            engine._solve_index += 1
            kind = engine._fault_for(idx)
            if kind == "transient":
                engine.stats["transient"] += 1
                raise BackendError(
                    f"chaos: injected transient fault at solve {idx}",
                    transient=True)
            if kind == "timeout":
                engine.stats["timeout"] += 1
                raise SolveTimeout(
                    f"chaos: injected (virtual) solve timeout at solve {idx}")
            if kind == "crash":
                engine.stats["crash"] += 1
                raise RuntimeError(
                    f"chaos: injected solver crash at solve {idx}")
            kw = {"iters": iters, "tau_hint": tau_hint, "method": method,
                  "prev_state": prev_state, "device": device}
            return inner.solver(
                W, m, **{k: v for k, v in kw.items() if k in inner.accepts})

        return solve_chaos

    def _attempt_hook(self, program: str, backend: str, W, m) -> None:
        key = (program, backend)
        self.attempts[key] = self.attempts.get(key, 0) + 1

    @contextlib.contextmanager
    def installed(
        self, programs: Sequence[str] = ("oef-noncoop", "oef-coop"),
        *, backend: Optional[str] = None,
    ) -> Iterator["ChaosEngine"]:
        """Put the chaos wrapper on the chain each program is dispatched on.

        ``backend`` is the service's ``solver_backend``: the chain that
        ``OnlineScheduler`` dispatches. With None (each program's default
        chain, as the JAX package's service dispatches) the wrapper is
        registered as ``"chaos"``, the temporary default, delegating to the
        previous default, which stays the fallback. A named chain is
        dispatched by name, so a ``"chaos"`` default would never be called:
        the wrapper takes the named backend's place under its name (for
        ``oef-coop``, the name ``oef.coop_backend`` maps it to) and
        delegates to it, keeping its instance class and fallback. With
        ``"torch"`` every planned fault fires on the torch tier and the
        attempts read ``oef-*/torch``.

        Either way the wrapper delegates to the backend it wraps, so a run
        with no solver faults planned is allocation-identical to an
        uninstalled run. Teardown restores the registry exactly; the
        attempt-counting dispatch hook is installed for the same scope.
        """
        targets = {prog: _dispatched_name(prog, backend) for prog in programs}
        prev_defaults = {prog: backends.default_backend(prog)
                         for prog, name in targets.items() if name is None}
        wrapped = {prog: backends.resolve_backend(prog, name)
                   for prog, name in targets.items() if name is not None}
        for prog, prev in prev_defaults.items():
            inner = backends.resolve_backend(prog, prev)
            backends.register_backend(
                prog, "chaos", self._make_chaos_solver(inner),
                instance_class=inner.instance_class, fallback=prev,
                default=True)
        for prog, inner in wrapped.items():
            _register_spec(inner, self._make_chaos_solver(inner))
        backends.add_dispatch_hook(self._attempt_hook)
        try:
            yield self
        finally:
            backends.remove_dispatch_hook(self._attempt_hook)
            for prog, prev in prev_defaults.items():
                backends.unregister_backend(prog, "chaos", new_default=prev)
            for inner in wrapped.values():
                _register_spec(inner, inner.solver)

    def summary(self) -> Dict[str, object]:
        """Injection + observation counters (JSON-safe)."""
        return {
            "stats": dict(self.stats),
            "attempts": {f"{p}/{b}": n
                         for (p, b), n in sorted(self.attempts.items())},
            "solver_faults_fired": (self.stats["transient"]
                                    + self.stats["timeout"]
                                    + self.stats["crash"]),
        }


def _dispatched_name(program: str, backend: Optional[str]) -> Optional[str]:
    """The backend name the service's dispatch of ``program`` starts at for
    its ``solver_backend``, or None for the program's default chain."""
    if program == "oef-coop":
        return oef.coop_backend(backend)
    return backend


def _register_spec(spec: backends.BackendSpec, solver) -> None:
    """(Re-)register ``solver`` under ``spec``'s program and name with its
    instance class and fallback; the program's default is left as it is."""
    backends.register_backend(spec.program, spec.backend, solver,
                              instance_class=spec.instance_class,
                              fallback=spec.fallback)
