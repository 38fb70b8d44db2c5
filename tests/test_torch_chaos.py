"""The port's chaos engine and guardrails vs the JAX package's, on the CPU.

``repro_torch.service.faults`` is a copy of ``repro.service.faults`` whose
wrapper goes on the chain the service dispatches: the default chain (as the
JAX service dispatches) or a named one, such as the port's ``torch`` tier.
Held here:

  - merged traces: the same seeded plan over the same base events gives the
    same event list in both packages, exactly;
  - the numpy/LP default chain: a chaos replay's report (less its two
    wall-clock fields) and the engine's summary equal the JAX package's
    exactly;
  - the ``torch`` tier (on the CPU): every planned fault fires on it, the
    fault counters equal the JAX run's, and the decisions are within the
    5% rule that holds the tier's replays to the LP's (``chip_smoke.py``'s
    ``NUMPY_REL``);
  - each guardrail case of ``tests/test_chaos.py`` and the chaos cases of
    ``tests/test_obs.py`` again, on ``backend="torch", device="cpu"``;
  - a ``KernelError`` passes the wrapper, the dispatch and the scheduler.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro.service import OnlineScheduler as JScheduler
from repro.service import faults as jfaults
from repro.service import synthetic_trace as jsynthetic_trace
from repro.service.traces import default_cluster as jdefault_cluster
from repro_torch import interop, obs
from repro_torch.core import backends, oef, torch_solve
from repro_torch.core.backends import (BackendError, add_dispatch_hook, dispatch,
                                       register_backend, remove_dispatch_hook,
                                       unregister_backend)
from repro_torch.core.properties import audited_solver
from repro_torch.core.types import ClusterSpec
from repro_torch.kernels import KernelError
from repro_torch.service import (ChaosEngine, Event, EventKind, FaultPlan,
                                 OnlineScheduler, standard_plan)
from repro_torch.service.traces import default_cluster, validate_host_pairing
from torch_threads import one_thread

one_thread()

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
W2 = np.array([[1.0, 2.0], [1.0, 4.0]])
M2 = np.array([4.0, 4.0])
#: the tier's replays against the LP's: relative difference in solves,
#: finished jobs, events and total throughput (chip_smoke.py's NUMPY_REL)
LP_REL = 0.05


def _view(rep):
    """``tests/test_chaos.py``'s ``_view``: the report minus its two
    wall-clock latency fields, as repr (NaN != NaN under ==)."""
    d = dataclasses.asdict(rep)
    d.pop("resolve_latency_ms_mean")
    d.pop("resolve_latency_ms_p95")
    return repr(d)


def _rows(events):
    return [(e.time, e.kind.value, e.tenant, e.job_id, e.payload) for e in events]


def _keys(events):
    """Events as comparable rows (payloads by repr: NaN != NaN under ==)."""
    return [(e.time, e.kind.value, e.tenant, e.job_id, repr(e.payload)) for e in events]


def _base(n=6, seed=3, hfph=2.0):
    """A JAX-package trace on the paper cluster, and the same events in the
    port."""
    jbase = jsynthetic_trace(n, cluster=jdefault_cluster("paper"), duration_s=3600.0,
                             host_failures_per_hour=hfph, seed=seed)
    return jbase, interop.events_from_rows(_rows(jbase))


PLANS = {
    "standard0": standard_plan(0),
    "standard7": standard_plan(7),
    "journal7": FaultPlan(seed=7, storms=3, storm_size=3, corrupt_profiles=3,
                          solver_faults=()),
    "burst": FaultPlan(seed=1, storms=1, storm_size=3, storm_span_s=0.0,
                       corrupt_profiles=0, solver_faults=()),
    "spread": FaultPlan(seed=4, storms=4, storm_size=5, storm_span_s=120.0,
                        corrupt_profiles=5, corrupt_kinds=("stale", "zero")),
}


def _jplan(plan):
    return jfaults.FaultPlan(**dataclasses.asdict(plan))


# ---------------------------------------------------------------------------
# the engine against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PLANS))
def test_chaos_trace_matches_jax_package(name):
    plan = PLANS[name]
    jbase, base = _base()
    jeng = jfaults.ChaosEngine(_jplan(plan), jdefault_cluster("paper"))
    eng = ChaosEngine(plan, default_cluster("paper"))
    got, ref = eng.chaos_trace(base), jeng.chaos_trace(jbase)
    assert _keys(got) == _keys(ref)
    assert eng.stats == jeng.stats
    assert len(got) > len(base)
    assert validate_host_pairing([e for e in got if e.kind in (
        EventKind.HOST_FAIL, EventKind.HOST_RECOVER)]) == []


def test_chaos_same_timestamp_burst():
    _, base = _base(4, seed=5, hfph=0.0)
    trace = ChaosEngine(PLANS["burst"], default_cluster("paper")).chaos_trace(base)
    fails = [e for e in trace if e.kind == EventKind.HOST_FAIL]
    assert len(fails) == 3
    assert len({e.time for e in fails}) == 1


def test_chaos_trace_is_deterministic():
    _, base = _base(4, seed=5)
    t1 = ChaosEngine(standard_plan(9), default_cluster("paper")).chaos_trace(base)
    t2 = ChaosEngine(standard_plan(9), default_cluster("paper")).chaos_trace(base)
    assert _keys(t1) == _keys(t2)


@pytest.mark.parametrize("kw", ({"solver_faults": ((1, "meteor-strike"),)},
                                {"corrupt_kinds": ("nan", "gremlin")}),
                         ids=("solver_kind", "corrupt_kind"))
def test_plan_validation_raises_as_jax(kw):
    with pytest.raises(ValueError) as got:
        FaultPlan(**kw)
    with pytest.raises(ValueError) as ref:
        jfaults.FaultPlan(**kw)
    assert str(got.value) == str(ref.value)


def _chaos_runs(policy, plan, backend, n=6):
    jbase, base = _base(n)
    jeng = jfaults.ChaosEngine(_jplan(plan), jdefault_cluster("paper"))
    jtrace = jeng.chaos_trace(jbase)
    jsched = JScheduler(jdefault_cluster("paper"), policy, solver_max_retries=1)
    with jeng.installed():
        ref = jsched.run(list(jtrace))
    eng = ChaosEngine(plan, default_cluster("paper"))
    trace = eng.chaos_trace(base)
    sched = OnlineScheduler(default_cluster("paper"), policy, solver_max_retries=1,
                            solver_backend=backend, device="cpu")
    with eng.installed(backend=backend):
        got = sched.run(list(trace))
    return (jeng, ref), (eng, sched, got)


@pytest.mark.parametrize("policy", ("oef-coop", "oef-noncoop"))
@pytest.mark.parametrize("plan", ("standard0", "standard7"))
def test_default_chain_chaos_replay_matches_jax_package(policy, plan):
    (jeng, ref), (eng, _, got) = _chaos_runs(policy, PLANS[plan], None)
    assert _view(got) == _view(ref)
    assert eng.summary() == jeng.summary()
    assert got.solver_backends.get("chaos", 0) > 0


@pytest.mark.parametrize("policy", ("oef-coop", "oef-noncoop"))
@pytest.mark.parametrize("plan", ("standard0", "standard7"))
def test_torch_tier_chaos_counts_match_jax_package(policy, plan):
    """On the torch tier every planned fault fires on ``oef-*/torch``; the
    fault counters equal the JAX run's on its default chain, and the
    decisions are within the tier's 5% rule."""
    (jeng, ref), (eng, sched, got) = _chaos_runs(policy, PLANS[plan], "torch")
    s, js = eng.summary(), jeng.summary()
    assert s["solver_faults_fired"] == js["solver_faults_fired"] \
        == len(PLANS[plan].solver_faults)
    assert s["stats"] == js["stats"]
    assert set(s["attempts"]) == {f"{policy}/torch", f"{policy}/lp"}
    # the attempts that fell back past the wrapper: to the LP here, to the
    # previous default (the LP, or numpy for oef-noncoop) in the JAX run
    assert s["attempts"][f"{policy}/lp"] == sum(
        n for k, n in js["attempts"].items() if k != f"{policy}/chaos")
    assert got.degraded_solves == ref.degraded_solves
    assert got.quarantine_events == ref.quarantine_events
    assert got.anomalies == ref.anomalies
    assert set(got.solver_backends) == {"torch", "lp"}
    for x, y in ((got.n_solves, ref.n_solves), (got.jobs_finished, ref.jobs_finished),
                 (got.n_events, ref.n_events),
                 (sum(got.tenant_throughput.values()), sum(ref.tenant_throughput.values()))):
        assert abs(x - y) <= LP_REL * max(abs(y), 1.0)


# ---------------------------------------------------------------------------
# the wrapper on the named chain
# ---------------------------------------------------------------------------


def _registry():
    return dict(backends._REGISTRY), dict(backends._DEFAULT), list(backends._DISPATCH_HOOKS)


@pytest.mark.parametrize("backend", (None, "torch", "numpy", "lp"))
def test_installed_wraps_the_dispatched_chain_and_restores_it(backend):
    before = _registry()
    eng = ChaosEngine(FaultPlan(solver_faults=((0, "crash"),)), default_cluster("paper"))
    with eng.installed(backend=backend):
        assert _registry() != before
        for prog in ("oef-noncoop", "oef-coop"):
            name = backend if prog == "oef-noncoop" else oef.coop_backend(backend)
            spec = backends.resolve_backend(prog, name)
            assert spec.solver.__name__ == "solve_chaos"
            if name is None:
                assert spec.backend == "chaos"
    assert _registry() == before
    with pytest.raises(RuntimeError, match="inside"):
        with eng.installed(backend=backend):
            raise RuntimeError("inside")
    assert _registry() == before


@pytest.mark.parametrize("policy", ("oef-coop", "oef-noncoop"))
def test_no_planned_solver_faults_change_no_allocation(policy):
    _, base = _base(6)
    plan = FaultPlan(seed=7, storms=3, storm_size=3, corrupt_profiles=3, solver_faults=())
    trace = ChaosEngine(plan, default_cluster("paper")).chaos_trace(base)

    def run(install):
        sched = OnlineScheduler(default_cluster("paper"), policy, solver_max_retries=1,
                                solver_backend="torch", device="cpu")
        eng = ChaosEngine(plan, default_cluster("paper"))
        if not install:
            return sched, sched.run(list(trace))
        with eng.installed(backend="torch"):
            rep = sched.run(list(trace))
        assert eng.summary()["attempts"][f"{policy}/torch"] > 0
        return sched, rep

    (s1, plain), (s2, chaos) = run(False), run(True)
    assert _view(plain) == _view(chaos)
    assert s1.last_estimate == s2.last_estimate
    np.testing.assert_array_equal(s1._prev_alloc.X, s2._prev_alloc.X)


def test_wrapper_passes_a_kernel_error_through(monkeypatch):
    def broken(*_a):
        raise KernelError("waterfill_masses kernel launch failed: test")

    monkeypatch.setattr(torch_solve, "waterfill_masses", broken)
    monkeypatch.setattr(torch_solve, "fused_solve", lambda device, lanes: False)
    eng = ChaosEngine(FaultPlan(solver_faults=((5, "crash"),)), default_cluster("paper"))
    with eng.installed(backend="torch"):
        with pytest.raises(KernelError, match="launch failed"):
            dispatch("oef-noncoop", W2, M2, backend="torch", failsafe=True,
                     max_retries=1, device="cpu")
        _, base = _base(6)
        sched = OnlineScheduler(default_cluster("paper"), "oef-noncoop",
                                solver_backend="torch", device="cpu")
        with pytest.raises(KernelError, match="launch failed"):
            sched.run(list(base))
    assert eng.summary()["attempts"]["oef-noncoop/torch"] == 2


@pytest.mark.parametrize("kind,error", (("crash", RuntimeError),
                                        ("transient", BackendError),
                                        ("timeout", backends.SolveTimeout)))
def test_wrapper_raises_each_fault_on_the_torch_tier(kind, error):
    """The wrapper raises the planned fault at its index and delegates to
    the torch tier otherwise; through dispatch a transient fault is retried
    on the tier, a timeout or a crash falls back to the LP, degraded."""
    eng = ChaosEngine(FaultPlan(solver_faults=((0, kind), (1, kind))),
                      default_cluster("paper"))
    ref = dispatch("oef-noncoop", W2, M2, backend="torch", device="cpu")
    with eng.installed(backend="torch"):
        wrapper = backends.resolve_backend("oef-noncoop", "torch").solver
        with pytest.raises(error, match="chaos: injected"):
            wrapper(W2, M2, device="cpu")
        got = dispatch("oef-noncoop", W2, M2, backend="torch", device="cpu",
                       failsafe=True, max_retries=1)
        again = dispatch("oef-noncoop", W2, M2, backend="torch", device="cpu")
    assert eng.stats[kind] == 2
    if kind == "transient":
        assert got.meta["backend"] == "torch" and got.meta["retries"] == 1
        assert "degraded" not in got.meta
    else:
        assert got.meta["backend"] == "lp" and got.meta["degraded"] is True
        assert got.meta["fallback_from"] == "torch"
    assert again.meta["backend"] == "torch"
    np.testing.assert_array_equal(again.X, ref.X)


# ---------------------------------------------------------------------------
# twins of tests/test_chaos.py's guardrail cases, on the torch tier
# ---------------------------------------------------------------------------


def _torch_solve(W, m, device):
    return oef.solve_noncoop_waterfill_torch(W, m, device=device)


def test_transient_retry_recovers_without_degrading():
    calls = {"n": 0}

    @audited_solver
    def solve_flaky(W, m, device=None):
        calls["n"] += 1
        if calls["n"] < 3:
            raise BackendError("numerical blip", transient=True)
        return _torch_solve(W, m, device)

    register_backend("oef-noncoop", "test-flaky", solve_flaky, fallback="torch")
    try:
        alloc = dispatch("oef-noncoop", W2, M2, backend="test-flaky",
                         max_retries=2, device="cpu")
        assert alloc.meta["backend"] == "test-flaky"
        assert alloc.meta["retries"] == 2
        assert "degraded" not in alloc.meta
        assert calls["n"] == 3
    finally:
        unregister_backend("oef-noncoop", "test-flaky")


def test_exhausted_transient_retries_fall_through_degraded():
    @audited_solver
    def solve_always_transient(W, m):
        raise BackendError("never converges", transient=True)

    register_backend("oef-noncoop", "test-shaky", solve_always_transient,
                     fallback="torch")
    try:
        alloc = dispatch("oef-noncoop", W2, M2, backend="test-shaky",
                         max_retries=1, device="cpu")
        assert alloc.meta["backend"] == "torch"
        assert alloc.meta["fallback_from"] == "test-shaky"
        assert alloc.meta["degraded"] is True
    finally:
        unregister_backend("oef-noncoop", "test-shaky")


def test_failsafe_converts_crash_into_decline():
    @audited_solver
    def solve_crashy(W, m):
        raise RuntimeError("segfault-adjacent")

    register_backend("oef-noncoop", "test-crashy", solve_crashy, fallback="torch")
    try:
        with pytest.raises(RuntimeError):
            dispatch("oef-noncoop", W2, M2, backend="test-crashy", device="cpu")
        alloc = dispatch("oef-noncoop", W2, M2, backend="test-crashy",
                         failsafe=True, device="cpu")
        assert alloc.meta["backend"] == "torch"
        assert alloc.meta["degraded"] is True
        assert "RuntimeError" in alloc.meta["fallback_reason"]
    finally:
        unregister_backend("oef-noncoop", "test-crashy")


def test_time_budget_escalates_to_fallback():
    @audited_solver
    def solve_slow(W, m, device=None):
        time.sleep(0.5)  # repro: noqa[D104] — deliberately slow test double
        return _torch_solve(W, m, device)

    # the budget sits between the two tiers' latencies: slow blows it, the
    # torch tier answers a 2 x 2 instance inside it
    register_backend("oef-noncoop", "test-slow", solve_slow, fallback="torch")
    try:
        alloc = dispatch("oef-noncoop", W2, M2, backend="test-slow",
                         time_budget_s=0.25, device="cpu")
        assert alloc.meta["backend"] == "torch"
        assert alloc.meta["degraded"] is True
    finally:
        unregister_backend("oef-noncoop", "test-slow")
    register_backend("test-slow-nofb", "slow", solve_slow, default=True)
    try:
        with pytest.raises(BackendError, match="declined"):
            dispatch("test-slow-nofb", W2, M2, time_budget_s=0.25, device="cpu")
    finally:
        unregister_backend("test-slow-nofb", "slow")


def test_dispatch_hook_sees_the_torch_attempt():
    seen = []

    def hook(program, backend, W, m):
        seen.append((program, backend))

    add_dispatch_hook(hook)
    try:
        alloc = dispatch("oef-noncoop", W2, M2, backend="torch", device="cpu")
        assert seen == [("oef-noncoop", "torch")]
        assert alloc.meta["backend"] == "torch"
    finally:
        remove_dispatch_hook(hook)


_CLUSTER2 = ClusterSpec(types=("a", "b"), m=(8, 8))


def _join(t, name, speedup, jt="train"):
    return Event(t, EventKind.TENANT_JOIN, tenant=name, payload={
        "job_types": [{"name": jt, "speedup": list(speedup)}]})


def _submit(t, name, job_id, work=1e5, workers=2, jt="train"):
    return Event(t, EventKind.JOB_SUBMIT, tenant=name, job_id=job_id,
                 payload={"job_type": jt, "workers": workers, "total_work": work})


def _profile(t, name, speedup, jt="train"):
    return Event(t, EventKind.PROFILE_UPDATE, tenant=name,
                 payload={"job_type": jt, "speedup": list(speedup)})


def _sched(policy, **kw):
    return OnlineScheduler(_CLUSTER2, policy, min_resolve_interval_s=1.0,
                           solver_backend="torch", device="cpu", **kw)


def test_quarantine_cycle_nan_profile():
    trace = [
        _join(0.0, "good", (1.0, 2.0)), _submit(0.0, "good", "g0"),
        _join(0.0, "sick", (1.0, 3.0)), _submit(0.0, "sick", "s0"),
        _profile(100.0, "sick", (float("nan"), 3.0)),
        _profile(400.0, "sick", (1.0, 3.0)),
    ]
    sched = _sched("oef-coop")
    rep = sched.run(trace, until=800.0)
    acts = [(e["tenant"], e["action"]) for e in rep.quarantine_events]
    assert acts == [("sick", "quarantine"), ("sick", "release")]
    assert "non-finite" in rep.quarantine_events[0]["reason"]
    assert not sched.quarantined
    assert any(s.quarantined == 1 for s in sched.metrics.solves)
    assert sched.metrics.solves[-1].quarantined == 0
    assert set(sched.last_estimate) == {"good", "sick"}
    assert set(rep.solver_backends) == {"torch"}


def test_quarantine_wrong_length_and_nonpositive():
    trace = [
        _join(0.0, "t0", (1.0, 2.0)), _submit(0.0, "t0", "j0"),
        _profile(50.0, "t0", (1.0,)),
        _profile(200.0, "t0", (1.0, -2.0)),
        _profile(300.0, "t0", (1.0, 2.0)),
    ]
    rep = _sched("oef-noncoop").run(trace, until=600.0)
    assert [e["action"] for e in rep.quarantine_events] == ["quarantine", "release"]
    assert "entries" in rep.quarantine_events[0]["reason"]


def test_guardrails_off_means_no_quarantine():
    trace = [
        _join(0.0, "t0", (1.0, 2.0)), _submit(0.0, "t0", "j0"),
        _profile(50.0, "t0", (1.0,)),
    ]
    with pytest.raises(Exception):
        _sched("oef-noncoop", guardrails=False).run(trace, until=400.0)


def test_anomaly_guards_count_and_ignore():
    trace = [
        _join(0.0, "t0", (1.0, 2.0)), _submit(0.0, "t0", "j0"),
        Event(10.0, EventKind.HOST_FAIL, payload={"type": 0, "host": 0}),
        Event(20.0, EventKind.HOST_FAIL, payload={"type": 0, "host": 0}),
        Event(30.0, EventKind.HOST_RECOVER, payload={"type": 0, "host": 1}),
        Event(40.0, EventKind.HOST_FAIL, payload={"type": 7, "host": 0}),
        Event(50.0, EventKind.HOST_RECOVER, payload={"type": 0, "host": 0}),
    ]
    sched = _sched("oef-noncoop")
    rep = sched.run(trace, until=300.0)
    assert rep.anomalies == {"duplicate_host_fail": 1, "spurious_host_recover": 1,
                             "unknown_host": 1}
    assert not sched.down_hosts


def test_solver_floor_when_every_backend_declines():
    def total_outage(program, backend, W, m):
        raise BackendError("chaos: cluster-wide solver outage")

    trace = [
        _join(0.0, "t0", (1.0, 2.0)), _submit(0.0, "t0", "j0", work=500.0),
        _join(0.0, "t1", (1.0, 3.0)), _submit(0.0, "t1", "j1", work=500.0),
    ]
    sched = _sched("oef-noncoop")
    add_dispatch_hook(total_outage)
    try:
        rep = sched.run(trace, until=600.0)
    finally:
        remove_dispatch_hook(total_outage)
    assert rep.anomalies.get("solver_floor", 0) >= 1
    assert rep.solver_backends.get("last-known-good", 0) >= 1
    assert rep.degraded_solves == rep.n_solves
    assert rep.jobs_finished == 2


def test_floor_reuses_last_known_good_shares():
    calls = {"n": 0}

    def outage_after_first(program, backend, W, m):
        calls["n"] += 1
        if calls["n"] > 1:
            raise BackendError("late outage")

    trace = [
        _join(0.0, "t0", (1.0, 2.0)), _submit(0.0, "t0", "j0", work=1e4),
        _join(0.0, "t1", (1.0, 3.0)), _submit(0.0, "t1", "j1", work=1e4),
        _profile(100.0, "t0", (1.5, 2.0)),
    ]
    sched = _sched("oef-noncoop")
    add_dispatch_hook(outage_after_first)
    try:
        sched.run(trace, until=300.0)
    finally:
        remove_dispatch_hook(outage_after_first)
    good = next(s for s in sched.metrics.solves if not s.degraded)
    floored = [s for s in sched.metrics.solves if s.backend == "last-known-good"]
    assert good.backend == "torch" and floored
    assert sched._last_good is not None


@pytest.mark.parametrize("policy", ("oef-coop", "oef-noncoop"))
def test_standard_storm_completes_with_zero_unhandled_exceptions(policy):
    cluster = default_cluster("paper")
    _, base = _base(6, seed=3)
    engine = ChaosEngine(standard_plan(seed=7), cluster)
    trace = engine.chaos_trace(base)
    sched = OnlineScheduler(cluster, policy, solver_max_retries=1,
                            solver_backend="torch", device="cpu")
    with engine.installed(backend="torch"):
        rep = sched.run(list(trace))
    s = engine.summary()
    assert s["solver_faults_fired"] == len(standard_plan(seed=7).solver_faults)
    assert rep.degraded_solves >= s["stats"]["crash"] + s["stats"]["timeout"]
    assert any(e["action"] == "quarantine" for e in rep.quarantine_events)
    assert any(e["action"] == "release" for e in rep.quarantine_events)
    assert rep.solver_backends.get("torch", 0) > 0


def _chaos_setup():
    cluster = default_cluster("paper")
    _, base = _base(6, seed=3)
    engine = ChaosEngine(standard_plan(seed=7), cluster)
    return cluster, engine, engine.chaos_trace(base)


def test_tracing_does_not_perturb_a_chaos_replay():
    cluster, engine, trace = _chaos_setup()
    sched = OnlineScheduler(cluster, "oef-coop", solver_max_retries=1,
                            solver_backend="torch", device="cpu")
    with engine.installed(backend="torch"):
        plain = sched.run(list(trace))
    cluster2, engine2, trace2 = _chaos_setup()
    obs.set_tracer(obs.Tracer())
    obs.set_metrics(obs.MetricsRegistry())
    sched2 = OnlineScheduler(cluster2, "oef-coop", solver_max_retries=1,
                             solver_backend="torch", device="cpu")
    try:
        with engine2.installed(backend="torch"):
            traced = sched2.run(list(trace2))
    finally:
        obs.set_tracer(None)
        obs.set_metrics(None)
    assert _view(plain) == _view(traced)


def test_degraded_solves_match_guardrail_instants_exactly():
    cluster, engine, trace = _chaos_setup()
    tracer = obs.Tracer()
    obs.set_tracer(tracer)
    sched = OnlineScheduler(cluster, "oef-coop", solver_max_retries=1,
                            solver_backend="torch", device="cpu")
    try:
        with engine.installed(backend="torch"):
            rep = sched.run(list(trace))
    finally:
        obs.set_tracer(None)
    assert rep.degraded_solves > 0
    resolves = [(t0, t0 + dur) for (name, _c, _p, t0, dur, _s, _a)
                in tracer.spans if name == "resolve"]
    assert len(resolves) == rep.n_solves
    guard_ts = [t for (_n, cat, _p, t, _s, _a) in tracer.instants if cat == "guardrail"]
    flagged = sum(1 for (a, b) in resolves if any(a <= t <= b for t in guard_ts))
    assert flagged == rep.degraded_solves
    assert all(any(a <= t <= b for (a, b) in resolves) for t in guard_ts)


# ---------------------------------------------------------------------------
# the CLI and chip_smoke.py's phase 27, rehearsed
# ---------------------------------------------------------------------------


def test_cli_chaos_fires_every_fault_on_the_torch_tier(capsys):
    from repro_torch.service.__main__ import main as cli_main

    assert cli_main(["--device", "cpu", "--tenants", "6", "--duration", "3600",
                     "--chaos", "--host-failures-per-hour", "2", "--out",
                     os.devnull]) == 0
    err = capsys.readouterr().err
    assert "chaos: {" in err and "'solver_faults_fired': 5" in err
    assert "'oef-noncoop/torch'" in err and "'oef-noncoop/lp': 3" in err


def test_cli_chaos_without_a_gpu_raises(monkeypatch):
    from repro_torch.service.__main__ import main as cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--chaos", "--tenants", "2", "--duration", "600"])


def count_fused_launches(monkeypatch):
    """Route the solve tiers as on the card and count the fused kernels'
    launches in their plain versions (``chip_smoke.py`` rehearsals)."""
    from repro_torch.core import torch_coop
    from repro_torch.kernels import envy, waterfill

    solve, segment = torch_solve.waterfill_solve, torch_coop.pd_segment

    def counted_solve(*a, **k):
        waterfill.waterfill_solve.launches += 1
        return solve(*a, **k)

    def counted_segment(*a, **k):
        envy.pd_segment.launches += 1
        return segment(*a, **k)

    monkeypatch.setattr(torch_solve, "fused_solve",
                        lambda device, lanes: lanes <= waterfill.MAX_LANES)
    monkeypatch.setattr(torch_solve, "waterfill_solve", counted_solve)
    monkeypatch.setattr(torch_coop, "fused_segment",
                        lambda device, G: G <= envy.PD_FUSED_MAX_G)
    monkeypatch.setattr(torch_coop, "pd_segment", counted_segment)


def test_chip_smoke_chaos_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 27 on the CPU at cut sizes (64 and 32
    tenants), the fused solve counted in its plain version: every planned
    fault fires, the ladder is the plan's, the launches are the torch
    attempts that got past the wrapper, and the report reader lists both
    resolve stages."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    count_fused_launches(monkeypatch)
    monkeypatch.setattr(cs, "CHAOS_FULL", (64, 8, 3600.0))
    monkeypatch.setattr(cs, "CHAOS_SMALL", (32, 4, 7200.0))
    detail = {}
    launches = cs.chaos_phase(np, detail, dev="cpu")
    full = detail["chaos"]["full"]
    assert full["summary"]["solver_faults_fired"] == 5
    assert full["ladder"] == {"fallback_solves": 3, "degraded": 3}
    assert launches == full["summary"]["attempts"]["oef-noncoop/torch"] - 5 > 0
    assert detail["chaos"]["small"]["cpu"]["summary"] \
        == detail["chaos"]["small"]["cuda"]["summary"]
