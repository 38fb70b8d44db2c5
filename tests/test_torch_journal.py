"""The port's crash-recovery journal vs the JAX package's, on the CPU.

``repro_torch.service.journal`` is a copy of ``repro.service.journal`` with
a ``device`` for the restored scheduler (default ``cuda``). Held here:

  - on the numpy/LP default chain, the journal's records and every snapshot
    equal the JAX package's exactly (the snapshot keeps version 1 and JAX's
    keys; the port's ``SolveRecord`` adds ``warm_started`` and
    ``pd_iters``, and ``latency_s`` is wall time, so those three are set
    aside);
  - on the ``torch`` tier, coop and non-coop: journaling does not perturb a
    run, and a run killed at its midpoint and resumed is bit for bit the
    uninterrupted one (the reports less their two wall-clock fields, as
    ``tests/test_chaos.py``'s ``_view``); the warm-start state (``tau``,
    the coop tier's float64 ``pd_state``) crosses JSON exactly;
  - the recovery internals, divergence detection and atomic snapshots of
    ``tests/test_chaos.py``; the CLI's ``--journal``; no resume on ``cuda``
    without a GPU.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.service import OnlineScheduler as JScheduler
from repro.service import faults as jfaults
from repro.service import journal as jjournal
from repro.service import synthetic_trace as jsynthetic_trace
from repro.service.traces import default_cluster as jdefault_cluster
from repro_torch import interop
from repro_torch.service import (ChaosEngine, EventKind, FaultPlan, Journal,
                                 OnlineScheduler, recover_scheduler,
                                 resume_scheduler)
from repro_torch.service import journal as tjournal
from repro_torch.service.__main__ import main as cli_main
from repro_torch.service.traces import default_cluster
from torch_threads import one_thread

one_thread()

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
#: tests/test_chaos.py's journal plan: trace-level chaos only (solver faults
#: are the process's state, not the journal's)
PLAN = dict(seed=7, storms=3, storm_size=3, corrupt_profiles=3, solver_faults=())
#: fields of a snapshot's solve records that are not the JAX package's
#: (wall time, and the two the port's SolveRecord adds)
NOT_JAX = ("latency_s", "warm_started", "pd_iters")


def _view(rep):
    d = dataclasses.asdict(rep)
    d.pop("resolve_latency_ms_mean")
    d.pop("resolve_latency_ms_p95")
    return repr(d)


def _traces(n=6, seed=3):
    jbase = jsynthetic_trace(n, cluster=jdefault_cluster("paper"), duration_s=3600.0,
                             host_failures_per_hour=2.0, seed=seed)
    jtrace = jfaults.ChaosEngine(jfaults.FaultPlan(**PLAN),
                                 jdefault_cluster("paper")).chaos_trace(jbase)
    base = interop.events_from_rows(
        [(e.time, e.kind.value, e.tenant, e.job_id, e.payload) for e in jbase])
    trace = ChaosEngine(FaultPlan(**PLAN), default_cluster("paper")).chaos_trace(base)
    return jtrace, trace


def _mid(trace):
    times = sorted(e.time for e in trace)
    return times[len(times) // 2]


def _run(trace, policy, backend="torch", jdir=None, until=None, snapshot_every=10):
    sched = OnlineScheduler(default_cluster("paper"), policy, solver_max_retries=1,
                            solver_backend=backend, device="cpu")
    journal = Journal(jdir, snapshot_every=snapshot_every) if jdir else None
    try:
        return sched, sched.run(list(trace), until=until, journal=journal)
    finally:
        if journal is not None:
            journal.close()


def _strip(state):
    state = json.loads(json.dumps(state))
    for s in state["metrics"]["solves"]:
        for k in NOT_JAX:
            s.pop(k, None)
    return state


POLICIES = ("oef-coop", "oef-noncoop")


@pytest.mark.parametrize("policy", POLICIES)
def test_snapshots_and_records_match_jax_package(policy, tmp_path):
    jtrace, trace = _traces()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsched = JScheduler(jdefault_cluster("paper"), policy, solver_max_retries=1)
    jj = jjournal.Journal(jdir, snapshot_every=10)
    try:
        jsched.run(list(jtrace), journal=jj)
    finally:
        jj.close()
    sched, _ = _run(trace, policy, backend=None, jdir=tdir)
    with open(os.path.join(jdir, "journal.jsonl")) as a, \
            open(os.path.join(tdir, "journal.jsonl")) as b:
        assert a.read() == b.read()
    tj = Journal(tdir, snapshot_every=10)
    snaps = tj.available_snapshots()
    assert snaps == jjournal.Journal(jdir, snapshot_every=10).available_snapshots()
    assert len(snaps) > 3
    for n in snaps:
        with open(os.path.join(jdir, f"snap_{n:08d}", "state.json")) as f:
            ref = json.load(f)
        got = tj.load_snapshot(n)
        assert got["version"] == ref["version"] == 1
        assert list(got) == list(ref)
        assert _strip(got) == _strip(ref)
    final = tjournal.scheduler_state(sched, None, tj.n_recorded)
    jfinal = jjournal.scheduler_state(jsched, None, tj.n_recorded)
    assert _strip(final) == _strip(jfinal)


@pytest.mark.parametrize("policy", POLICIES)
def test_journaling_does_not_perturb_the_run(policy, tmp_path):
    _, trace = _traces()
    _, plain = _run(trace, policy)
    _, journaled = _run(trace, policy, jdir=str(tmp_path / "j"))
    assert _view(plain) == _view(journaled)
    assert set(plain.solver_backends) == {"torch"}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n,seed", ((6, 3), (8, 11)))
def test_kill_at_midpoint_resume_is_bit_exact_on_the_torch_tier(policy, n, seed, tmp_path):
    _, trace = _traces(n, seed)
    _, ref = _run(trace, policy, jdir=str(tmp_path / "ref"))
    crash = str(tmp_path / "crash")
    _run(trace, policy, jdir=crash, until=_mid(trace))
    snaps = Journal(crash, snapshot_every=10).available_snapshots()
    assert snaps and snaps[0] == 0
    resumed = resume_scheduler(crash, list(trace), snapshot_every=10, device="cpu")
    assert _view(ref) == _view(resumed)
    assert set(ref.solver_backends) == {"torch"}


@pytest.mark.parametrize("policy", POLICIES)
def test_warm_start_state_crosses_json_exactly(policy, tmp_path):
    _, trace = _traces()
    jdir = str(tmp_path / "j")
    sched, _ = _run(trace, policy, jdir=jdir, until=_mid(trace))
    state = json.loads(tjournal._dumps_state(
        tjournal.scheduler_state(sched, None, 0)))
    restored = tjournal.restore_scheduler(state, device="cpu")
    a, b = sched._prev_alloc, restored._prev_alloc
    for name in ("X", "W", "m"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    if policy == "oef-coop":
        pd, pd_back = a.meta["pd_state"], b.meta["pd_state"]
        assert set(pd) == set(pd_back) == {"Wd", "x", "p", "L"}
        for k in pd:
            assert isinstance(pd[k], np.ndarray) and pd[k].dtype == np.float64
            assert pd_back[k].dtype == np.float64
            np.testing.assert_array_equal(pd[k], pd_back[k])
    else:
        assert isinstance(a.meta["tau"], float) and b.meta["tau"] == a.meta["tau"]
    assert restored.device.type == "cpu"
    assert restored._solver_cache is None  # rebuilt on the first solve


def test_recover_restores_pending_internals(tmp_path):
    _, trace = _traces()
    jdir = str(tmp_path / "j")
    _run(trace, "oef-coop", jdir=jdir, until=_mid(trace))
    sched, journal, n_applied = recover_scheduler(jdir, snapshot_every=10, device="cpu")
    assert 0 < n_applied <= len(trace)
    assert journal.n_applied <= n_applied
    internals = journal.pending_internals
    assert internals and all(ev.kind in (EventKind.JOB_FINISH, EventKind.RESOLVE)
                             for ev in internals)
    assert sched.tenants and sched.jobs
    assert sched.solver_backend == "torch" and sched.device.type == "cpu"


def test_journal_divergence_detected(tmp_path):
    _, trace = _traces()
    jdir = str(tmp_path / "j")
    _run(trace, "oef-noncoop", jdir=jdir, until=1000.0)
    journal = Journal(jdir, snapshot_every=10)
    first = journal.events(0, 1)[0]
    journal.record(first)
    with pytest.raises(RuntimeError, match="journal divergence"):
        journal.record(dataclasses.replace(first, time=first.time + 1.0))


def test_snapshot_commit_is_atomic(tmp_path):
    _, trace = _traces()
    jdir = str(tmp_path / "j")
    _run(trace, "oef-coop", jdir=jdir, until=2000.0)
    assert not any(n.endswith(".tmp") for n in os.listdir(jdir))
    with pytest.raises(ValueError, match="positive"):
        Journal(jdir, snapshot_every=0)


def test_resume_on_cuda_without_a_gpu_raises(tmp_path, monkeypatch):
    _, trace = _traces()
    jdir = str(tmp_path / "j")
    _run(trace, "oef-noncoop", jdir=jdir, until=_mid(trace))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resume_scheduler(jdir, list(trace), snapshot_every=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recover_scheduler(jdir, snapshot_every=10, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--journal", jdir, "--tenants", "6"])


def _cli_report(argv, capsys):
    assert cli_main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    return {k: v for k, v in out.items() if not k.startswith("resolve_latency")}


@pytest.mark.parametrize("flags", (
    ["--policy", "oef-noncoop"],
    ["--policy", "oef-coop"],
    # --chaos: its solver faults are the process's state, not the journal's
    # (as in the JAX package), so a resumed run fires them anew; gavel
    # dispatches no OEF program, so its run carries the trace's chaos alone
    ["--policy", "gavel", "--chaos"],
), ids=("noncoop", "coop", "gavel-chaos"))
def test_cli_journal_resumes_to_the_uninterrupted_report(flags, tmp_path, capsys):
    argv = ["--device", "cpu", "--tenants", "6", "--duration", "3600",
            "--host-failures-per-hour", "2", "--snapshot-every", "10", *flags]
    ref = _cli_report([*argv, "--journal", str(tmp_path / "ref")], capsys)
    crash = str(tmp_path / "crash")
    _cli_report([*argv, "--journal", crash, "--until", "1500"], capsys)
    assert Journal(crash).available_snapshots()
    resumed = _cli_report([*argv, "--journal", crash], capsys)
    assert resumed == ref
    assert ref["n_solves"] > 0


def test_cli_chaos_journal_round_trip_fires_the_plan_each_time(tmp_path, capsys):
    """With ``--chaos`` on the torch tier the first process and the resumed
    one each fire the whole plan on ``oef-noncoop/torch`` and complete."""
    argv = ["--device", "cpu", "--tenants", "6", "--duration", "3600", "--chaos",
            "--journal", str(tmp_path / "j"), "--snapshot-every", "10"]
    assert cli_main([*argv, "--until", "1800"]) == 0
    first = capsys.readouterr().err
    assert cli_main(argv) == 0
    second = capsys.readouterr().err
    assert "recovered from" in second
    for err in (first, second):
        assert "'solver_faults_fired': 5" in err and "'oef-noncoop/torch'" in err


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 28-29, rehearsed
# ---------------------------------------------------------------------------


def test_chip_smoke_journal_phases_rehearse_on_the_cpu(monkeypatch):
    """Phases 28 (coop) and 29 (non-coop) on the CPU at 32 tenants, the fused
    kernels counted in their plain versions: journaled == plain, resumed ==
    uninterrupted, and the killed and resumed halves' launches add up."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs
    from test_torch_chaos import count_fused_launches

    count_fused_launches(monkeypatch)
    monkeypatch.setattr(cs, "JOURNAL_CELLS", {28: ("oef-coop", 32, 4, 7200.0),
                                              29: ("oef-noncoop", 32, 4, 7200.0)})
    detail = {}
    for phase in (28, 29):
        got = cs.journal_phase(np, detail, phase, dev="cpu")
        assert got["killed"] - got["tail"] + got["resumed"] == got["journaled"] > 0
        assert 0 < detail[f"journal_{phase}"]["last_snapshot"] \
            <= detail[f"journal_{phase}"]["n_recorded"]
