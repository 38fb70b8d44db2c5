"""Port's online service vs the JAX package's, on the same events.

Traces are generated by the JAX package and carried into the port as plain
rows (``repro_torch.interop.events_from_rows``), so both schedulers replay
literally the same events. A replay must make the same decisions — same
solve, job and event counts, per-tenant throughput within 1e-6 — as
``tests/test_jax_solve.py`` requires of the JAX tier against numpy.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.core import oef as joef
from repro.core.types import ClusterSpec as JClusterSpec
from repro.service import OnlineScheduler as JScheduler
from repro.service import synthetic_trace
from repro.service.traces import default_cluster, default_job_types
from repro_torch import interop
from repro_torch.core import oef, torch_coop, torch_solve
from repro_torch.core.types import ClusterSpec
from repro_torch.kernels import KernelError
from repro_torch.kernels import envy as tenvy
from repro_torch.service import OnlineScheduler
from repro_torch.service.__main__ import main as cli_main
from torch_threads import one_thread

one_thread()

ROOT = os.path.join(os.path.dirname(__file__), "..")
TYPES = ("rtx3070", "rtx3080", "rtx3090")


def jax_trace(n_tenants, per_type, *, seed, **kw):
    cluster = JClusterSpec(types=TYPES, m=(per_type,) * 3)
    params = dict(duration_s=1800.0, mean_interarrival_s=300.0,
                  mean_work_s=900.0, seed=seed)
    params.update(kw)
    return synthetic_trace(n_tenants, job_types=default_job_types("paper"),
                           cluster=cluster, **params)


def rows(events):
    return [(ev.time, ev.kind.value, ev.tenant, ev.job_id, ev.payload)
            for ev in events]


def replay_jax(events, per_type, backend, until, policy="oef-noncoop"):
    sched = JScheduler(JClusterSpec(types=TYPES, m=(per_type,) * 3),
                       policy, min_resolve_interval_s=30.0,
                       solver_backend=backend)
    # jax 0.9 removed the jax.experimental.enable_x64 that the JAX
    # scheduler's own float64 scope calls; with x64 on it is skipped.
    with jax.enable_x64(True):
        return sched.run(events, until=until)


def replay_torch(events, per_type, backend, until, policy="oef-noncoop", **kw):
    sched = OnlineScheduler(ClusterSpec(types=TYPES, m=(per_type,) * 3),
                            policy, min_resolve_interval_s=30.0,
                            solver_backend=backend, device="cpu", **kw)
    return sched, sched.run(interop.events_from_rows(rows(events)), until=until)


def assert_same_decisions(a, b):
    """The criteria of tests/test_jax_solve.py's replay test."""
    assert a.n_solves == b.n_solves
    assert a.jobs_finished == b.jobs_finished
    assert a.n_events == b.n_events
    assert abs(a.mean_jct_s - b.mean_jct_s) <= 1e-6 * max(a.mean_jct_s, 1.0)
    assert set(a.tenant_throughput) == set(b.tenant_throughput)
    for name in a.tenant_throughput:
        assert abs(a.tenant_throughput[name] - b.tenant_throughput[name]) <= 1e-6


def decision_fields(report):
    d = json.loads(report.to_json())
    return {k: v for k, v in d.items() if not k.startswith("resolve_latency")}


@pytest.mark.parametrize("backend,jax_backend", (("torch", "jax"),
                                                 ("numpy", "numpy"),
                                                 ("torch", "numpy")))
def test_replay_matches_jax_package(backend, jax_backend):
    events = jax_trace(6, 8, seed=4)
    ref = replay_jax(events, 8, jax_backend, 3600.0)
    _, got = replay_torch(events, 8, backend, 3600.0)
    assert_same_decisions(ref, got)
    assert got.solver_backends == {backend: got.n_solves}


def test_replay_at_128_tenants_matches_jax_tier():
    """At 128 tenants on 128x3 devices the two water-filling tiers make the
    same decisions. (Both depart from the numpy greedy's replay here: tied
    tenants get shares ~1e-10 apart, which flips rounding ties.)"""
    events = jax_trace(128, 128, seed=0, mean_interarrival_s=1200.0,
                       mean_work_s=1200.0)
    ref = replay_jax(events, 128, "jax", 3600.0)
    _, got = replay_torch(events, 128, "torch", 3600.0)
    assert_same_decisions(ref, got)
    assert got.fallback_count == 0 and got.degraded_solves == 0


def test_weighted_tenants_take_the_virtual_user_path():
    events = jax_trace(5, 8, seed=6, weight_choices=(1.0, 2.0, 0.5))
    assert any(ev.payload.get("weight", 1.0) != 1.0 for ev in events)
    ref = replay_jax(events, 8, "jax", 3600.0)
    _, got = replay_torch(events, 8, "torch", 3600.0)
    assert_same_decisions(ref, got)
    assert got.solver_backends == {"torch": got.n_solves}


def test_two_replays_repeat_bit_for_bit():
    events = jax_trace(8, 8, seed=1, host_failures_per_hour=2.0)
    s1, a = replay_torch(events, 8, "torch", 3600.0)
    s2, b = replay_torch(events, 8, "torch", 3600.0)
    assert decision_fields(a) == decision_fields(b)
    assert [r.warm_started for r in s1.metrics.solves] == \
        [r.warm_started for r in s2.metrics.solves]


def test_solve_records_mark_warm_starts():
    sched, report = replay_torch(jax_trace(6, 8, seed=4), 8, "torch", 3600.0)
    solved = [r for r in sched.metrics.solves if not r.reused]
    assert solved and not solved[0].warm_started
    assert any(r.warm_started for r in solved[1:])
    assert not any(r.warm_started for r in sched.metrics.solves if r.reused)


def test_interop_carries_events_and_the_warm_start():
    events = jax_trace(3, 8, seed=2)
    ported = interop.events_from_rows(rows(events))
    assert [(e.time, e.kind.value, e.tenant, e.job_id, e.payload) for e in ported] \
        == rows(events)
    as_text = interop.events_from_rows(
        [(t, k, te, j, json.dumps(p)) for t, k, te, j, p in rows(events)])
    assert as_text == ported
    with pytest.raises(ValueError, match="internal"):
        interop.events_from_rows([(1.0, "resolve", "", "", {})])

    W = np.linspace(1.0, 2.0, 6)[:, None] ** np.array([0.0, 0.5, 1.0])
    m = np.array([3.0, 4.0, 5.0])
    jprev = joef.solve_noncoop_fast(W, m, backend="numpy")
    prev = interop.allocation_from_arrays(jprev.X, jprev.W, jprev.m, jprev.rows,
                                          jprev.meta)
    assert isinstance(prev.meta["tau"], float)
    W2 = W * 1.02
    got = oef.solve_incremental(W2, m, policy="oef-noncoop", prev=prev,
                                backend="torch", device="cpu")
    ref = joef.solve_incremental(W2, m, policy="oef-noncoop", prev=jprev)
    assert got.meta["warm_started"] is True
    assert abs(got.meta["tau"] - ref.meta["tau"]) <= 1e-9
    np.testing.assert_allclose(got.X, ref.X, atol=1e-9, rtol=0)
    same = oef.solve_incremental(W, m, policy="oef-noncoop", prev=prev,
                                 backend="torch", device="cpu")
    assert same.meta.get("reused") is True


def test_scheduler_rejects_unknown_backend_and_coop_on_torch():
    """An unknown backend is refused; coop on torch, refused before the
    cooperative tier was ported, now builds a scheduler."""
    cluster = ClusterSpec(types=("a",), m=(4,))
    with pytest.raises(ValueError, match="backend"):
        OnlineScheduler(cluster, "oef-noncoop", solver_backend="jax", device="cpu")
    sched = OnlineScheduler(cluster, "oef-coop", solver_backend="torch", device="cpu")
    assert sched.solver_backend == "torch" and sched.device.type == "cpu"


def test_scheduler_on_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA path is chip_smoke.py's")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OnlineScheduler(ClusterSpec(types=("a",), m=(4,)), "oef-noncoop",
                        solver_backend="torch")


def test_cli_replays_on_the_torch_backend():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service", "--device", "cpu",
         "--tenants", "4", "--duration", "1800"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["n_solves"] > 0 and report["jobs_finished"] > 0
    assert report["solver_backends"] == {"torch": report["n_solves"]}
    assert "backends: torch=" in proc.stderr


def test_cli_device_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA path is chip_smoke.py's")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--device", "cuda", "--tenants", "2", "--duration", "600"])


@pytest.mark.parametrize("argv,message", (
    (["--policy", "oef-coop", "--backend", "torch"], None),
))
def test_cli_refuses_what_the_port_lacks(argv, message, capsys):
    """Coop on torch, refused until the cooperative tier was ported, now
    replays. (``--chaos`` and ``--journal``, refused until the chaos engine
    and the journal were ported, are tests/test_torch_chaos.py's and
    tests/test_torch_journal.py's.)"""
    assert message is None
    assert cli_main(["--device", "cpu", "--tenants", "2", "--duration",
                     "1200", *argv]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["policy"] == "oef-coop"
    assert report["solver_backends"] == {"torch": report["n_solves"]}


def test_kernel_failure_stops_the_run_under_guardrails(monkeypatch):
    """The guardrails floor a crashed host solver on the LP, but a failed
    kernel raises out of the run: the LP never answers in its place."""
    def broken(*_a):
        raise KernelError("waterfill_masses kernel launch failed: test")

    monkeypatch.setattr(torch_solve, "waterfill_masses", broken)
    with pytest.raises(KernelError, match="launch failed"):
        replay_torch(jax_trace(6, 8, seed=4), 8, "torch", 3600.0)


def test_scheduler_on_a_gpu_without_nvcc_fails_at_construction(monkeypatch, tmp_path):
    """With a card but no compiler, the scheduler raises when it is built,
    before any solve could be handed to another backend."""
    import shutil
    import torch.utils.cpp_extension as cpp_ext

    from repro_torch.kernels import _build, waterfill

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setattr(waterfill, "_LIB", None)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    cluster = ClusterSpec(types=TYPES, m=(8, 8, 8))
    with pytest.raises(KernelError, match="nvcc not found"):
        OnlineScheduler(cluster, "oef-noncoop", solver_backend="torch")
    # the numpy backend needs no kernel, so it builds nothing
    OnlineScheduler(cluster, "oef-noncoop", solver_backend="numpy")


# ---------------------------------------------------------------------------
# the cooperative tier in the service
# ---------------------------------------------------------------------------
def coop_trace(n_tenants, per_type):
    """The JAX package's coop-jax benchmark ladder trace
    (``benchmarks/service_throughput.py``)."""
    return jax_trace(n_tenants, per_type, seed=0, mean_interarrival_s=1200.0,
                     mean_work_s=1200.0)


def test_coop_replay_at_64_tenants_matches_jax_tier(monkeypatch):
    """64 tenants on 64x3 devices, ``oef-coop``: the port's primal–dual tier
    on the CPU makes the JAX tier's decisions, and runs exactly one envy
    evaluation (one kernel launch on the card) per PD iteration it reports."""
    calls = []
    real = tenvy.envy_gaps_plain

    def counting(W, X):
        calls.append(W.shape)
        return real(W, X)

    events = coop_trace(64, 64)
    ref = replay_jax(events, 64, "jax", 7200.0, policy="oef-coop")
    monkeypatch.setattr(tenvy, "envy_gaps_plain", counting)
    sched, got = replay_torch(events, 64, "torch", 7200.0, policy="oef-coop")
    assert_same_decisions(ref, got)
    assert got.solver_backends == {"torch": got.n_solves}
    assert got.fallback_count == 0 and got.degraded_solves == 0
    pd_iters = [r.pd_iters for r in sched.metrics.solves]
    assert sum(pd_iters) == len(calls) >= torch_coop.SEG_ITERS
    assert all(p == 0 for r, p in zip(sched.metrics.solves, pd_iters) if r.reused)
    assert any(r.warm_started for r in sched.metrics.solves)


def test_coop_replay_audits_are_envy_free():
    jcluster = default_cluster("paper")
    events = synthetic_trace(
        3, job_types=default_job_types("paper"), cluster=jcluster,
        duration_s=1800.0, mean_interarrival_s=300.0, mean_work_s=900.0, seed=0)
    sched = OnlineScheduler(ClusterSpec(types=jcluster.types, m=jcluster.m),
                            "oef-coop", solver_backend="torch", audit_every=1,
                            device="cpu")
    report = sched.run(interop.events_from_rows(rows(events)), until=3600.0)
    assert report.n_solves > 0
    assert report.solver_backends == {"torch": report.n_solves}
    assert len(report.fairness_audits) == report.n_solves
    for audit in report.fairness_audits:
        assert audit["envy_free"]


def test_cli_replays_coop_on_the_torch_backend():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service", "--policy", "oef-coop",
         "--backend", "torch", "--device", "cpu", "--tenants", "6",
         "--duration", "1800"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["policy"] == "oef-coop"
    assert report["n_solves"] > 0 and report["jobs_finished"] > 0
    assert report["solver_backends"] == {"torch": report["n_solves"]}
    assert "backends: torch=" in proc.stderr


def test_envy_kernel_failure_stops_the_coop_run_under_guardrails(monkeypatch):
    def broken(*_a):
        raise KernelError("envy_gaps kernel launch failed: test")

    monkeypatch.setattr(torch_coop, "envy_gaps", broken)
    with pytest.raises(KernelError, match="launch failed"):
        replay_torch(coop_trace(8, 8), 8, "torch", 3600.0, policy="oef-coop")


def test_coop_scheduler_on_a_gpu_without_nvcc_fails_at_construction(monkeypatch,
                                                                      tmp_path):
    import shutil
    import torch.utils.cpp_extension as cpp_ext

    from repro_torch.kernels import _build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setattr(tenvy, "_LIB", None)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    cluster = ClusterSpec(types=TYPES, m=(8, 8, 8))
    with pytest.raises(KernelError, match="nvcc not found"):
        OnlineScheduler(cluster, "oef-coop", solver_backend="torch")
    # the LP (and its numpy alias) needs no kernel, so it builds nothing
    OnlineScheduler(cluster, "oef-coop", solver_backend="numpy")
