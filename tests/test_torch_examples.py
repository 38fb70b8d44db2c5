"""The port's quickstart and online-service twins vs the JAX package's
examples, on the CPU.

- quickstart: the port's ``main(["--device", "cpu"])`` against the calls the
  JAX ``examples/quickstart.py`` makes on ``repro``: the LP allocations bit
  for bit (the same LP on the same inputs), the device tiers within 1e-9 of
  them (the water-filling tier's parity contract), the property report
  equal, the SP probe's throughputs within 1e-9 of the JAX probe's and its
  gain <= 1e-9; the launches ``chip_smoke.py`` phase 46 demands, counted in
  the fused kernels' plain versions (one fused solve a non-coop solve, the
  probe's 33 included, one fused segment a PD segment);
- online service: the twin's trace, CSV text, replay and audit against the
  JAX example's steps: the same events and CSV text; the same solves,
  reused solves and finished jobs, mean JCT and queue delay within 1e-9
  relative and the same last audit (the port's coop tier on the CPU
  against the JAX service's default, the LP: no rounding tie parts them on
  this trace, so no 5% rule is needed); the cross-validation under 1%;
- both raise ``RuntimeError("no CUDA device")`` by default without a GPU.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax

from repro.core import oef as jax_oef
from repro.core import properties as jax_properties
from repro.core.types import ClusterSpec as JaxClusterSpec
from repro.service import OnlineScheduler as JaxScheduler
from repro.service import synthetic_trace as jax_trace, write_trace_csv as jax_write_csv
from repro.service.traces import default_job_types as jax_job_types
from repro_torch.core import torch_coop
from repro_torch.examples import online_service, quickstart
from repro_torch.kernels import wrappers
from test_torch_chaos import count_fused_launches
from torch_threads import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = 1e-9


def quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a)


@pytest.fixture(scope="module")
def quick():
    with jax.enable_x64(True):
        out = quiet(quickstart.main, ["--device", "cpu"])
    return out


def test_quickstart_lp_allocations_are_the_jax_ones(quick):
    W, m = quickstart.W, quickstart.m
    assert np.array_equal(quick["noncoop"]["lp_X"], jax_oef.solve_noncoop(W, m).X)
    assert np.array_equal(quick["coop"]["lp_X"], jax_oef.solve_coop(W, m).X)


def test_quickstart_device_tiers_match_the_lp(quick):
    W, m = quickstart.W, quickstart.m
    for what, jax_solve in (("noncoop", jax_oef.solve_noncoop), ("coop", jax_oef.solve_coop)):
        want = jax_solve(W, m)
        assert np.max(np.abs(quick[what]["X"] - want.X)) <= PARITY, what
        assert np.max(np.abs(quick[what]["throughput"] - want.throughput)) <= PARITY, what
    assert quick["coop"]["backend"] == "torch" and quick["coop"]["fallback_from"] is None
    assert quick["properties"] == jax_properties.property_report(
        W, jax_oef.solve_coop(W, m).X, m)


def test_quickstart_sp_probe_matches_the_jax_probe(quick):
    W, m = quickstart.W, quickstart.m
    want = jax_properties.strategy_proofness_probe(
        lambda Wx, mx: jax_oef.solve_noncoop(Wx, mx), W, m, user=0,
        n_trials=quickstart.SP_TRIALS)
    assert abs(quick["sp"]["honest"] - want.honest_throughput) <= PARITY
    assert abs(quick["sp"]["best_cheat"] - want.best_cheat_throughput) <= PARITY
    assert quick["sp"]["gain"] <= PARITY
    assert quick["sp"]["solves"] == quickstart.SP_TRIALS + 1


def test_quickstart_launches_one_fused_solve_a_solve(monkeypatch):
    count_fused_launches(monkeypatch)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    out = quiet(quickstart.main, ["--device", "cpu"])
    got = {k: w.launches for k, w in ws.items()}
    seg = torch_coop.SEG_ITERS
    assert out["coop"]["pd_iters"] % seg == 0 and out["coop"]["pd_iters"] >= seg
    want = dict.fromkeys(ws, 0)
    want.update(waterfill_solve=2 + quickstart.SP_TRIALS,
                pd_segment=out["coop"]["pd_iters"] // seg)
    assert got == want


@pytest.fixture(scope="module")
def service():
    return quiet(online_service.main, ["--device", "cpu"])


def _jax_events():
    cluster = JaxClusterSpec.paper_cluster()
    return cluster, jax_trace(
        4, job_types=jax_job_types("paper"), cluster=cluster, duration_s=3600.0,
        mean_interarrival_s=400.0, mean_work_s=900.0, host_failures_per_hour=1.0, seed=0)


def test_online_service_trace_and_csv_are_the_jax_ones(service, tmp_path):
    _, events = _jax_events()
    assert len(service["events"]) == len(events)
    path = str(tmp_path / "jax.csv")
    jax_write_csv(events, path)
    with open(path) as f:
        assert service["csv"] == f.read()


def test_online_service_replay_matches_the_jax_replay(service):
    cluster, events = _jax_events()
    with jax.enable_x64(True):
        want = JaxScheduler(cluster, "oef-coop", min_resolve_interval_s=30.0,
                            audit_every=5).run(events)
    got = service["report"]
    assert set(got.solver_backends) == {"torch"}
    assert got.fallback_count == 0 and got.degraded_solves == 0
    assert (got.n_solves, got.n_reused_solves, got.jobs_finished) == (
        want.n_solves, want.n_reused_solves, want.jobs_finished)
    for f in ("mean_jct_s", "mean_queue_delay_s"):
        assert abs(getattr(got, f) - getattr(want, f)) <= PARITY * abs(getattr(want, f)), f
    assert got.fairness_audits[-1] == want.fairness_audits[-1]


def test_online_service_crossval_is_under_one_percent(service):
    assert service["crossval"]["max_rel_err"] < 0.01


@pytest.mark.parametrize("example", [quickstart, online_service],
                         ids=["quickstart", "online_service"])
def test_examples_without_a_gpu_raise_by_default(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])


def test_chip_smoke_phase_46_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 46 on the CPU: its checks pass with the
    fused kernels counted in their plain versions (the card's run and the
    CPU's are both CPU runs here)."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    count_fused_launches(monkeypatch)
    detail = {}
    out = quiet(chip_smoke.examples_phase, torch, np, detail, "cpu")
    assert out["quickstart"]["noncoop_solves"] == 2 + quickstart.SP_TRIALS
    assert out["online_service"]["launches"]["pd_segment"] >= 1
    assert detail["examples"] is out
