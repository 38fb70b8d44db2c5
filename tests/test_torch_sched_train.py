"""The port's OEF-scheduled multi-tenant training vs the JAX package's.

``repro_torch.launch.train --scheduler`` is the twin of
``repro.launch.train._run_scheduled``: the JAX launcher's simulated TPU
fleet, its ``ProfilingAgent`` profiles from ``models.costs``, one
``evaluate_tenants`` a round on the default backend chain and a
``RoundingPlacer`` carried across rounds. ``schedule_rounds`` (no training)
must equal that computation done with ``repro.core.oef``,
``repro.core.placement`` and ``repro.models.costs``, exactly: shares,
grants and steps. Then the launcher trains every tenant on the CPU, and
the two examples run.
"""
import json
import math
import os
import tempfile

import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core import ClusterSpec as JClusterSpec
from repro.core import ProfilingAgent as JAgent
from repro.core import Tenant as JTenant
from repro.core import WorkloadCost as JCost
from repro.core import oef as joef
from repro.core.placement import RoundingPlacer as JPlacer
from repro.models.config import ShapeCell as JShapeCell
from repro.models.costs import model_flops as jflops, param_bytes as jbytes
from repro_torch.examples import cluster_scheduler_e2e, serve_decode
from repro_torch.kernels import rglru_scan as rg
from repro_torch.launch import train as train_cli
from torch_threads import one_thread

one_thread()

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEFAULT = "qwen2-1.5b,gemma3-4b,xlstm-350m"


def jax_schedule(names, scheduler, rounds, seq_len, batch):
    """``repro.launch.train._run_scheduled``'s allocations, its loop without
    the training."""
    cluster = JClusterSpec(types=("tpu-v5e", "tpu-v4", "tpu-v5p", "tpu-v6e"),
                           m=(8, 8, 4, 4))
    agent = JAgent()
    cell = JShapeCell("sched", "train", seq_len, batch)
    tenants = []
    for name in names:
        cfg = jax_smoke(name)
        cost = JCost(name=name, flops=jflops(cfg, cell) / batch,
                     hbm_bytes=float(jbytes(cfg)) * 3)
        tenants.append(JTenant(name=name, job_types=(agent.profile(cost),)))
    placer = JPlacer(len(tenants), cluster.m)
    mode = "cooperative" if scheduler == "oef-coop" else "noncooperative"
    out = []
    for _ in range(rounds):
        ta = joef.evaluate_tenants(tenants, cluster, mode=mode)
        real = placer.round_shares(ta.X)
        steps = {t.name: max(1, int(float(np.dot(np.asarray(t.job_types[0].speedup),
                                                  real[i]))))
                 for i, t in enumerate(tenants)}
        out.append((ta.X, real, steps))
    return {t.name: list(t.job_types[0].speedup) for t in tenants}, out


@pytest.mark.parametrize("tenants", (DEFAULT, "recurrentgemma-2b,qwen2-1.5b",
                                     "recurrentgemma-2b,gemma3-4b,xlstm-350m,qwen2-1.5b"))
@pytest.mark.parametrize("scheduler", ("oef-coop", "oef-noncoop"))
@pytest.mark.parametrize("seq_len,batch", ((128, 8), (32, 2)))
def test_schedule_rounds_matches_jax_package(tenants, scheduler, seq_len, batch):
    names = tenants.split(",")
    got = train_cli.schedule_rounds(names, scheduler, rounds=4, seq_len=seq_len,
                                    batch=batch)
    speedups, ref = jax_schedule(names, scheduler, 4, seq_len, batch)
    assert got["speedups"] == speedups
    assert len(got["rounds"]) == 4
    for r, (X, real, steps) in zip(got["rounds"], ref):
        np.testing.assert_array_equal(r["shares"], X)
        np.testing.assert_array_equal(r["grants"], real)
        assert r["grants"].dtype == real.dtype
        assert r["steps"] == steps


def _train(argv, capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    train_cli.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("scheduler,tenants", (("oef-coop", None),
                                               ("oef-noncoop", "recurrentgemma-2b,qwen2-1.5b")))
def test_train_cli_scheduler_trains_every_tenant(scheduler, tenants, capsys, tmp_path,
                                                 monkeypatch):
    argv = ["--scheduler", scheduler, "--device", "cpu", "--rounds", "1",
            "--seq-len", "32", "--batch", "2"]
    if tenants:
        argv += ["--tenants", tenants]
    out = _train(argv, capsys, tmp_path, monkeypatch)
    names = (tenants or DEFAULT).split(",")
    want = train_cli.schedule_rounds(names, scheduler, rounds=1, seq_len=32, batch=2)
    assert "round 0: grants" in out and "steps/s" in out and "done:" in out
    for name in names:
        line = next(ln for ln in out.splitlines() if ln.startswith(f"  {name}: "))
        assert line.startswith(f"  {name}: {want['rounds'][0]['steps'][name]} steps, loss -> ")
        loss = float(line.split("loss -> ")[1].split(",")[0])
        assert math.isfinite(loss)


def test_run_scheduled_returns_losses_walls_and_launches(tmp_path, monkeypatch):
    from argparse import Namespace

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = Namespace(scheduler="oef-noncoop", tenants="recurrentgemma-2b,qwen2-1.5b",
                     rounds=2, seq_len=16, batch=2, lr=3e-4, device="cpu")
    got = train_cli.run_scheduled(args)
    want = train_cli.schedule_rounds(["recurrentgemma-2b", "qwen2-1.5b"], "oef-noncoop",
                                     rounds=2, seq_len=16, batch=2)
    assert [r["steps"] for r in got["schedule"]["rounds"]] \
        == [r["steps"] for r in want["rounds"]]
    for r, w in zip(got["rounds"], want["rounds"]):
        assert r["wall_s"] > 0
        for name, t in r["tenants"].items():
            assert len(t["losses"]) == t["steps"] == w["steps"][name]
            assert all(math.isfinite(x) for x in t["losses"]) and t["seconds"] > 0
            assert not any(t["launches"].values())  # the CPU runs plain versions


def test_scheduled_mode_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--scheduler", "oef-coop", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster_scheduler_e2e.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_decode.main([])


def test_scheduled_mode_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="scheduled mode trains each tenant"):
        train_cli.main(["--scheduler", "oef-coop", "--mesh", "2x4", "--device", "cpu"])


def test_cluster_scheduler_example_runs_on_the_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(cluster_scheduler_e2e, "N_ROUNDS", 1)
    cluster_scheduler_e2e.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "-- round 0: fractional shares" in out and "integer grants" in out
    for name in ("qwen2-1.5b", "gemma3-4b", "xlstm-350m"):
        line = next(ln for ln in out.splitlines() if ln.startswith(f"   {name}: "))
        assert math.isfinite(float(line.rsplit("-> ", 1)[1]))
    assert "all tenants trained under OEF allocations on cpu" in out


@pytest.mark.parametrize("arch", ("recurrentgemma-2b", "qwen2-1.5b"))
def test_serve_decode_example_runs_on_the_cpu(arch, capsys):
    serve_decode.main([arch, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 4x32" in out and "decoded 16 tokens/seq" in out
    seqs = [ln for ln in out.splitlines() if ln.startswith("  seq")]
    assert len(seqs) == 4 and all(len(json.loads(s.split(": ", 1)[1])) == 17 for s in seqs)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 26, rehearsed
# ---------------------------------------------------------------------------


def test_chip_smoke_sched_train_phase_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """Phase 26 on the CPU at 16 x 2 and one round each: the RG-LRU and
    sLSTM plain forwards and backwards count as the kernels' launches (the
    RG-LRU's on the TMA route), so recurrentgemma-2b's steps must launch 2
    + 2 RG-LRU a step (its smoke config: one unit, no remat), xlstm-350m's
    2 + 2 sLSTM (two units, no remat), and no other tenant any."""
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    import chip_smoke as cs
    from repro_torch.kernels import slstm as sl

    fwd, bwd = rg.rglru_scan_plain, rg.rglru_scan_backward_plain
    sfwd, sbwd = sl.slstm_scan_plain, sl.slstm_scan_backward_plain

    def plain(a, b, h0):
        rg.rglru_scan.launches += 1
        rg.rglru_scan.launches_tma += 1
        return fwd(a, b, h0)

    def plain_backward(a, h, h0, dh):
        rg.rglru_scan_backward.launches += 1
        rg.rglru_scan_backward.launches_tma += 1
        return bwd(a, h, h0, dh)

    def slstm_plain(*args):
        sl.slstm_scan.launches += 1
        return sfwd(*args)

    def slstm_plain_backward(*args):
        sl.slstm_scan_backward.launches += 1
        return sbwd(*args)

    monkeypatch.setattr(rg, "rglru_scan_plain", plain)
    monkeypatch.setattr(rg, "rglru_scan_backward_plain", plain_backward)
    monkeypatch.setattr(sl, "slstm_scan_plain", slstm_plain)
    monkeypatch.setattr(sl, "slstm_scan_backward_plain", slstm_plain_backward)
    monkeypatch.setattr(cs, "SCHED_SHAPE", (16, 2))
    monkeypatch.setattr(cs, "SCHED_RUNS", tuple((s, t, 1) for s, t, _ in cs.SCHED_RUNS))
    detail = {}
    got = cs.sched_train_phase(torch, np, detail, dev="cpu")
    steps = train_cli.schedule_rounds(["recurrentgemma-2b", "qwen2-1.5b"], "oef-noncoop",
                                      rounds=1, seq_len=16, batch=2)["rounds"][0]["steps"]
    n = steps["recurrentgemma-2b"]
    coop_steps = train_cli.schedule_rounds(["qwen2-1.5b", "gemma3-4b", "xlstm-350m"],
                                           "oef-coop", rounds=1, seq_len=16,
                                           batch=2)["rounds"][0]["steps"]
    nx = coop_steps["xlstm-350m"]
    assert got == {"rglru_scan": 2 * n, "rglru_scan_tma": 2 * n,
                   "rglru_scan_backward": 2 * n, "rglru_scan_backward_tma": 2 * n,
                   "slstm_scan": 2 * nx, "slstm_scan_backward": 2 * nx}
    coop = detail["sched_train"]["oef-coop qwen2-1.5b,gemma3-4b,xlstm-350m"]
    assert {k: v for k, v in coop["launches"].items() if v} == {
        "slstm_scan": 2 * nx, "slstm_scan_backward": 2 * nx}
    assert coop["steps"] > 0 and nx > 0
