"""The mesh trainer's compute split over the ``model`` axis, on the CPU.

One run of 4 gloo processes (``torch_dist_workers.spawn``; a 2x2
``("data", "model")`` mesh) and one JAX subprocess with 4 forced host
devices (as ``tests/test_torch_distributed.py`` runs the JAX trainer) serve
the parametrised cases; a run of 2 gloo processes tests the collectives.
Every case trains in float32 from a step-0 checkpoint of the port's
meshless trainer, which the JAX 2x2 trainer, the port's 2x2 trainer and
the port's meshless trainer all restore:

  - qwen2 smoke, ``seq_tp`` (the residual stream in sequence blocks, K/V
    gathered);
  - qwen2 smoke, ``attn_parallelism="head"`` (6 heads / 2 KV heads, 3 heads
    a rank; SwiGLU's ``d_ff`` split);
  - recurrentgemma smoke at S 64, so that the window of 32 crosses the
    blocks' boundary (the RG-LRU mixers gather the sequence);
  - arctic smoke, 2 of its 4 experts a rank, Adafactor;
  - xlstm and whisper smoke under ``ddp`` at a global batch of 2, which
    leaves ``model`` to the sequence (the mLSTM / sLSTM gather it; the
    encoder's frames are split too);
  - arctic smoke under head TP at S 31, which does not split: the model
    axis's ranks hold the same rows, and heads, ``d_ff`` columns and
    experts each end in an all-reduce of the partial sums.

Tolerances: losses within 5e-3 relative of the JAX 2x2 trainer's (JAX's
own sharded-vs-single gate); against the meshless port, losses within
1e-5 relative and every master within 1e-6 of the largest |p| after 4
steps, as ``tests/test_torch_distributed.py`` holds the batch split. The
split itself is read from the first step: every ``Block``'s input holds
S/2 positions (where S splits), head TP's score products half the heads
(the others all of them), and arctic's expert products 2 of the 4
experts.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import flatten
from repro_torch.configs import get_smoke
from repro_torch.runtime import Trainer, TrainerConfig
from test_torch_distributed import (JAX_TOL, LOSS_TOL, MASTER_TOL, ROOT, _finish,
                                    _jax_subprocess, _master_err, _rel)
from torch_dist_workers import collectives, spawn, split_train
from torch_threads import one_thread

one_thread()

MESH_2x2 = ((2, 2), ("data", "model"))
TCFG = dict(seq_len=32, global_batch=4, total_steps=20, warmup=2, ckpt_every=100)
STEPS = 4
FP32 = {"dtype": "float32"}
DDP = {**FP32, "attn_parallelism": "ddp"}
#: name, arch, config overrides, trainer overrides
CASES = (
    ("qwen2_seq", "qwen2-1.5b", FP32, {}),
    ("qwen2_head", "qwen2-1.5b", {**FP32, "attn_parallelism": "head"}, {}),
    ("recurrentgemma", "recurrentgemma-2b", FP32, {"seq_len": 64}),
    ("arctic", "arctic-480b", FP32, {"optimizer": "adafactor"}),
    ("xlstm_ddp", "xlstm-350m", DDP, {"global_batch": 2}),
    ("whisper_ddp", "whisper-tiny", DDP, {"global_batch": 2}),
    ("arctic_head_s31", "arctic-480b", {**FP32, "attn_parallelism": "head"},
     {"seq_len": 31}),
)

JAX_RUNS = """
import dataclasses, json, os, sys
from repro.configs import get_smoke
from repro.launch.mesh import make_test_mesh
from repro.runtime import Trainer, TrainerConfig

root, steps = sys.argv[1], int(sys.argv[2])
out = {}
for name, arch, over, tcfg in json.loads(sys.argv[3]):
    t = Trainer(dataclasses.replace(get_smoke(arch), **over),
                TrainerConfig(**tcfg, ckpt_dir=os.path.join(root, name)),
                mesh=make_test_mesh((2, 2), ("data", "model")))
    assert t.restore_latest() == 0
    out[name] = t.run(steps)["losses"]
print(json.dumps(out))
"""


def _tcfg(over):
    return {**TCFG, **over}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's step-0 checkpoint from the port's meshless trainer, then
    at once the JAX 2x2 trainer's losses and the port's 2x2 runs (by rank),
    both restored from it."""
    root = tmp_path_factory.mktemp("split")
    cases = [(n, a, o, _tcfg(t)) for n, a, o, t in CASES]
    for name, arch, over, tcfg in cases:
        t = Trainer(dataclasses.replace(get_smoke(arch), **over),
                    TrainerConfig(**tcfg, ckpt_dir=str(root / name)), device="cpu")
        t.ckpt.maybe_save(t.state_tree(), 0, force=True)
        t.ckpt.wait()
    jax_proc = _jax_subprocess(JAX_RUNS, [root, STEPS, json.dumps(cases)])
    by_rank = spawn(split_train, 4, root / "ranks", [
        (n, a, o, t, *MESH_2x2, STEPS, str(root / n)) for n, a, o, t in cases], timeout=300)
    return {"jax": _finish(jax_proc, 300), "ranks": by_rank, "root": root}


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_the_split_matches_the_jax_2x2_trainer(runs, name):
    got = runs["ranks"][0][name]["losses"]
    want = runs["jax"][name]
    assert len(got) == STEPS and np.all(np.isfinite(got))
    assert _rel(got, want) < JAX_TOL, (got, want)
    for r in runs["ranks"]:  # every rank reports the global loss
        assert r[name]["losses"] == got


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_the_split_matches_the_meshless_trainer(runs, name):
    _, arch, over, tcfg = _case(name)
    d = str(runs["root"] / f"{name}_meshless")
    shutil.copytree(runs["root"] / name, d)
    t = Trainer(dataclasses.replace(get_smoke(arch), **over),
                TrainerConfig(**_tcfg(tcfg), ckpt_dir=d), device="cpu")
    t.restore_latest()
    losses = t.run(STEPS)["losses"]
    want = flatten(t.state_tree())
    got = runs["ranks"][0][name]
    assert _rel(got["losses"], losses) < LOSS_TOL, (got["losses"], losses)
    for r in runs["ranks"]:  # every rank gathers the same state
        assert _master_err(flatten(r[name]["tree"]), want) < MASTER_TOL


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_each_rank_computes_its_share(runs, name):
    """Every ``Block`` input is this rank's half of the sequence of its rows
    (2 of the global 4, or 1 of 2 under ``ddp``: ``data`` splits the batch
    either way), or all of an S that does not split; head TP scores half the
    heads, the other plans all of them; arctic's expert products take 2 of
    its 4 experts."""
    _, arch, over, tcfg = _case(name)
    cfg = get_smoke(arch)
    tcfg = _tcfg(tcfg)
    rows, S = tcfg["global_batch"] // 2, tcfg["seq_len"]
    block = S // 2 if S % 2 == 0 else S
    heads = (set() if arch == "xlstm-350m"  # no attention layer
             else {cfg.n_heads // 2} if over.get("attn_parallelism") == "head"
             else {cfg.n_heads})
    for r in runs["ranks"]:
        got = r[name]
        assert got["blocks"] == [(rows, block, cfg.d_model)] * (cfg.n_layers
                                                               + cfg.encoder_layers)
        assert set(got["heads"]) == heads
        if arch == "arctic-480b":
            assert got["bmm"] and {s[0] for s in got["bmm"]} == {cfg.n_experts // 2}


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    return spawn(collectives, 2, tmp_path_factory.mktemp("collectives"), timeout=120)


def _blocks(t, world=2, dim=1):
    return list(torch.chunk(t, world, dim=dim))


def test_gather_seq_gathers_and_its_backward_reduce_scatters(collective_runs):
    rs = [r["gather_seq"] for r in collective_runs]
    whole = torch.cat([r["x"] for r in rs], dim=1)
    dy_sum = sum(r["dy"] for r in rs)
    for rank, r in enumerate(rs):
        assert torch.equal(r["y"], whole)
        torch.testing.assert_close(r["dx"], _blocks(dy_sum)[rank], rtol=1e-15, atol=1e-15)


def test_keep_seq_keeps_the_block_and_its_backward_pads_with_zeros(collective_runs):
    for rank, r in enumerate(c["keep_seq"] for c in collective_runs):
        assert torch.equal(r["y"], _blocks(r["x"])[rank])
        want = torch.zeros_like(r["x"])
        want[:, 4 * rank:4 * rank + 4] = r["dy"]
        assert torch.equal(r["dx"], want)


def test_scatter_sum_reduce_scatters_and_its_backward_gathers(collective_runs):
    rs = [r["scatter_sum"] for r in collective_runs]
    x_sum = sum(r["x"] for r in rs)
    dy_whole = torch.cat([r["dy"] for r in rs], dim=1)
    for rank, r in enumerate(rs):
        torch.testing.assert_close(r["y"], _blocks(x_sum)[rank], rtol=1e-15, atol=1e-15)
        assert torch.equal(r["dx"], dy_whole)


def test_scatter_sum_all_reduces_forward_and_backward_where_the_sequence_is_whole(
        collective_runs):
    rs = [r["sum_all"] for r in collective_runs]
    x_sum, dy_sum = sum(r["x"] for r in rs), sum(r["dy"] for r in rs)
    for r in rs:
        torch.testing.assert_close(r["y"], x_sum, rtol=1e-15, atol=1e-15)
        torch.testing.assert_close(r["dx"], dy_sum, rtol=1e-15, atol=1e-15)


def test_all_gather_and_reduce_scatter_are_adjoint(collective_runs):
    """<gather(x), y> summed over the ranks equals <x, reduce_scatter(y)>
    summed over them: the gather's backward is its adjoint."""
    rs = [r["gather_seq"] for r in collective_runs]
    lhs = sum(float((r["y"] * r["dy"]).sum()) for r in rs)
    rhs = sum(float((r["x"] * r["dx"]).sum()) for r in rs)
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


def test_the_primitives_along_every_dim(collective_runs):
    xs = [r["all_gather_dims"] for r in collective_runs]
    for d in range(3):
        whole = torch.cat([r["x"] for r in xs], dim=d)
        for r in xs:
            assert torch.equal(r["y"][d], whole)
    z_sum = sum(r["reduce_scatter_dims"]["x"] for r in collective_runs)
    for rank, r in enumerate(collective_runs):
        for d in range(3):
            torch.testing.assert_close(r["reduce_scatter_dims"]["y"][d],
                                       torch.chunk(z_sum, 2, dim=d)[rank], rtol=1e-15, atol=1e-15)


def test_every_collective_is_the_identity_on_one_rank(collective_runs):
    for r in collective_runs:
        for y in r["alone"]["ys"]:
            assert torch.equal(y, r["alone"]["x"])


def test_chip_smoke_phase_48_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 48 on the CPU: recurrentgemma smoke (its
    pattern unit, ``remat="full"``, float32), B 2 x 64 on two gloo ranks of
    a (1, 2) mesh against the meshless trainer in this process; the
    RG-LRU's plain versions stand in for the kernels and are counted as
    launches (each rank the meshless step's count)."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    detail = {}
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"), remat="full", dtype="float32")
    out = chip_smoke.split_phase(torch, detail, dev="cpu", cfg=cfg, shape=(2, 64))
    assert detail["split"] is out
    assert not torch.distributed.is_initialized()
    for r in out["ranks"]:  # each layer's forward and its recompute
        assert len(r["blocks"]) == 2 * cfg.n_layers
        assert all(b == [2, 32, cfg.d_model] for b in r["blocks"])
        assert r["launches_per_step"] == out["meshless"]["launches_per_step"]
        assert _rel(r["losses"], out["meshless"]["losses"]) < chip_smoke.SPLIT_LOSS_TOL
        assert r["masters_err"] < chip_smoke.SPLIT_MASTER_TOL
    assert out["meshless"]["launches_per_step"][0] == [4, 2]
