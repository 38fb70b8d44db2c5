"""The port's mesh trainer on 4 gloo ranks vs the JAX package and vs itself
without a mesh, on the CPU.

Two runs of 4 gloo processes (``torch_dist_workers.spawn``: ``file://``
rendezvous, one torch thread each, a 120 s join timeout, the child's
traceback on failure) and one JAX subprocess with 4 forced host devices
(as ``tests/test_distributed.py`` runs the JAX trainer on a mesh) serve all
the tests of this file; module-scoped fixtures run each once.

Tolerances:

  - the port's 2x2 trainer against the JAX 2x2 trainer (qwen2 smoke, bf16
    compute, both from the JAX trainer's step-0 checkpoint): losses within
    5e-3 relative, JAX's own sharded-vs-single gate
    (``test_sharded_equals_single_device``); the gemma3 smoke loss on 2x2
    and on a (2, 1, 2) pod mesh against JAX's unsharded loss, the same;
  - the 2x2 trainer against the port's meshless trainer (float32 compute:
    in bf16 each rank's half-batch weight gradient is rounded to bf16
    before the cross-rank sum, 2^-8 apart from the whole batch's): losses
    within 1e-5 relative, every master within 1e-6 of the largest |p| of
    all masters after 4 steps (a leaf whose gradient is zero in exact
    arithmetic, the attention's key bias, takes +-lr steps from rounding
    noise under AdamW, so its own largest |p| is no scale), for AdamW and
    for Adafactor (arctic smoke in float32: factored and unfactored leaves
    split over the mesh, the MoE load-balancing loss over the global
    batch); ``grad_spec_constraint`` (one reduce-scatter against an
    all-reduce and a slice) bit for bit;
  - the stored shards: exactly the global shapes divided over the axes of
    the JAX specs, Adafactor's states whole;
  - elastic resize (phi4-mini smoke in float32, 2x2 -> (1, 2), the other
    two ranks drop out): the two steps after it against a meshless run
    restored from the same checkpoint within 1e-5, every master within
    1e-6 of the largest |p| (no rank splits the batch on (1, 2), and the
    model axis splits the sequence: in bf16 each rank's partial weight
    gradients would be rounded apart, as the batch split's are);
    checkpoints cross the mesh, no mesh and the JAX trainer bit for bit.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jax_smoke
from repro.data import make_batch as jax_make_batch
from repro.distributed.sharding import make_plan as jax_make_plan
from repro.models import loss_fn as jax_loss
from repro.runtime import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro.checkpoint.manager import _flatten as jax_flatten
from repro_torch.checkpoint import flatten, load_arrays
from repro_torch.configs import get_smoke
from repro_torch.runtime import Trainer, TrainerConfig
from torch_dist_workers import mesh_resize, mesh_train, spawn
from torch_threads import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_2x2 = ((2, 2), ("data", "model"))
POD = ((2, 1, 2), ("pod", "data", "model"))
TCFG = dict(seq_len=32, global_batch=4, total_steps=20, warmup=2, ckpt_every=100)
JAX_TOL = 5e-3
LOSS_TOL = 1e-5
MASTER_TOL = 1e-6
STEPS = 4
FP32 = {"dtype": "float32"}

JAX_2x2 = """
import json, sys
import numpy as np
from repro.configs import get_smoke
from repro.launch.mesh import make_test_mesh
from repro.runtime import Trainer, TrainerConfig

d, steps = sys.argv[1], int(sys.argv[2])
t = Trainer(get_smoke("qwen2-1.5b"), TrainerConfig(**json.loads(sys.argv[3]), ckpt_dir=d),
            mesh=make_test_mesh((2, 2), ("data", "model")))
t.ckpt.maybe_save(t.state, 0, force=True)
t.ckpt.wait()
print(json.dumps(t.run(steps)["losses"]))
"""


def _jax_subprocess(code, args, devices=4):
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def _finish(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _jax_checkpoint(arch, d):
    """A JAX trainer's step-0 checkpoint of ``arch``'s smoke config in
    ``d``, and its unsharded loss on the pipeline's first batch."""
    cfg = jax_smoke(arch)
    jt = JaxTrainer(cfg, JaxTrainerConfig(**TCFG, ckpt_dir=d))
    jt.ckpt.maybe_save(jt.state, 0, force=True)
    jt.ckpt.wait()
    batch = {k: jnp.asarray(v) for k, v in jax_make_batch(cfg, TCFG["seq_len"],
                                                          TCFG["global_batch"], seed=0).items()}
    plan = jax_make_plan(None, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    return float(jax_loss(cfg, plan, jt.state.params, batch))


def _run(name, arch, over, shape_axes, steps, ckpt=None, **tcfg):
    return (name, arch, over, {**TCFG, **tcfg}, shape_axes[0], shape_axes[1], steps, ckpt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank runs of ``mesh_train`` (by rank) and the JAX numbers."""
    root = tmp_path_factory.mktemp("mesh")
    qwen_ckpt, gemma_ckpt = str(root / "qwen_jax"), str(root / "gemma_jax")
    jax_proc = _jax_subprocess(JAX_2x2, [qwen_ckpt, STEPS, json.dumps(TCFG)])
    gemma_loss = _jax_checkpoint("gemma3-4b", gemma_ckpt)
    jax_losses = _finish(jax_proc)
    by_rank = spawn(mesh_train, 4, root / "ranks", [
        _run("qwen2_jax", "qwen2-1.5b", {}, MESH_2x2, STEPS, qwen_ckpt),
        _run("qwen2", "qwen2-1.5b", FP32, MESH_2x2, STEPS),
        _run("qwen2_rs", "qwen2-1.5b", {**FP32, "grad_spec_constraint": True}, MESH_2x2, STEPS),
        _run("arctic", "arctic-480b", FP32, MESH_2x2, STEPS, optimizer="adafactor"),
        _run("gemma3", "gemma3-4b", {}, MESH_2x2, 1, gemma_ckpt),
        _run("gemma3_restored", "gemma3-4b", {}, MESH_2x2, 0, gemma_ckpt),
        _run("gemma3_pod", "gemma3-4b", {}, POD, 1, gemma_ckpt),
        _run("xlstm_ddp", "xlstm-350m", FP32, MESH_2x2, 2),
        _run("xlstm_seq", "xlstm-350m", FP32, MESH_2x2, 2, global_batch=2),
    ])
    return {"ranks": by_rank, "jax_qwen2": jax_losses, "jax_gemma3": gemma_loss,
            "gemma_ckpt": gemma_ckpt}


def _meshless(arch, over, steps, **tcfg):
    t = Trainer(dataclasses.replace(get_smoke(arch), **over),
                TrainerConfig(**{**TCFG, **tcfg}), device="cpu")
    out = t.run(steps)
    return out["losses"], flatten(t.state_tree())


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                        / np.abs(np.asarray(b, np.float64))))


def _master_err(got, want):
    """The largest |got - want| over every master, over the largest |p|."""
    keys = [k for k in want if k.startswith("0::")]
    scale = max(float(np.abs(want[k]).max()) for k in keys)
    return max(float(np.abs(got[k].astype(np.float64) - want[k]).max()) for k in keys) / scale


def test_the_2x2_trainer_matches_the_jax_2x2_trainer(runs):
    got = runs["ranks"][0]["qwen2_jax"]["losses"]
    assert len(got) == STEPS and np.all(np.isfinite(got))
    assert _rel(got, runs["jax_qwen2"]) < JAX_TOL, (got, runs["jax_qwen2"])


def test_every_rank_reports_the_global_loss(runs):
    for name in ("qwen2_jax", "qwen2", "arctic", "xlstm_ddp"):
        losses = [r[name]["losses"] for r in runs["ranks"]]
        assert all(x == losses[0] for x in losses), name


@pytest.mark.parametrize("name,arch,over,tcfg", [
    ("qwen2", "qwen2-1.5b", FP32, {}),
    ("arctic", "arctic-480b", FP32, {"optimizer": "adafactor"}),
    ("xlstm_ddp", "xlstm-350m", FP32, {}),
    ("xlstm_seq", "xlstm-350m", FP32, {"global_batch": 2}),
])
def test_the_2x2_trainer_matches_itself_without_a_mesh(runs, name, arch, over, tcfg):
    """AdamW and Adafactor under the ZeRO-3 plan, its model axis splitting
    the sequence; xlstm's smoke config (``seq_tp``: batch 4 or 2 over data,
    the sequence over model, the mLSTM / sLSTM gathering it)."""
    got = runs["ranks"][0][name]
    losses, tree = _meshless(arch, over, len(got["losses"]), **tcfg)
    assert _rel(got["losses"], losses) < LOSS_TOL, (got["losses"], losses)
    for r in runs["ranks"]:  # every rank gathers the same state
        assert _master_err(flatten(r[name]["tree"]), tree) < MASTER_TOL


def test_one_reduce_scatter_or_an_all_reduce_and_a_slice_give_the_same_numbers(runs):
    a, b = runs["ranks"][0]["qwen2"], runs["ranks"][0]["qwen2_rs"]
    assert a["losses"] == b["losses"]
    fa, fb = flatten(a["tree"]), flatten(b["tree"])
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def _want_shape(shape, spec, sizes):
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        out.append(n // int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


@pytest.mark.parametrize("name,arch,optimizer", [("qwen2", "qwen2-1.5b", "adamw"),
                                                 ("arctic", "arctic-480b", "adafactor"),
                                                 ("gemma3_pod", "gemma3-4b", "adamw")])
def test_each_rank_stores_only_its_shards_of_the_jax_specs(runs, name, arch, optimizer):
    """Every stored tensor's shape is the JAX leaf's (less a stacked leaf's
    unit dim) divided over the mesh axes of the JAX ``state_specs``."""
    from repro.optim import make_optimizer as jax_make_optimizer
    from repro.models import init_params as jax_init
    from repro.runtime.trainstep import state_specs as jax_state_specs, TrainState

    cfg = dataclasses.replace(jax_smoke(arch), **FP32)
    shape_axes = POD if name == "gemma3_pod" else MESH_2x2

    class Mesh:  # what JAX's make_plan reads of a mesh
        axis_names = shape_axes[1]
        devices = np.zeros(shape_axes[0])

    plan = jax_make_plan(Mesh(), n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                         prefer=cfg.attn_parallelism, global_batch=TCFG["global_batch"])
    opt = jax_make_optimizer(optimizer)
    shapes = jax.eval_shape(lambda: TrainState(
        jax_init(cfg, jax.random.PRNGKey(0)), opt.init(jax_init(cfg, jax.random.PRNGKey(0))),
        jnp.zeros((), jnp.int32)))
    specs = jax_state_specs(cfg, plan, shapes)
    sizes = dict(zip(shape_axes[1], shape_axes[0]))
    for r in runs["ranks"]:
        stored = r[name]["shards"]
        for part, tree, spec_tree in (("params", shapes.params, specs.params),
                                      ("opt_state", shapes.opt_state, specs.opt_state)):
            leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
            spec_of = dict(jax.tree_util.tree_flatten_with_path(
                spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
            got = stored[part]
            assert len(got) == len(leaves)
            for path, leaf in leaves:
                key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
                want = _want_shape(leaf.shape, spec_of[path], sizes)
                shapes_got = got[key]
                if "units" in key.split("/"):
                    assert shapes_got == [want[1:]] * leaf.shape[0], key
                else:
                    assert shapes_got == [want], key


def test_the_sharded_loss_matches_the_jax_unsharded_loss(runs):
    want = runs["jax_gemma3"]
    for name in ("gemma3", "gemma3_pod"):
        got = runs["ranks"][0][name]["losses"][0]
        assert abs(got - want) < JAX_TOL * max(1.0, abs(want)), (name, got, want)


def test_a_jax_checkpoint_restores_into_the_mesh_trainer(runs):
    saved = load_arrays(runs["gemma_ckpt"])
    for r in runs["ranks"]:
        got = flatten(r["gemma3_restored"]["tree"])
        assert sorted(got) == sorted(saved)
        assert all(np.array_equal(got[k], saved[k]) for k in saved)


# ---------------------------------------------------------------------------
# elastic resize
# ---------------------------------------------------------------------------

RESIZE_ARCH = "phi4-mini-3.8b"
RESIZE_TCFG = {**TCFG, "ckpt_every": 4}


@pytest.fixture(scope="module")
def resized(tmp_path_factory):
    root = tmp_path_factory.mktemp("resize")
    d = str(root / "ckpt")
    by_rank = spawn(mesh_resize, 4, root / "ranks", RESIZE_ARCH, FP32,
                    {**RESIZE_TCFG, "ckpt_dir": d}, MESH_2x2, 4, ((1, 2), ("data", "model")), 2)
    return {"ranks": by_rank, "ckpt": d, "root": root}


def test_resize_drops_the_ranks_outside_the_new_mesh(resized):
    assert [r["in_new_mesh"] for r in resized["ranks"]] == [True, True, False, False]
    for r in resized["ranks"]:
        assert len(r["before"]) == 4 and np.all(np.isfinite(r["before"]))


def test_the_steps_after_a_resize_match_a_meshless_run_from_the_same_checkpoint(resized):
    d = str(resized["root"] / "meshless")
    shutil.copytree(resized["ckpt"], d)
    t = Trainer(dataclasses.replace(get_smoke(RESIZE_ARCH), **FP32),
                TrainerConfig(**{**RESIZE_TCFG, "ckpt_dir": d}), device="cpu")
    assert t.restore_latest() == 4
    want = t.run(2)["losses"]
    for r in resized["ranks"][:2]:
        assert r["restored"] == 4
        assert _rel(r["after"], want) < LOSS_TOL, (r["after"], want)
        assert _master_err(flatten(r["tree"]), flatten(t.state_tree())) < MASTER_TOL


def test_a_mesh_checkpoint_restores_into_the_jax_and_the_meshless_trainer(resized):
    saved = load_arrays(resized["ckpt"])
    assert int(saved["2"]) == 4
    d = str(resized["root"] / "cross")
    shutil.copytree(resized["ckpt"], d)
    jt = JaxTrainer(jax_smoke(RESIZE_ARCH), JaxTrainerConfig(**{**RESIZE_TCFG, "ckpt_dir": d}))
    assert jt.restore_latest() == 4
    got = jax_flatten(jt.state)
    assert sorted(got) == sorted(saved)
    assert all(np.array_equal(np.asarray(got[k]), saved[k]) for k in saved)
    t = Trainer(get_smoke(RESIZE_ARCH), TrainerConfig(**{**RESIZE_TCFG, "ckpt_dir": d}),
                device="cpu")
    assert t.restore_latest() == 4
    mine = flatten(t.state_tree())
    assert all(np.array_equal(mine[k], saved[k]) for k in saved)


def test_chip_smoke_phase_47_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 47 on the CPU at the smoke config and B 2 x
    64: a world-1 gloo group (a ``FileStore``, no port), the 1x1 mesh
    against no mesh bit for bit, int8 compression and the psum, and at 2
    layers the checkpoint and the resize to a 1-D mesh reproducing step 2;
    the group is gone afterwards."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    detail = {}
    out = chip_smoke.mesh_phase(torch, detail, dev="cpu", cfg=get_smoke("qwen2-1.5b"),
                                shape=(2, 64))
    assert not torch.distributed.is_initialized()
    assert out["mesh"]["losses"] == out["meshless"]["losses"]
    assert out["masters_vs_meshless"] == 0.0 and out["resize"]["masters_err"] == 0.0
    assert out["resize"]["loss"] == out["resize"]["loss_before"]
    assert out["resize_layers"] == 2
    assert detail["mesh"] is out
