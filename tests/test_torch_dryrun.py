"""The dry-run on the CPU: the port's traces against the JAX package.

``repro_torch.launch.dryrun`` traces one rank's step on fake tensors as a
rank of a fake process group. Here it traces CPU fake tensors (the plain
versions, as every CPU test of the port runs them) and is held to:

  - JAX's ``_compile_cell`` on a 2x2 host mesh (a JAX subprocess with
    forced host devices: importing ``repro.launch.dryrun`` sets
    ``XLA_FLAGS``, so no test process imports it): the argument bytes of
    every smoke cell of ``CELLS`` at every rank equal XLA's
    ``memory_analysis().argument_size_in_bytes`` less what the port knowingly
    holds otherwise, each named: the step counter and the cache position,
    host ints in the port (JAX's int32 scalars, 4 bytes); the serving
    weights, which the port stores in the compute dtype where JAX serves
    its float32 masters; and recurrentgemma's tail state read by
    ``cache_leaf_spec`` as a stacked leaf (ROADMAP Queue C: JAX splits it
    over ``data``, the port holds it whole by batch rows);
  - a real step on a 2x2 gloo mesh (``torch_dist_workers.dryrun_cells``,
    four processes that trace the same cells as the same ranks once their
    real steps are done): the traced collectives equal the real ones, call
    for call and byte for byte, at every rank;
  - JAX's ``cell_applicable``, SKIP records, ``models.costs``, plans and
    chip counts for every (architecture x shape) cell on both production
    meshes, and JAX's ``collective_stats`` on ``tests/test_hlo_analysis.py``'s
    HLO sample;
  - the real CPU step at a 1x1 mesh: the traced FLOPs equal
    ``FlopCounterMode``'s and the traced peak the same tracker's.

Also: the kernels' fake forms, the refusals and the CLI at full width on
the ``(16, 16)`` fake mesh.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.costs import attention_flops as jax_attention_flops
from repro.models.costs import model_flops as jax_model_flops
from repro_torch.configs import ALIASES, get_config, get_smoke
from repro_torch.distributed import parallel as P
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import launch_counts
from repro_torch.kernels import rglru_scan as rg
from repro_torch.launch import comm_analysis
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import Model, param_leaves
from repro_torch.models.config import SHAPE_CELLS, ShapeCell
from repro_torch.models.costs import attention_flops, model_flops
from test_torch_distributed import ROOT, _finish, _jax_subprocess
from torch_dist_workers import dryrun_cells, spawn
from torch_threads import one_thread

one_thread()

MESH_2x2 = ((2, 2), ("data", "model"))
S, B = 32, 4
ARCHS = ("qwen2-1.5b", "gemma3-4b", "arctic-480b", "recurrentgemma-2b", "xlstm-350m")
#: name, arch, smoke-config overrides, kind, seq_len, global batch
CELLS = tuple((f"{arch}_{kind}", arch, {}, kind, S, B)
              for arch in ARCHS for kind in ("train", "prefill", "decode")) + (
    # one pattern unit and a tail layer at a batch of one: the tail's RG-LRU
    # state (1, width) has the shape of a stacked leaf of n_units 1
    ("recurrentgemma-2b_tail", "recurrentgemma-2b", {"n_layers": 4}, "decode", S, 1),)
#: the cells run for real on the gloo mesh too
REAL = tuple(c[0] for c in CELLS[:12])
#: the JAX cache leaf ``cache_leaf_spec`` reads as stacked, which the port
#: holds whole (its spec there: the width over ``data``)
TAIL_STATE = ("recurrentgemma-2b_tail", "tail/0/mixer/h")
#: the JAX cache leaf ``cache_leaf_spec`` reads as a KV cache (xlstm-350m's
#: mLSTM memory, its heads over ``model``), which the port's serving holds
#: by rows alone
MLSTM_MEMORY = ("xlstm-350m_decode", "units/p0/mixer/C")

JAX_DRYRUN = """
import dataclasses, json, sys
import numpy as np
from repro.launch import dryrun as JD
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ALIASES, get_config, get_smoke
from repro.distributed.sharding import make_plan
from repro.launch.mesh import make_production_mesh, make_test_mesh
from repro.models import cache_specs, init_params
from repro.models.config import SHAPE_CELLS, ShapeCell
from repro.runtime.trainstep import param_specs


def paths(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
            for p, v in flat}


def shard_bytes(mesh, leaf, spec):
    shape = NamedSharding(mesh, spec).shard_shape(leaf.shape)
    return int(np.prod(shape, dtype=np.int64)) * leaf.dtype.itemsize


mesh = make_test_mesh((2, 2), ("data", "model"))
out = {"cells": {}, "grid": {}}
for name, arch, over, kind, S, B in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(get_smoke(arch), **over)
    cell = ShapeCell(name, kind, S, B)
    plan = make_plan(mesh, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                     prefer=cfg.attn_parallelism, global_batch=B)
    compiled = JD._compile_cell(cfg, cell, mesh, plan)
    pshape = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    pspecs = paths(param_specs(cfg, plan, pshape), is_leaf=lambda x: isinstance(x, P))
    rec = {"argument_bytes": int(compiled.memory_analysis().argument_size_in_bytes),
           "params": {k: [shard_bytes(mesh, leaf, pspecs[k]), leaf.dtype.itemsize]
                      for k, leaf in paths(pshape).items()}}
    if kind == "decode":
        cs = cache_specs(cfg, plan, B, S + JD.DECODE_MARGIN)
        rec["cache"] = {k: [shard_bytes(mesh, leaf, leaf.sharding.spec),
                            int(np.prod(leaf.shape, dtype=np.int64)) * leaf.dtype.itemsize,
                            [a if a is None or isinstance(a, str) else list(a)
                             for a in leaf.sharding.spec]]
                        for k, leaf in paths(cs).items()}
    out["cells"][name] = rec
for arch in ALIASES:
    cfg = get_config(arch)
    for c in SHAPE_CELLS:
        ok, why = JD.cell_applicable(cfg, c.name)
        g = {"applicable": ok, "reason": why}
        for mp, tag in ((False, "singlepod"), (True, "multipod")):
            plan = make_plan(make_production_mesh(multi_pod=mp), n_heads=cfg.n_heads,
                             n_kv_heads=cfg.n_kv_heads, prefer=cfg.attn_parallelism,
                             global_batch=c.global_batch)
            g["attn_mode_" + tag] = plan.attn_mode
            if not ok:
                g["record_" + tag] = JD.lower_cell(arch, c.name, multi_pod=mp)
        out["grid"][arch + "|" + c.name] = g
print(json.dumps(out))
"""

CLI = ("qwen2-1.5b", "decode_32k")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """At once: the JAX subprocess, the four gloo ranks (real steps, then
    traces) and the CLI on one full-width production cell."""
    root = tmp_path_factory.mktemp("dryrun")
    jax_proc = _jax_subprocess(JAX_DRYRUN, [json.dumps(CELLS)])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", CLI[0], "--shape", CLI[1],
         "--both-meshes", "--device", "cpu", "--out", str(root / "records")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    ranks = spawn(dryrun_cells, 4, root / "ranks", CELLS, *MESH_2x2, REAL, timeout=240)
    jx = _finish(jax_proc, 300)
    out, err = cli.communicate(timeout=300)
    assert cli.returncode == 0, err[-3000:]
    return {"ranks": ranks, "jax": jx, "cli": out, "records": root / "records"}


def _cell(name):
    return next(c for c in CELLS if c[0] == name)


def _axes(entry) -> list:
    """A JAX spec entry's mesh axes (a name, a list of names or None)."""
    return [] if entry is None else [entry] if isinstance(entry, str) else list(entry)


def _port_itemsizes(cfg) -> dict:
    """Each serving leaf's element size in the port (``Model`` without
    ``trainable`` stores the matrices in the compute dtype)."""
    return {k: ts[0].element_size() for k, ts in param_leaves(Model(cfg, device="meta")).items()}


@pytest.mark.parametrize("name", [c[0] for c in CELLS])
def test_argument_bytes_are_jax_s_at_every_rank(runs, name):
    _, arch, over, kind, _, _ = _cell(name)
    jx = runs["jax"]["cells"][name]
    want = jx["argument_bytes"]
    if kind in ("train", "decode"):
        want -= 4  # the step counter / the cache position: a host int in the port
    if kind != "train":
        # JAX serves from its float32 masters, the port from weights in the
        # compute dtype: each leaf's shard at the port's element size
        sizes = _port_itemsizes(get_smoke(arch, **over))
        assert set(sizes) == set(jx["params"])
        want -= sum(n - n // item * sizes[k] for k, (n, item) in jx["params"].items())
        assert any(sizes[k] < item for k, (_, item) in jx["params"].items())
    if name == TAIL_STATE[0]:
        shard, whole, spec = jx["cache"][TAIL_STATE[1]]
        assert [_axes(a) for a in spec] == [[], ["data"]] and whole == 2 * shard
        want += whole - shard  # held whole by the port
    if name == MLSTM_MEMORY[0]:
        shard, whole, spec = jx["cache"][MLSTM_MEMORY[1]]
        assert [_axes(a) for a in spec] == [[], ["data"], ["model"], [], []]
        want += whole // 2 - shard  # the port splits its rows over data alone
    got = [r["traced"][name]["argument_bytes"] for r in runs["ranks"]]
    assert got == [want] * 4


def test_only_the_named_cache_leaf_parts_from_jax_s_rule(runs):
    """Every other decode cache leaf's spec splits the batch rows and, for a
    KV cache, the slots, as the port's cache does."""
    for name, *_ in CELLS:
        for leaf, (_, _, spec) in runs["jax"]["cells"][name].get("cache", {}).items():
            if (name, leaf) not in (TAIL_STATE, MLSTM_MEMORY) and spec:
                assert spec[-1] is None and all(_axes(a) in ([], ["model"], ["data"])
                                                for a in spec)


@pytest.mark.parametrize("name", REAL)
def test_traced_collectives_are_the_real_step_s(runs, name):
    for r in runs["ranks"]:
        traced, real = r["traced"][name], r["real"][name]
        assert traced["counts"] == real["counts"]
        assert traced["result_bytes"] == real["result_bytes"]
        assert traced["launches"] == {}
    assert runs["ranks"][0]["traced"][name]["counts"]  # a 2x2 step communicates


def test_arctic_traces_at_every_rank(runs):
    """arctic-480b's MoE load count has a shape that does not depend on the
    routes, so its smoke cells trace (``torch.bincount`` did not)."""
    for kind in ("train", "prefill", "decode"):
        for r in runs["ranks"]:
            t = r["traced"][f"arctic-480b_{kind}"]
            assert t["flops"] > 0 and t["peak_bytes"] > t["argument_bytes"] > 0


def test_the_grid_is_jax_s(runs):
    """Every (architecture x shape) cell: applicable or skipped for JAX's
    reason (the whole SKIP record is JAX's, less the port's ``rank`` and
    ``device``), the analytic FLOPs, and the plan's mode on both meshes."""
    grid = runs["jax"]["grid"]
    assert len(grid) == len(ALIASES) * len(SHAPE_CELLS) == 40
    for multi_pod, tag in ((False, "singlepod"), (True, "multipod")):
        with D.fake_group(512 if multi_pod else 256, 0):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            for arch in ALIASES:
                cfg = get_config(arch)
                for c in SHAPE_CELLS:
                    g = grid[f"{arch}|{c.name}"]
                    assert D.cell_applicable(cfg, c.name) == (g["applicable"], g["reason"])
                    assert D._plan(cfg, c, mesh).attn_mode == g["attn_mode_" + tag]
        for arch in ALIASES:
            for c in SHAPE_CELLS:
                g = grid[f"{arch}|{c.name}"]
                if not g["applicable"]:
                    rec = D.lower_cell(arch, c.name, multi_pod=multi_pod, device="cpu")
                    assert rec.pop("rank") == 0 and rec.pop("device") == "cpu"
                    assert rec == g["record_" + tag]
    skipped = [k for k, g in grid.items() if not g["applicable"]]
    assert skipped and all(k.endswith("long_500k") for k in skipped)
    for arch in ALIASES:
        for c in SHAPE_CELLS:
            cfg, jcfg = get_config(arch), jax_config(arch)
            assert model_flops(cfg, c) == jax_model_flops(jcfg, c)
            assert attention_flops(cfg, c) == jax_attention_flops(jcfg, c)


def test_the_cli_writes_an_ok_record_at_full_width(runs):
    """``python -m repro_torch.launch.dryrun`` at full width on the
    ``(16, 16)`` fake mesh: an OK record under JAX's file name, with JAX's
    keys where they mean the same and the renamed ones; and on the
    ``(2, 16, 16)`` one, 512 chips in JAX's plan."""
    arch, shape = CLI
    assert f"{arch:20s} {shape:12s} 16x16    OK" in runs["cli"]
    assert f"{arch:20s} {shape:12s} 2x16x16  OK" in runs["cli"]
    with open(runs["records"] / "qwen2-1_5b__decode_32k__multipod.json") as f:
        multi = json.load(f)
    assert (multi["status"], multi["n_chips"], multi["mesh"]) == ("OK", 512, "2x16x16")
    assert multi["attn_mode"] == runs["jax"]["grid"][f"{arch}|{shape}"]["attn_mode_multipod"]
    with open(runs["records"] / "qwen2-1_5b__decode_32k__singlepod.json") as f:
        rec = json.load(f)
    cfg = get_config(arch)
    cell = next(c for c in SHAPE_CELLS if c.name == shape)
    g = runs["jax"]["grid"][f"{arch}|{shape}"]
    assert rec["status"] == "OK" and rec["n_chips"] == 256 and rec["mesh"] == "16x16"
    assert (rec["rank"], rec["device"]) == (0, "cpu")
    assert rec["attn_mode"] == g["attn_mode_singlepod"]
    roof = rec["roofline"]
    assert roof["model_flops_total"] == jax_model_flops(cfg, cell)
    assert roof["attention_flops_total"] == jax_attention_flops(cfg, cell)
    for key in ("compile_seconds", "calibration_seconds", "hlo_flops_total"):
        assert key not in rec and key not in roof
    assert "transcendentals" not in rec["cost_analysis"]
    mem = rec["memory_analysis"]
    assert set(mem) == {"argument_bytes_per_device", "temp_bytes_per_device",
                        "peak_bytes_per_device", "fits_hbm", "hbm_budget_bytes"}
    assert mem["peak_bytes_per_device"] == (mem["argument_bytes_per_device"]
                                            + mem["temp_bytes_per_device"]) > 0
    assert mem["hbm_budget_bytes"] == 80 * 2**30 and mem["fits_hbm"]
    assert rec["trace_seconds"] > 0 and rec["collectives"]["calibrated"] is False
    assert roof["counted_flops_total"] == rec["cost_analysis"]["flops_per_device"] * 256
    terms = {k: roof[k] for k in ("compute_s", "memory_s", "collective_s")}
    assert roof["bottleneck"] == max(terms, key=terms.get)
    assert roof["step_time_s_max_term"] == max(terms.values())
    per_op = rec["collectives"]["per_op"]
    assert per_op["all-gather"]["count"] > 0 and rec["kernels"]["launches"] == {}


def test_collective_stats_is_jax_s_on_the_hlo_sample():
    """``tests/test_hlo_analysis.py``'s HLO written as the port's counts:
    the all-gather and the tuple all-gather-start (operands p0 and small,
    results the gathered tensor and the tuple), the all-reduce, the
    reduce-scatter and the all-to-all of p0."""
    from repro.launch.hlo_analysis import collective_stats as jax_stats
    from test_hlo_analysis import HLO

    p0, small = 128 * 512 * 2, 16 * 4 * 2
    counts = {"all_gather": [2, p0 + small], "all_reduce": [1, p0],
              "reduce_scatter": [1, p0], "all_to_all": [1, p0]}
    results = {"all_gather": 2048 * 512 * 2 + (16 * 4 + 64 * 4) * 2, "all_reduce": p0,
               "reduce_scatter": 64 * 512 * 2, "all_to_all": p0}
    assert comm_analysis.collective_stats(counts, results) == jax_stats(HLO)


def test_collective_stats_reads_the_counter_by_default():
    P.reset_counts()
    try:
        P._count("all_gather", torch.zeros(4), torch.zeros(8))
        P._count("all_reduce_max", torch.zeros(2), torch.zeros(2))
        st = comm_analysis.collective_stats()
    finally:
        P.reset_counts()
    assert st["per_op"] == {"all-gather": {"count": 1, "operand_bytes": 16, "wire_bytes": 32},
                            "all-reduce": {"count": 1, "operand_bytes": 8, "wire_bytes": 16}}
    assert (st["n_collectives"], st["wire_bytes_per_device"]) == (2, 48)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_tracing_changes_nothing(arch, kind):
    """At a 1x1 fake mesh the trace's FLOPs are ``FlopCounterMode``'s and
    its peak the same tracker's around the real CPU step on the same
    (uninitialised) state."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_smoke(arch)
    cell = ShapeCell("s", kind, S, 2)
    dev = torch.device("cpu")
    with D.fake_group(1, 0):
        mesh = make_test_mesh((1, 1), device_type="cpu")
        plan = D._plan(cfg, cell, mesh)
        traced = D._trace_cell(cfg, cell, mesh, plan, rank=0, device="cpu")
        step, args = D._state(cfg, cell, mesh, plan, dev)
        tally = D._Tally(args)
        del args
        with tally:
            step()
        step, _ = D._state(cfg, cell, mesh, plan, dev)
        with FlopCounterMode(display=False) as flops:
            step()
    assert traced["flops"] == flops.get_total_flops() == tally.flops > 0
    assert (traced["argument_bytes"], traced["peak_bytes"]) == (tally.argument_bytes, tally.peak)
    assert traced["peak_bytes"] > traced["argument_bytes"] > 0


def _visible(Sq, Sk, causal, window, off):
    pos = off + torch.arange(Sq)[:, None]
    key = torch.arange(Sk)[None, :]
    seen = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        seen &= key <= pos
    if window is not None:
        seen &= pos - key < window
    return int(seen.sum())


@pytest.mark.parametrize("causal,window,off", [(True, None, 0), (True, 24, 0), (True, 24, 40),
                                               (False, None, 0), (False, 8, 16)])
def test_the_flash_fake_form(causal, window, off):
    """The op's fake form gives the plain version's shape and dtype,
    launches nothing, is counted, and the FLOP formula counts 4 D for each
    visible pair of each query head."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    Bq, Hq, Hkv, Sq, Sk, Dh = 2, 4, 2, 40, 80, 16
    q = torch.randn(Bq, Hq, Sq, Dh, dtype=torch.bfloat16)
    k = torch.randn(Bq, Hkv, Sk, Dh, dtype=torch.bfloat16)
    want = fa.flash_attention_plain(q, k, k, causal=causal, window=window, q_offset=off)
    launches, calls = launch_counts(), fa.flash_attention.fake_calls
    with FakeTensorMode() as mode:
        fq, fk = mode.from_tensor(q), mode.from_tensor(k)
        with FlopCounterMode(display=False) as flops:
            out = torch.ops.repro_torch.flash_attention(fq, fk, fk, causal, window, off)
    assert (out.shape, out.dtype) == (want.shape, want.dtype)
    assert fa.flash_attention.fake_calls == calls + 1 and launch_counts() == launches
    pairs = _visible(Sq, Sk, causal, window, off)
    assert fa.visible_pairs(Sq, Sk, causal, window, off) == pairs > 0
    assert flops.get_total_flops() == Bq * Hq * pairs * 4 * Dh


def test_the_rglru_fake_forms():
    """The forward's and the backward's fake forms give the plain versions'
    shapes and dtypes, launch nothing and are counted; the card's branch
    (``_scan(..., on_card=True)``) reaches the forward's through the
    autograd Function, whose backward routes by device (CPU fake tensors:
    the plain version)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    a = torch.rand(2, 12, 8)
    b, h0, dh = torch.randn(2, 12, 8), torch.randn(2, 8), torch.randn(2, 12, 8)
    h = rg.rglru_scan_plain(a, b, h0)
    grads = rg.rglru_scan_backward_plain(a, h, h0, dh)
    launches = launch_counts()
    fwd, bwd = rg.rglru_scan.fake_calls, rg.rglru_scan_backward.fake_calls
    with FakeTensorMode() as mode:
        fa_, fb, fh0, fh, fdh = (mode.from_tensor(t) for t in (a, b, h0, h, dh))
        out = torch.ops.repro_torch.rglru_scan(fa_, fb, fh0)
        g = torch.ops.repro_torch.rglru_scan_backward(fa_, fh, fh0, fdh)
        leaves = [t.clone().requires_grad_() for t in (fa_, fb)]
        rg._scan(*leaves, fh0, True).sum().backward()
    assert (out.shape, out.dtype) == (h.shape, h.dtype)
    assert [(t.shape, t.dtype) for t in g] == [(t.shape, t.dtype) for t in grads]
    assert leaves[0].grad.shape == a.shape and leaves[1].grad.shape == b.shape
    assert rg.rglru_scan.fake_calls == fwd + 2
    assert rg.rglru_scan_backward.fake_calls == bwd + 1
    assert launch_counts() == launches


def test_a_group_already_up_is_refused():
    with D.fake_group(4, 1):
        with pytest.raises(RuntimeError, match="already initialised"):
            D.lower_cell("qwen2-1.5b", "decode_32k", multi_pod=False, device="cpu")


def test_cuda_without_a_card_is_refused(monkeypatch, tmp_path):
    """``device="cuda"`` (the default) on a machine without CUDA raises,
    rather than tracing the CPU's path; ``run_and_save`` records it as a
    ``FAIL`` with the error, under JAX's file name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="sees no CUDA device"):
        D.lower_cell("qwen2-1.5b", "decode_32k", multi_pod=False)
    rec = D.run_and_save("qwen2-1.5b", "decode_32k", True, tag="t", out_dir=str(tmp_path))
    assert rec["status"] == "FAIL" and "sees no CUDA device" in rec["error"]
    assert os.path.exists(tmp_path / "qwen2-1_5b__decode_32k__multipod_t.json")


def test_chip_smoke_phase_50_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.py``'s phase 50 on the CPU with smoke cells of its
    phases' configs and short sequences: the dry-run's process traces them
    (and no production cell), and the gates hold against phases 47-49's
    records, stood in for by this process's own traces of the same cells
    (the peak at 5% off)."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    blocked = {"attention_impl": "blocked", "attention_block_q": 8, "attention_block_kv": 16}
    cells = [("47", get_smoke("qwen2-1.5b"), ShapeCell("47", "train", 32, 2), (1, 1), (0,)),
             ("48", get_smoke("recurrentgemma-2b", dtype="float32", remat="full"),
              ShapeCell("48", "train", 32, 2), (1, 2), (0, 1)),
             ("49_prefill", get_smoke("gemma3-4b", **blocked), ShapeCell("49", "prefill", 32, 4),
              (1, 2), (0, 1)),
             ("49_decode", get_smoke("gemma3-4b", **blocked), ShapeCell("49", "decode", 32, 4),
              (1, 2), (0, 1))]
    here = {}
    for name, cfg, cell, shape, ranks in cells:
        for r in ranks:
            with D.fake_group(shape[0] * shape[1], r):
                mesh = make_test_mesh(shape, ("data", "model"), device_type="cpu")
                here[name, r] = D._trace_cell(cfg, cell, mesh, D._plan(cfg, cell, mesh),
                                              rank=r, device="cpu")
    mesh_t = {"mesh": {"peak_memory_gb": here["47", 0]["peak_bytes"] * 1.05 / 1e9,
                       "step_s": [1.0, 1.0]}}
    # on the CPU the RG-LRU and flash run their plain versions: the fake
    # forms are not called, and the phases' records say so
    split_t = {"ranks": [{"collectives": [here["48", r]["counts"]], "rglru": [[0, 0]]}
                         for r in (0, 1)]}
    serve_t = {"ranks": [{"collectives": here["49_decode", r]["counts"],
                          "flash": {"prefill": 0, "decode": 0}} for r in (0, 1)]}
    # every gate holds but the fake forms' (none on the CPU: the phases on
    # the card call them)
    monkeypatch.setattr(cs, "check", lambda cond, what: None if cond or "fake forms" in what
                        else pytest.fail(what))
    detail = {}
    out = cs.dryrun_phase(torch, detail, mesh_t, split_t, serve_t, dev="cpu", cells=cells,
                          production=None)
    assert abs(out["peak_rel_err"] - 0.05 / 1.05) < 1e-9
    for (name, r), t in here.items():
        assert out["cells"][name][r]["counts"] == t["counts"]
        assert out["cells"][name][r]["peak_bytes"] == t["peak_bytes"]
    assert not any(out["launches"].values()) and detail["dryrun"] is out
