"""Multi-rank runs of the port on the CPU for the tests: gloo processes.

:func:`spawn` starts ``nprocs`` processes with ``torch.multiprocessing``'s
``spawn`` method, each on one torch thread, joined to one gloo group
through a ``file://`` rendezvous in the test's temporary directory (no TCP
port, so parallel test workers cannot collide; a function may destroy the
group itself, as :func:`dryrun_cells` does to trace with a fake one). Each runs
``fn(rank, world, out_dir, *args)``, a function of this module (the
children import it by name, and it imports no JAX), and writes what it
returns to ``out_dir/rank<r>.pt``; :func:`spawn` returns those results by
rank. A child's exception fails the call with the child's traceback; a run
that outlasts ``timeout`` seconds is killed and fails.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn_name, world, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous",
                            rank=rank, world_size=world)
    try:
        result = globals()[fn_name](rank, world, out_dir, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, out_dir, *args, timeout: float = 120.0) -> list:
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(fn.__name__, nprocs, out_dir, args),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f"{fn.__name__} on {nprocs} ranks outlasted {timeout} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(nprocs)]


# ---------------------------------------------------------------------------
# the compressed gradient exchange
# ---------------------------------------------------------------------------


def compressed_psum(rank, world, out_dir, rows):
    """``compressed_psum_tree`` of this rank's row of ``rows`` over the
    world: two steps, the second carrying the first's error."""
    from repro_torch.optim.compress import compressed_psum_tree, init_error_state

    g = {"w": [torch.from_numpy(np.asarray(rows[rank:rank + 1], np.float32))]}
    err = init_error_state(g)
    red1, err1 = compressed_psum_tree(g, err)
    red2, err2 = compressed_psum_tree(g, err1)
    return {"red": [red1["w"][0].numpy(), red2["w"][0].numpy()],
            "err": [err1["w"][0].numpy(), err2["w"][0].numpy()]}


# ---------------------------------------------------------------------------
# the mesh trainer
# ---------------------------------------------------------------------------


def _cfg(arch, over):
    from repro_torch.configs import get_smoke

    return dataclasses.replace(get_smoke(arch), **over)


def _mesh(shape, axes):
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh(tuple(shape), tuple(axes))


def _shards(trainer) -> dict:
    """Each stored tensor's shape by leaf, params and optimizer states."""
    st = trainer.state
    return {"params": {k: [tuple(t.shape) for t in ts] for k, ts in st.params.items()},
            "opt_state": {k: [tuple(t.shape) for t in ts] for k, ts in st.opt_state.items()}}


def mesh_train(rank, world, out_dir, runs):
    """Each run of ``runs`` (``name, arch, over, tcfg, shape, axes, steps,
    ckpt``): a ``Trainer`` on the mesh, restored from ``ckpt`` when given,
    trained ``steps``; returns by name its losses, grad norms, stored
    shard shapes and (from every rank) the whole state tree."""
    from repro_torch.runtime import Trainer, TrainerConfig

    out = {}
    for name, arch, over, tcfg, shape, axes, steps, ckpt in runs:
        if ckpt:
            tcfg = {**tcfg, "ckpt_dir": ckpt}
        t = Trainer(_cfg(arch, over), TrainerConfig(**tcfg), mesh=_mesh(shape, axes),
                    device="cpu")
        if ckpt:
            t.restore_latest()
        res = t.run(steps)
        out[name] = {"losses": res["losses"], "shards": _shards(t),
                     "tree": t.state_tree(), "coordinate": t.mesh.get_coordinate()}
    return out


def mesh_resize(rank, world, out_dir, arch, over, tcfg, first, steps_before, second,
                steps_after):
    """Train ``arch`` (its smoke config with ``over``) on mesh ``first``
    with checkpoints, ``resize`` to ``second`` (a mesh of fewer ranks: the
    others drop out), train on. Returns the losses before and after, the
    step the resize restored and the state tree after (on the ranks that
    stay)."""
    from repro_torch.runtime import Trainer, TrainerConfig

    t = Trainer(_cfg(arch, over), TrainerConfig(**tcfg), mesh=_mesh(*first), device="cpu")
    before = t.run(steps_before)["losses"]
    t.resize(_mesh(*second))
    if t.state is None:
        return {"in_new_mesh": False, "before": before}
    restored = t.state.step
    after = t.run(steps_after)["losses"]
    return {"in_new_mesh": True, "before": before, "restored": restored, "after": after,
            "tree": t.state_tree()}


# ---------------------------------------------------------------------------
# the compute split over the model axis
# ---------------------------------------------------------------------------


class _Shapes(torch.overrides.TorchFunctionMode):
    """Records the shapes the split's computations run at: each attention
    score einsum's query heads (the grouped einsum's KV heads times group)
    and each ``torch.bmm``'s operands (the MoE experts' products)."""

    def __init__(self):
        super().__init__()
        self.heads, self.bmm = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.einsum and args[0] == "bskgd,btkd->bkgst":
            self.heads.append(int(args[1].shape[2] * args[1].shape[3]))
        elif func is torch.bmm:
            self.bmm.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


def split_train(rank, world, out_dir, runs):
    """``mesh_train``'s runs, each with its first step watched: every
    ``Block``'s input shape (forward pre-hooks, encoder and decoder), the
    query heads of every attention score product and the operand shapes of
    every ``torch.bmm`` (:class:`_Shapes`)."""
    from repro_torch.runtime import Trainer, TrainerConfig

    out = {}
    for name, arch, over, tcfg, shape, axes, steps, ckpt in runs:
        if ckpt:
            tcfg = {**tcfg, "ckpt_dir": ckpt}
        t = Trainer(_cfg(arch, over), TrainerConfig(**tcfg), mesh=_mesh(shape, axes),
                    device="cpu")
        if ckpt:
            t.restore_latest()
        model = t.state.model
        blocks = []
        hooks = [m.register_forward_pre_hook(lambda mod, args: blocks.append(
            tuple(args[0].shape))) for m in model.modules() if type(m).__name__ == "Block"]
        with _Shapes() as seen:
            first = t.run(1)["losses"]
        for h in hooks:
            h.remove()
        res = t.run(steps - 1)
        out[name] = {"losses": first + res["losses"], "tree": t.state_tree(),
                     "blocks": blocks, "heads": seen.heads, "bmm": seen.bmm,
                     "coordinate": t.mesh.get_coordinate()}
    return out


def collectives(rank, world, out_dir):
    """Every collective of ``repro_torch.distributed.parallel`` on the world
    (float64, seeded per rank), forward and backward, and on a group of
    this rank alone; returns the inputs, outputs and gradients by name for
    the test to hold against their definitions."""
    from repro_torch.distributed import parallel as P
    from repro_torch.distributed.sharding import Block

    class View:  # the model axis as the whole world
        group = dist.group.WORLD

    sp = P.Split(View(), Block(4 * rank, 4 * rank + 4))
    whole = P.Split(View(), None)  # the sequence not split
    g = torch.Generator().manual_seed(rank)
    f64 = {"dtype": torch.float64, "generator": g}
    out = {}
    for name, fn, split, shape in (("gather_seq", P.gather_seq, sp, (2, 4, 3)),
                                   ("keep_seq", P.keep_seq, sp, (2, 4 * world, 3)),
                                   ("scatter_sum", P.scatter_sum, sp, (2, 4 * world, 3)),
                                   ("sum_all", P.scatter_sum, whole, (2, 4 * world, 3))):
        x = torch.randn(shape, **f64).requires_grad_()
        y = fn(x, split)
        dy = torch.randn(y.shape, **f64)
        y.backward(dy)
        out[name] = {"x": x.detach(), "y": y.detach(), "dy": dy, "dx": x.grad}
    # the primitives along other dims
    x = torch.randn((3, 2 * world, 5), **f64)
    out["all_gather_dims"] = {"x": x, "y": [P.all_gather(x, d, dist.group.WORLD)
                                            for d in range(3)]}
    z = torch.randn((world * 2, world * 2, world * 2), **f64)
    out["reduce_scatter_dims"] = {"x": z, "y": [P.reduce_scatter(z, d, dist.group.WORLD)
                                                for d in range(3)]}
    # each rank alone: every collective the identity
    alone = [dist.new_group([r]) for r in range(world)][rank]

    class Alone:
        group = alone

    one = P.Split(Alone(), Block(0, 4))
    x = torch.randn((2, 4, 3), **f64)
    out["alone"] = {"x": x, "ys": [P.all_gather(x, 1, alone), P.reduce_scatter(x, 1, alone),
                                   P.all_reduce_(x.clone(), alone), P.gather_seq(x, one),
                                   P.scatter_sum(x, one)]}
    return out


# ---------------------------------------------------------------------------
# serving on a mesh
# ---------------------------------------------------------------------------


def _serve_run(cfg, params, mesh, prompts, frames, steps, cache_len) -> dict:
    """The model of ``params`` (the JAX layout, numpy) placed on ``mesh``:
    a prefill of the global batch's ``prompts`` (this rank's rows), then
    ``steps`` greedy decode steps; the tokens, each step's logits (the
    prefill's last position first) and the final cache gathered whole, in
    the JAX layout, and this rank's blocks of the first attention cache."""
    from repro_torch.interop import cache_to_jax, gather_cache, model_from_jax
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import decode_step, prefill
    from repro_torch.runtime import place_on_mesh

    model = place_on_mesh(model_from_jax(cfg, params, device="cpu"), mesh, prompts.shape[0])
    rows = model.rows
    p = rows.rows(torch.from_numpy(prompts).long())
    f = rows.rows(torch.from_numpy(frames)) if frames is not None else None
    out = {"tokens": None, "logits": [], "error": None, "local_kv": None}
    with torch.inference_mode():
        cache, logits = prefill(model, prompt_batch(model, p, f), cache_len)
        kv = [c for c in cache["layers"] if "k" in c]
        out["local_kv"] = tuple(kv[0]["k"].shape) if kv else None
        toks = []
        try:
            for _ in range(steps + 1):
                out["logits"].append(rows.gather(logits).numpy())
                tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
                toks.append(tok)
                if len(toks) <= steps:
                    cache, logits = decode_step(model, cache, tok)
        except ValueError as e:
            out["error"] = str(e)
            return out
        out["tokens"] = rows.gather(torch.cat(toks, dim=1)).numpy()
        out["cache"] = cache_to_jax(model, gather_cache(model, cache))
    return out


def _combine_case(group, index: int, parts: int, dead: bool) -> dict:
    """``parallel.softmax_combine`` on this rank's block (``index`` of
    ``parts``) of seeded scores (float64) over 12 keys; with ``dead`` the
    last rank's keys are all masked. Returns the whole inputs and the
    output for the test to hold against one softmax over every key."""
    from repro_torch.distributed import parallel as P
    from repro_torch.models.layers import NEG_INF

    g = torch.Generator().manual_seed(7)
    B, Hkv, G, T, D = 2, 2, 3, 12 * parts, 5
    scores = torch.randn((B, Hkv, G, 1, T), generator=g, dtype=torch.float64)
    v = torch.randn((B, T, Hkv, D), generator=g, dtype=torch.float64)
    valid = torch.rand(T, generator=g) < 0.7
    valid[0] = True
    if dead:
        valid[T - 12:] = False
    masked = scores.masked_fill(~valid, NEG_INF)
    blk = slice(index * 12, (index + 1) * 12)
    got = P.softmax_combine(masked[..., blk].clone(), v[:, blk], group, torch.float64)
    return {"scores": masked, "v": v, "out": got}


def mesh_serve(rank, world, out_dir, runs, shape, axes):
    """Each run of ``runs`` (``name, arch, over, steps, cache_len``) served on
    a ``shape`` mesh from ``out_dir/<name>.pt`` (the JAX params as numpy,
    the prompts and an encoder model's frames): :func:`_serve_run`'s
    results by name, and the decode combine on the model axis's ranks
    (``combine``, ``combine_dead``) with the rank's coordinate."""
    mesh = _mesh(shape, axes)
    out = {"coordinate": mesh.get_coordinate()}
    for name, arch, over, steps, cache_len in runs:
        data = torch.load(os.path.join(out_dir, f"{name}.pt"), weights_only=False)
        out[name] = _serve_run(_cfg(arch, over), data["params"], mesh, data["prompts"],
                               data["frames"], steps, cache_len)
    # the launcher's generate on the first case: the global batch's prompts
    # in, the whole batch's tokens out on every rank, with its collectives
    from repro_torch.interop import model_from_jax
    from repro_torch.launch.serve import generate
    from repro_torch.runtime import place_on_mesh

    name, arch, over, steps, _ = runs[0]
    data = torch.load(os.path.join(out_dir, f"{name}.pt"), weights_only=False)
    model = place_on_mesh(model_from_jax(_cfg(arch, over), data["params"], device="cpu"), mesh,
                          data["prompts"].shape[0])
    with torch.inference_mode():
        toks, rec = generate(model, torch.from_numpy(data["prompts"]).long(), steps)
    out["generate"] = {"tokens": toks.numpy(), "rows": rec["rows"],
                       "prefill_collectives": rec["prefill_collectives"],
                       "decode_collectives": rec["decode_collectives"]}
    m = list(axes).index("model")
    group, index = mesh.get_group(m), mesh.get_coordinate()[m]
    out["combine"] = _combine_case(group, index, shape[m], dead=False)
    out["combine_dead"] = _combine_case(group, index, shape[m], dead=True)
    return out


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------


def _real_counts(cfg, mesh, kind, S, B) -> dict:
    """The collectives of one real step of ``kind`` on ``mesh`` as the
    dry-run's cell (``prefill`` / ``decode`` on a model drawn meshless and
    placed, the decode after a prefill of S): by kind [calls, input bytes]
    and the result bytes."""
    from repro_torch.distributed import parallel as P
    from repro_torch.launch.dryrun import DECODE_MARGIN
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.runtime import Trainer, TrainerConfig, place_on_mesh

    def counts():
        return {"counts": {k: list(v) for k, v in P.COUNTS.items()},
                "result_bytes": dict(P.RESULT_BYTES)}

    if kind == "train":
        t = Trainer(cfg, TrainerConfig(seq_len=S, global_batch=B, optimizer=cfg.optimizer),
                    mesh=mesh, device="cpu")
        P.reset_counts()
        t.run(1)
        return counts()
    model = place_on_mesh(init_params(cfg, torch.Generator().manual_seed(0)), mesh, B)
    rows = B // model.rows.blocks
    with torch.inference_mode():
        P.reset_counts()
        cache, _ = prefill(model, {"tokens": torch.zeros((rows, S), dtype=torch.int32)},
                           S + DECODE_MARGIN)
        if kind == "prefill":
            return counts()
        P.reset_counts()
        decode_step(model, cache, torch.zeros((rows, 1), dtype=torch.int32))
        return counts()


def dryrun_cells(rank, world, out_dir, cells, shape, axes, real):
    """Each cell of ``cells`` (``name, arch, over, kind, S, B``): one real
    step's collectives on this rank of the gloo ``shape`` mesh (the cells
    named in ``real``); then, the gloo group destroyed, this rank's trace
    of every cell (``launch.dryrun._trace_cell``) as the same rank of a
    fake group of the same size, on CPU fake tensors. Returns both by
    name."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.config import ShapeCell

    out = {"real": {}, "traced": {}}
    mesh = _mesh(shape, axes)
    for name, arch, over, kind, S, B in cells:
        if name in real:
            out["real"][name] = _real_counts(_cfg(arch, over), mesh, kind, S, B)
    dist.barrier()
    dist.destroy_process_group()
    for name, arch, over, kind, S, B in cells:
        cfg, cell = _cfg(arch, over), ShapeCell(name, kind, S, B)
        with D.fake_group(world, rank):
            mesh = make_test_mesh(tuple(shape), tuple(axes), device_type="cpu")
            out["traced"][name] = D._trace_cell(cfg, cell, mesh, D._plan(cfg, cell, mesh),
                                                rank=rank, device="cpu")
    return out
