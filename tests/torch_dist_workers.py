"""Multi-rank runs of the port on the CPU for the tests: gloo processes.

:func:`spawn` starts ``nprocs`` processes with ``torch.multiprocessing``'s
``spawn`` method, each on one torch thread, joined to one gloo group
through a ``file://`` rendezvous in the test's temporary directory (no TCP
port, so parallel test workers cannot collide). Each runs
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
