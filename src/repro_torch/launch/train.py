"""Training launcher.

Two modes, as ``repro.launch.train``:

1. Single-job training (``--arch``) on one card, or with ``--mesh`` on a
   ``DeviceMesh`` of ranks (ZeRO-3 in the JAX specs, the batch over the
   data axes and the rest of the compute over ``model`` as the config's
   ``attn_parallelism`` picks, ``repro_torch.runtime.trainer``):

       PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \
           --batch 2 --seq-len 2048 --steps 3
       PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
           --batch 8 --seq-len 2048 --steps 3
       PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \
           --smoke --device cpu --steps 3
       PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \
           --batch 8 --seq-len 2048 --steps 3
       PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
           --batch 8 --seq-len 1500 --steps 3
       PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
           --batch 2 --seq-len 2048 --steps 3 --mesh 1x1
       PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
           --arch qwen2-1.5b --smoke --device cpu --mesh 2x2

2. OEF-scheduled multi-tenant mode (``--scheduler``): the paper's control
   plane drives several training jobs; each round the fair-share evaluator
   (cooperative or non-cooperative OEF) re-allocates the heterogeneous
   fleet and every tenant trains as many steps as its grant buys (see
   ``repro_torch.examples.cluster_scheduler_e2e`` for the annotated
   version):

       PYTHONPATH=src python -m repro_torch.launch.train --scheduler oef-coop \
           --tenants qwen2-1.5b,gemma3-4b,xlstm-350m --rounds 3
       PYTHONPATH=src python -m repro_torch.launch.train --scheduler oef-noncoop \
           --tenants recurrentgemma-2b,qwen2-1.5b --rounds 2 --device cpu

The port of ``repro.launch.train``: the same flags and defaults, plus
``--device`` (default ``cuda``; it raises when torch sees no GPU).
``--arch`` is recurrentgemma-2b, qwen2-1.5b, gemma3-4b (which accumulates
its gradients over ``microbatches=2``), xlstm-350m, yi-9b, phi4-mini-3.8b,
phi-3-vision-4.2b (trained on the pipeline's embeddings), whisper-tiny
(on the pipeline's float32 frames, ``--seq-len`` of them beside as many
tokens) or the MoE models arctic-480b and kimi-k2-1t-a32b (bfloat16
masters; at full width neither fits one card, so on the card run them
with ``--smoke`` or see ``chip_smoke.py`` phases 42-45), and so is each
of ``--tenants``. As in the JAX launcher, the optimizer is the trainer's
default, AdamW. Weights come from a ``torch.Generator`` seeded with
the trainer's seed (0), data from the synthetic pipeline. A single job prints
the parameter count, the steps, the first and last loss, steps/s and
tokens/s (wall time of ``Trainer.run``, kernel builds and warm-up
included), and the launches of every kernel wrapper (the models other
than recurrentgemma-2b launch none: the blocked attention path trains on
its twin). ``--mesh AxB`` (or ``A``, ``AxBxC``) names the mesh's shape,
its axes ``data, model`` (``data``; ``pod, data, model``) as in the JAX
launcher: under ``torchrun`` the job uses the process group torchrun's
environment sets up (NCCL on ``cuda``, each rank on its ``LOCAL_RANK``
card, gloo on ``cpu``), whose size must be the mesh's; without one, a mesh
of one rank starts a world-1 group of its own (a ``FileStore`` in a
temporary directory) and a larger mesh raises, naming the ``torchrun``
line it needs. Only the rank at the mesh's origin prints. The scheduled
mode keeps the JAX launcher's simulated TPU fleet and analytic profiles,
so its allocations are the JAX package's exactly (:func:`schedule_rounds`);
it prints each round's grants and each tenant's steps, loss, wall time and
launches. It trains each tenant on one device: as in the JAX launcher,
whose scheduled mode never reads ``--mesh``, it refuses the flag.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the JAX launcher's simulated fleet: four TPU generations, 24 devices.
FLEET_TYPES = ("tpu-v5e", "tpu-v4", "tpu-v5p", "tpu-v6e")
FLEET_M = (8, 8, 4, 4)
DEFAULT_TENANTS = "qwen2-1.5b,gemma3-4b,xlstm-350m"


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step, then auto-recover")
    ap.add_argument("--mesh", type=str, default=None,
                    help="e.g. 2x2: a DeviceMesh of (data, model) ranks (torchrun)")
    # scheduler mode
    ap.add_argument("--scheduler", type=str, default=None,
                    choices=["oef-coop", "oef-noncoop"])
    ap.add_argument("--tenants", type=str, default=DEFAULT_TENANTS)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if args.scheduler:
        if args.mesh:
            raise NotImplementedError(
                "--mesh applies to a single job (--arch): the scheduled mode "
                "trains each tenant on one device, as the JAX launcher's does")
        run_scheduled(args)
        return
    if not args.arch:
        ap.error("--arch or --scheduler required")
    run_single(args)


def mesh_shape(text: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``--mesh``'s shape and axis names: ``A`` -> data, ``AxB`` -> data,
    model, ``AxBxC`` -> pod, data, model."""
    shape = tuple(int(x) for x in text.split("x"))
    axes = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: want A, AxB or AxBxC of positive sizes")
    return shape, axes


@contextlib.contextmanager
def mesh_group(text: str, device):
    """The mesh ``--mesh text`` names, over the process group ``torchrun``
    set up (its environment: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), or
    over a world-1 group of its own for a mesh of one rank; the group this
    started is destroyed on exit. Raises when the ranks are not the mesh's."""
    import torch
    import torch.distributed as dist

    from .mesh import make_test_mesh

    shape, axes = mesh_shape(text)
    n = math.prod(shape)
    backend = "nccl" if device.type == "cuda" else "gloo"
    with contextlib.ExitStack() as stack:
        if not dist.is_initialized():
            if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
                if device.type == "cuda":
                    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
                dist.init_process_group(backend, init_method="env://")
            elif n == 1:
                store_dir = stack.enter_context(tempfile.TemporaryDirectory(prefix="oef-mesh-"))
                store = dist.FileStore(os.path.join(store_dir, "store"), 1)
                dist.init_process_group(backend, store=store, rank=0, world_size=1)
            else:
                raise RuntimeError(
                    f"--mesh {text} needs {n} ranks and this process is alone: run "
                    f"torchrun --nproc-per-node {n} -m repro_torch.launch.train ... "
                    f"--mesh {text}")
            stack.callback(dist.destroy_process_group)
        world = dist.get_world_size()
        if world != n:
            raise RuntimeError(f"--mesh {text} needs {n} ranks, the process group has "
                               f"{world}: run torchrun --nproc-per-node {n}")
        yield make_test_mesh(shape, axes, device_type=device.type)


def run_single(args) -> dict:
    from ..core.torch_solve import resolve_device

    device = resolve_device(args.device)
    if not args.mesh:
        return _train_single(args, device, None)
    with mesh_group(args.mesh, device) as mesh:
        return _train_single(args, device, mesh)


def _train_single(args, device, mesh) -> dict:
    from ..configs import get_config, get_smoke
    from ..distributed.zero import writer
    from ..kernels import launch_counts
    from ..runtime import Trainer, TrainerConfig
    from ..runtime.trainer import SimulatedFailure

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    ckpt = [args.ckpt_dir or (tempfile.mkdtemp(prefix=f"oef-train-{cfg.name}-")
                              if writer(mesh) else None)]
    if mesh is not None:  # every rank reads the writer's checkpoints
        import torch.distributed as dist

        dist.broadcast_object_list(ckpt, src=0)
    ckpt = ckpt[0]
    t = Trainer(cfg, TrainerConfig(seq_len=args.seq_len, global_batch=args.batch,
                                   peak_lr=args.lr, total_steps=args.steps,
                                   ckpt_dir=ckpt, ckpt_every=args.ckpt_every),
                mesh=mesh, device=device)
    say = print if writer(mesh) else (lambda *a, **k: None)
    where = f"{t.device}" + (f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                             if mesh is not None else "")
    say(f"training {cfg.name} on {where}: {cfg.param_count()/1e6:.1f}M params, "
        f"{args.steps} steps of {args.batch} x {args.seq_len} tokens, ckpt -> {ckpt}")
    before = launch_counts()
    try:
        out = t.run(args.steps, fail_at=args.fail_at)
    except SimulatedFailure as e:
        say(f"!! {e} — recovering from checkpoint")
        step = t.restore_latest()
        say(f"   restored step {step}; resuming")
        out = t.run(args.steps - step)
    rate = out["steps"] / max(out["seconds"], 1e-9)
    say(f"done: step {out['final_step']}, "
        f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, "
        f"{rate:.2f} steps/s, {rate * args.batch * args.seq_len:.1f} tokens/s")
    after = launch_counts()
    say("kernel launches: " + ", ".join(f"{k} {after[k] - before[k]}" for k in after))
    return out


def schedule_rounds(names: Sequence[str], scheduler: str, *, rounds: int,
                    seq_len: int, batch: int) -> Dict[str, object]:
    """The allocations of the scheduled mode, without training.

    Each tenant's profile comes from the ``ProfilingAgent`` over the
    analytic costs of its smoke config (``models.costs.model_flops`` of a
    ``(seq_len, batch)`` cell per sequence, 3 x ``param_bytes``), as the
    JAX launcher builds it. Each round ``evaluate_tenants`` solves the fleet
    on the default backend chain (numpy water-filling or the LP, as in
    JAX), one ``RoundingPlacer`` carried across rounds rounds the shares to
    whole devices, and a tenant's steps are ``max(1, int(speedup . grant))``.

    Returns ``{"speedups": {name: [..]}, "rounds": [{"shares", "grants",
    "steps"}, ...]}``: fractional shares (n, k) float64, integer grants
    (n, k) and the steps by tenant name.
    """
    from ..configs import get_smoke
    from ..core import ClusterSpec, ProfilingAgent, Tenant, WorkloadCost, oef
    from ..core.placement import RoundingPlacer
    from ..models.config import ShapeCell
    from ..models.costs import model_flops, param_bytes

    cluster = ClusterSpec(types=FLEET_TYPES, m=FLEET_M)
    agent = ProfilingAgent()
    cell = ShapeCell("sched", "train", seq_len, batch)
    tenants = []
    for name in names:
        cfg = get_smoke(name)
        cost = WorkloadCost(name=name, flops=model_flops(cfg, cell) / batch,
                            hbm_bytes=float(param_bytes(cfg)) * 3)
        tenants.append(Tenant(name=name, job_types=(agent.profile(cost),)))
    placer = RoundingPlacer(len(tenants), cluster.m)
    mode = "cooperative" if scheduler == "oef-coop" else "noncooperative"
    out: List[Dict[str, object]] = []
    for _ in range(rounds):
        ta = oef.evaluate_tenants(tenants, cluster, mode=mode)
        real = placer.round_shares(ta.X)
        steps = {}
        for ti, tenant in enumerate(tenants):
            units = float(np.dot(np.asarray(tenant.job_types[0].speedup), real[ti]))
            steps[tenant.name] = max(1, int(units))
        out.append({"shares": ta.X, "grants": real, "steps": steps})
    return {"speedups": {t.name: list(t.job_types[0].speedup) for t in tenants},
            "rounds": out}


def run_scheduled(args) -> Dict[str, object]:
    """Train ``--tenants`` under ``--scheduler`` for ``--rounds`` rounds on
    ``--device``: each round, each tenant's ``Trainer`` (its smoke config,
    ``--seq-len`` x ``--batch``) runs the steps :func:`schedule_rounds`
    grants it. Returns the schedule and, per round, each tenant's steps,
    losses, wall seconds (``Trainer.run``, ending in the last loss read) and
    kernel launches by wrapper, and the round's wall seconds. The tenants'
    checkpoints go to one temporary directory, removed when the run ends."""
    from ..core.torch_solve import resolve_device

    device = resolve_device(args.device)
    names = [n.strip() for n in args.tenants.split(",")]
    plan = schedule_rounds(names, args.scheduler, rounds=args.rounds,
                           seq_len=args.seq_len, batch=args.batch)
    with tempfile.TemporaryDirectory(prefix="oef-sched-") as ckpt_root:
        return _train_scheduled(args, names, plan, device, ckpt_root)


def _train_scheduled(args, names, plan, device, ckpt_root) -> Dict[str, object]:
    """``run_scheduled``'s rounds, each tenant checkpointing under
    ``ckpt_root``."""
    from ..configs import get_smoke
    from ..kernels import launch_counts
    from ..obs.clock import wall
    from ..runtime import Trainer, TrainerConfig

    trainers = {}
    for name in names:
        trainers[name] = Trainer(get_smoke(name), TrainerConfig(
            seq_len=args.seq_len, global_batch=args.batch, peak_lr=args.lr,
            total_steps=10_000,
            ckpt_dir=os.path.join(ckpt_root, name), ckpt_every=20),
            device=device)
        print(f"tenant {name}: speedups "
              f"{np.round(np.asarray(plan['speedups'][name]), 3)}")
    rounds = []
    for rnd, sched in enumerate(plan["rounds"]):
        print(f"\nround {rnd}: grants\n{sched['grants']}")
        t0 = wall()
        per = {}
        for name in names:
            steps = sched["steps"][name]
            k0 = launch_counts()
            out = trainers[name].run(steps)
            k1 = launch_counts()
            per[name] = {"steps": steps, "losses": out["losses"],
                         "seconds": out["seconds"],
                         "launches": {k: k1[k] - k0[k] for k in k0}}
            print(f"  {name}: {steps} steps, loss -> {out['losses'][-1]:.4f}, "
                  f"{out['seconds']:.2f} s ({steps / max(out['seconds'], 1e-9):.2f} "
                  f"steps/s)")
        rounds.append({"tenants": per, "wall_s": wall() - t0})
        print(f"  round wall {rounds[-1]['wall_s']:.2f} s")
    total = sum(r["wall_s"] for r in rounds)
    n_steps = sum(t["steps"] for r in rounds for t in r["tenants"].values())
    counts = {}
    for r in rounds:
        for t in r["tenants"].values():
            for k, n in t["launches"].items():
                counts[k] = counts.get(k, 0) + n
    print(f"done: {n_steps} steps in {total:.2f} s ({n_steps / max(total, 1e-9):.2f} "
          f"steps/s) on {device}; kernel launches: "
          + ", ".join(f"{k} {n}" for k, n in counts.items()))
    return {"schedule": plan, "rounds": rounds}


if __name__ == "__main__":
    main()
