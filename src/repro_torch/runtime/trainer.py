"""Trainer: the training driver with checkpoints, failure recovery and
elastic re-meshing.

The port of ``repro.runtime.trainer``:
  - init the ``TrainState`` from a seeded ``torch.Generator`` on the device;
  - run train steps over the synthetic data pipeline with metrics;
  - periodic async checkpoints (``CheckpointManager``) in the JAX layout,
    so a checkpoint of either package's trainer restores into the other's;
  - simulated failure injection (``run(n, fail_at=)``) and
    ``restore_latest()``, the recovery path;
  - on a ``DeviceMesh`` (``mesh=``), ZeRO-3 in the JAX package's specs, and
    the elastic ``resize(new_mesh)``.

On a mesh the plan is ``make_plan(mesh, prefer=cfg.attn_parallelism,
global_batch=tcfg.global_batch)``, as JAX's, and the model gets the plan
at this rank's coordinate (``sharding.rank_view``, the model's ``view``).
Every rank stores only its block of each master, gradient and optimizer
state where ``state_specs`` places it (``repro_torch.distributed.zero``):
a layer's parameters are gathered at use, part by part, and dropped after
it; under a checkpointing ``remat`` the backward gathers them again, while
under ``remat="none"`` autograd keeps what each part saved for its
backward, its gathered weights (or their casts) too, until that backward
runs. Every rank draws the same global batch from the seeded pipeline and
keeps the rows ``plan.batch(global_batch)`` gives its coordinate (JAX's
``device_put``); the ``model`` axis splits the rest of the compute as
JAX's constraints do (``seq_tp``: the residual stream in sequence blocks,
K/V gathered; ``head_tp``: heads and ``d_ff`` columns; experts; ``ddp``:
the sequence where the batch leaves ``model`` free;
``repro_torch.distributed.parallel``). The loss is the global batch's
(each rank's mean over its rows and positions times its share of the
split, summed), each gradient is summed over the split's mesh dims into
its spec, and the norm and Adafactor's statistics are summed over the
dims that split each tensor, so a step on a mesh is the meshless step up
to the order of float sums (bit for bit on a 1x1 mesh). Checkpoints stay
in the JAX layout: leaves are
gathered and written by the rank at the mesh's origin, and every rank
reads the whole leaves back and keeps its blocks, so a checkpoint crosses
meshes, no mesh and the JAX trainer both ways. The mesh's device type
must be the trainer's device's (``cuda``: NCCL, or gloo, which also runs
two ranks on one card; ``cpu``: gloo).

The masters are in the config's ``param_dtype`` (bfloat16 for arctic-480b
and kimi-k2-1t-a32b, which train with ``TrainerConfig(optimizer=
"adafactor")``; float32 for the dense configs), and a checkpoint stores
bfloat16 as its uint16 bits, as the JAX checkpoint does.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager, from_numpy, to_numpy
from ..core.torch_solve import resolve_device
from ..data import batch_iterator
from ..distributed import zero as Z
from ..distributed.sharding import make_plan, rank_view
from ..interop import leaves_to_jax, load_leaves
from ..models import init_params
from ..models.config import ArchConfig
from ..models.model import Model, _jax_path, param_leaves
from ..obs.clock import wall
from ..optim import make_optimizer
from .trainstep import TrainState, make_train_step, state_specs, tensor_specs, unit_spec


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 128
    global_batch: int = 8
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    warmup: int = 20
    total_steps: int = 200
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 2
    seed: int = 0


class Trainer:
    """``device`` defaults to ``cuda`` and raises without a GPU
    (``resolve_device``); pass ``device="cpu"`` to train on the CPU.
    ``mesh`` (a ``DeviceMesh`` whose device type is the device's; every
    rank of it builds the trainer with the same arguments) trains with
    ZeRO-3 storage on it."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, mesh: Any = None,
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(
            tcfg.optimizer, peak_lr=tcfg.peak_lr, warmup=tcfg.warmup, total=tcfg.total_steps)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, every=tcfg.ckpt_every,
                                       keep=tcfg.ckpt_keep) if tcfg.ckpt_dir else None)
        self._set_mesh(mesh)
        if not Z.in_mesh(mesh):
            raise ValueError(f"this rank is not in the mesh {mesh}")
        self._build()

    # -- setup ---------------------------------------------------------------
    def _set_mesh(self, mesh: Any) -> None:
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"the mesh is on {mesh.device_type!r} devices but the trainer on "
                f"{self.device.type!r}: a cuda mesh (NCCL, or gloo) trains on cuda, "
                f"a cpu mesh (gloo) on the cpu")
        cfg = self.cfg
        self.mesh = mesh
        self.plan = make_plan(mesh, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                              prefer=cfg.attn_parallelism,
                              global_batch=self.tcfg.global_batch)

    def _build(self) -> None:
        cfg, tcfg = self.cfg, self.tcfg
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        if self.mesh is None:
            self.zero = None
            model = init_params(cfg, gen, trainable=True)
            state = TrainState(model, {}, 0)
            state.opt_state = self.optimizer.init(state.params)
        else:
            model, opt_state = self._build_sharded(gen)
            state = TrainState(model, opt_state, 0)
        self.state = state
        self._step = make_train_step(cfg, self.optimizer, self.zero)
        self._data = batch_iterator(cfg, tcfg.seq_len, tcfg.global_batch, seed=tcfg.seed)

    def _build_sharded(self, gen: torch.Generator):
        """The model as this rank's shards, drawn as the meshless model is,
        and the optimizer's states where their specs place them (zeros of
        this rank's block; Adafactor's whole)."""
        self.zero, model, opt_state, self._state_placed = sharded_state(
            self.cfg, self.mesh, self.plan, self.optimizer, self.tcfg.global_batch,
            self.device, gen)
        return model, opt_state

    # -- run -----------------------------------------------------------------
    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Every array of the batch on the device as it is: int32 tokens and
        targets, an ``embeddings`` model's float32 ``embeds`` and an encoder
        model's float32 ``frames`` (the model casts them to its compute
        dtype, as the JAX model does)."""
        if self.zero is not None:
            batch = {k: self.zero.split.rows(v) for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def run(self, n_steps: int, *, fail_at: Optional[int] = None) -> Dict[str, Any]:
        """Run steps; optionally raise a simulated failure at ``fail_at``."""
        if self.state is None:
            raise RuntimeError("this rank is not in the trainer's mesh since resize()")
        losses: List[float] = []
        t0 = wall()
        for _ in range(n_steps):
            step_now = self.state.step
            # integer steps, not event time
            if fail_at is not None and step_now == fail_at:  # repro: noqa[D102]
                raise SimulatedFailure(f"injected failure at step {step_now}")
            batch = self._device_batch(next(self._data))
            self.state, metrics = self._step(self.state, batch)
            losses.append(float(metrics["loss"]))
            if self.ckpt is not None and self.ckpt.due(self.state.step):
                # the state goes to the host only on a checkpoint step
                tree = self.state_tree()
                if Z.writer(self.mesh):
                    self.ckpt.maybe_save(tree, self.state.step)
        if self.ckpt is not None:
            self.ckpt.wait()
        dt = wall() - t0
        return {
            "losses": losses,
            "steps": len(losses),
            "seconds": dt,
            "final_step": self.state.step,
        }

    # -- checkpoints ----------------------------------------------------------
    def _placed(self) -> Optional[Dict[str, list]]:
        """Every state tensor's placement by leaf (None without a mesh)."""
        if self.zero is None:
            return None
        st = self.state
        return {**self.zero.placed_leaves(st.model, st.params), **self._state_placed}

    def state_tree(self) -> list:
        """The state as the JAX ``TrainState`` flattens:
        ``[params, opt_state, step]`` in the JAX layout, as numpy (bfloat16
        as uint16 bits). On a mesh every rank gathers each leaf whole, one
        tensor at a time (each rank of the mesh must call it)."""
        st = self.state
        placed = self._placed()

        def leaves(tree):
            if placed is None:
                return leaves_to_jax(tree, to_numpy)
            return leaves_to_jax({k: [to_numpy(pl.full(t)) for t, pl in zip(ts, placed[k])]
                                  for k, ts in tree.items()}, np.asarray)

        with torch.no_grad():
            return [leaves(st.params), leaves(st.opt_state), np.asarray(st.step, np.int32)]

    def restore_latest(self) -> int:
        """Load the latest checkpoint (on a mesh: every rank reads the whole
        leaves and keeps its blocks, after the writer's last save landed)."""
        if self.ckpt is None:
            raise RuntimeError(
                "restore_latest() requires a checkpoint dir; pass ckpt_dir to "
                "the trainer config"
            )
        self.ckpt.wait()
        Z.barrier(self.mesh)
        arrays = self.ckpt.restore()
        placed = self._placed()
        for prefix, leaves in (("0", self.state.params), ("1", self.state.opt_state)):
            def lookup(path, prefix=prefix, leaves=leaves):
                arr = arrays[f"{prefix}::{path.replace('/', '::')}"]
                return from_numpy(arr, leaves[path][0].dtype).float().numpy()

            if placed is None:
                load_leaves(leaves, lookup)
            else:
                _load_blocks(leaves, lookup, placed)
        self.state.step = int(arrays["2"])
        return self.state.step

    def resize(self, new_mesh: Any) -> None:
        """Elastic re-mesh: rebuild the plan and the step under ``new_mesh``
        (or none) and reload the latest checkpoint under its specs. Every
        rank of the old mesh calls it; a rank outside ``new_mesh`` drops its
        state and trains no more."""
        if self.ckpt is None:
            raise RuntimeError(
                "elastic resize requires checkpointing; pass ckpt_dir to the "
                "trainer config"
            )
        self.ckpt.wait()
        Z.barrier(self.mesh)
        self._set_mesh(new_mesh)
        if not Z.in_mesh(new_mesh):
            self.state = self.zero = None
            return
        self._build()
        if self.ckpt.latest_step() is not None:
            self.restore_latest()


def sharded_state(cfg: ArchConfig, mesh: Any, plan, optimizer, global_batch: int, device,
                  gen: Optional[torch.Generator] = None):
    """This rank's training state on ``mesh`` under ``plan``: ``(zero,
    model, opt_state, state_placed)``, the ``Zero`` storage, the model as
    this rank's shards with its hooks and view, the optimizer's states as
    this rank's blocks (zeros; Adafactor's whole) and their ``Placed`` by
    leaf. With ``gen`` the parameters are drawn as the meshless model's;
    without, each is built whole and uninitialised on ``device`` and cut,
    which only a trace on fake tensors (``repro_torch.launch.dryrun``), where
    nothing is allocated, can afford at full size."""
    split = Z.MeshSplit(mesh, plan.batch(global_batch) or (), global_batch, cfg.microbatches,
                        plan.shape.model_axis)
    zero = Z.Zero(mesh, split, tensor_specs(cfg, plan), cfg.grad_spec_constraint)
    path_of = lambda name: _jax_path(cfg, name)  # noqa: E731
    if gen is not None:
        model = init_params(cfg, gen, trainable=True, place=zero.placer(path_of))
    else:
        model = Model(cfg, device=device, trainable=True)
        zero.place(model, path_of)
    zero.attach(model)
    model.view = rank_view(plan, mesh)
    # the optimizer's states from the global shapes, then placed
    whole = param_leaves(Model(cfg, device="meta", trainable=True))
    meta_state = optimizer.init(whole)
    sspecs = state_specs(cfg, plan, SimpleNamespace(params=whole,
                                                    opt_state=meta_state)).opt_state
    opt_state, state_placed = {}, {}
    for key, ts in meta_state.items():
        spec = unit_spec(key, sspecs[key])
        pls = [Z.Placed(mesh, spec, t.shape) for t in ts]
        state_placed[key] = pls
        opt_state[key] = [torch.zeros(pl.local_shape, dtype=t.dtype, device=device)
                          for t, pl in zip(ts, pls)]
    return zero, model, opt_state, state_placed


def _load_blocks(leaves, lookup, placed) -> None:
    """``interop.load_leaves`` into this rank's blocks: each whole array
    (a stacked leaf's unit by unit) cut to its tensor's place."""
    with torch.no_grad():
        for path, ts in leaves.items():
            arr = np.asarray(lookup(path))
            parts = list(arr) if "units" in path.split("/") else [arr]
            if len(parts) != len(ts):
                raise ValueError(f"JAX leaf {path} holds {len(parts)} units, the "
                                 f"port {len(ts)}")
            for t, a, pl in zip(ts, parts, placed[path]):
                if tuple(a.shape) != pl.shape:
                    raise ValueError(f"JAX leaf {path} has shape {a.shape} per unit, "
                                     f"the tensor {pl.shape}")
                t.copy_(torch.from_numpy(np.ascontiguousarray(a[pl.index])))


class SimulatedFailure(RuntimeError):
    pass
