"""Trainer: the training driver with checkpoints and failure recovery.

The port of ``repro.runtime.trainer`` on one device:
  - init the ``TrainState`` from a seeded ``torch.Generator`` on the device;
  - run train steps over the synthetic data pipeline with metrics;
  - periodic async checkpoints (``CheckpointManager``) in the JAX layout,
    so a checkpoint of either package's trainer restores into the other's;
  - simulated failure injection (``run(n, fail_at=)``) and
    ``restore_latest()``, the recovery path.

The masters are in the config's ``param_dtype`` (bfloat16 for arctic-480b
and kimi-k2-1t-a32b, which train with ``TrainerConfig(optimizer=
"adafactor")``; float32 for the dense configs), and a checkpoint stores
bfloat16 as its uint16 bits, as the JAX checkpoint does.

Not ported: the mesh and the elastic ``resize``, which need more than one
card (ROADMAP.md, Queue A item 8); both raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager, from_numpy, to_numpy
from ..core.torch_solve import resolve_device
from ..data import batch_iterator
from ..interop import leaves_to_jax, load_leaves
from ..models import init_params
from ..models.config import ArchConfig
from ..obs.clock import wall
from ..optim import make_optimizer
from .trainstep import TrainState, make_train_step

_NO_MESH = ("the port trains on one card: meshes and elastic resizing are not "
            "ported yet (ROADMAP.md, Queue A item 8)")


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
    (``resolve_device``); pass ``device="cpu"`` to train on the CPU."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, mesh: Any = None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(
            tcfg.optimizer, peak_lr=tcfg.peak_lr, warmup=tcfg.warmup, total=tcfg.total_steps)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, every=tcfg.ckpt_every,
                                       keep=tcfg.ckpt_keep) if tcfg.ckpt_dir else None)
        self._build()

    # -- setup ---------------------------------------------------------------
    def _build(self) -> None:
        cfg, tcfg = self.cfg, self.tcfg
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        model = init_params(cfg, gen, trainable=True)
        state = TrainState(model, {}, 0)
        state.opt_state = self.optimizer.init(state.params)
        self.state = state
        self._step = make_train_step(cfg, self.optimizer)
        self._data = batch_iterator(cfg, tcfg.seq_len, tcfg.global_batch, seed=tcfg.seed)

    # -- run -----------------------------------------------------------------
    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Every array of the batch on the device as it is: int32 tokens and
        targets, an ``embeddings`` model's float32 ``embeds`` and an encoder
        model's float32 ``frames`` (the model casts them to its compute
        dtype, as the JAX model does)."""
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def run(self, n_steps: int, *, fail_at: Optional[int] = None) -> Dict[str, Any]:
        """Run steps; optionally raise a simulated failure at ``fail_at``."""
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
                self.ckpt.maybe_save(self.state_tree(), self.state.step)
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
    def state_tree(self) -> list:
        """The state as the JAX ``TrainState`` flattens:
        ``[params, opt_state, step]`` in the JAX layout, as numpy (bfloat16
        as uint16 bits)."""
        st = self.state
        return [leaves_to_jax(st.params, to_numpy), leaves_to_jax(st.opt_state, to_numpy),
                np.asarray(st.step, np.int32)]

    def restore_latest(self) -> int:
        if self.ckpt is None:
            raise RuntimeError(
                "restore_latest() requires a checkpoint dir; pass ckpt_dir to "
                "the trainer config"
            )
        self.ckpt.wait()
        arrays = self.ckpt.restore()
        for prefix, leaves in (("0", self.state.params), ("1", self.state.opt_state)):
            def lookup(path, prefix=prefix, leaves=leaves):
                arr = arrays[f"{prefix}::{path.replace('/', '::')}"]
                return from_numpy(arr, leaves[path][0].dtype).float().numpy()

            load_leaves(leaves, lookup)
        self.state.step = int(arrays["2"])
        return self.state.step

    def resize(self, new_mesh: Any) -> None:
        raise NotImplementedError(_NO_MESH)


class SimulatedFailure(RuntimeError):
    pass
