"""Optimizers: the port of ``repro.optim.optimizers`` in torch ops.

- ``adamw``     : float32 m/v states (default for dense archs);
- ``adafactor`` : factored second moments for >= 2-D params;
- ``sgdm``      : momentum SGD.

The formulas are the JAX package's, op for op: the gradients are clipped to
a global norm first, AdamW's weight decay sits inside the update ``u`` with
``sqrt(v / bc2) + eps`` below it, Adafactor keeps row and column statistics
and clips its update to RMS 1. (``torch.optim.AdamW`` orders its arithmetic
otherwise, so it is not used.)

Parameters, gradients and states are *leaves*: a dict from a leaf path of
the JAX pytree (``units/p0/mixer/w_gate``) to a list of tensors, one per
pattern unit for a unit leaf (which the JAX leaf stacks on its first axis),
else one (``repro_torch.models.param_leaves``). A state is one such dict
keyed by the JAX state's path: ``m/<path>`` and ``v/<path>`` for AdamW,
``<path>/vr`` and ``<path>/vc`` (or ``<path>/v``) for Adafactor, ``m/<path>``
for SGD-M, so ``repro_torch.interop.leaves_to_jax`` gives the JAX layout.

``update(grads, state, params, step)`` returns ``(params, state)`` like the
JAX optimizers, but updates both in place: at full width the states are
21 GB, and a second copy would not fit beside them. The per-step scalars
(learning rate, bias corrections) are float32 tensors on the parameters'
device, so every division is a true division as in the JAX code (PyTorch
on the card divides by a host scalar as a multiply by its reciprocal).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

Leaves = Dict[str, List[torch.Tensor]]
Schedule = Callable[[Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Leaves], Leaves]
    update: Callable[[Leaves, Leaves, Leaves, Any], Tuple[Leaves, Leaves]]
    # update(grads, state, params, step) -> (params, state), both in place


def _f32(x) -> torch.Tensor:
    """A float32 scalar tensor on the CPU (``step`` may be an int or a tensor)."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Schedule:
    """Linear warm-up to ``peak_lr``, then a cosine decay to
    ``final_frac * peak_lr`` at ``total``; a float32 scalar tensor."""

    def fn(step):
        step = _f32(step)
        warm = peak_lr * torch.minimum(step / max(warmup, 1), _f32(1.0))
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos)

    return fn


def _device(leaves: Leaves) -> torch.device:
    return next(iter(leaves.values()))[0].device


def global_norm(leaves: Leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32, leaf by
    leaf in order."""
    total = torch.zeros((), dtype=torch.float32, device=_device(leaves))
    for ts in leaves.values():
        total = total + sum(torch.sum(torch.square(t.float())) for t in ts)
    return torch.sqrt(total)


def _clip_scale(grads: Leaves, max_norm: float, norm=None) -> torch.Tensor:
    norm = global_norm(grads) if norm is None else norm
    return torch.minimum(torch.ones_like(norm),
                         torch.full_like(norm, max_norm) / torch.clamp_min(norm, 1e-9))


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype).float()


def clip_by_global_norm(grads: Leaves, max_norm: float) -> Tuple[Leaves, torch.Tensor]:
    """The gradients scaled to a global norm of at most ``max_norm``, and the
    norm before. (The optimizers scale each gradient as they reach it, so
    that no clipped copy of all of them is held at once.)"""
    norm = global_norm(grads)
    scale = _clip_scale(grads, max_norm, norm)
    return {k: [(g.float() * scale).to(g.dtype) for g in gs] for k, gs in grads.items()}, norm


def adamw(lr: Schedule, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0,
          state_dtype: str = "float32") -> Optimizer:
    sdt = getattr(torch, state_dtype)

    def init(params: Leaves) -> Leaves:
        return {f"{s}/{k}": [torch.zeros_like(p, dtype=sdt) for p in ps]
                for s in ("m", "v") for k, ps in params.items()}

    def update(grads, state, params, step):
        scale = _clip_scale(grads, clip_norm)
        dev = _device(params)
        t = _f32(step) + 1.0
        lr_t = lr(step).to(dev)
        bc1 = (1 - torch.pow(b1, t)).to(dev)
        bc2 = (1 - torch.pow(b2, t)).to(dev)
        with torch.no_grad():
            for k, ps in params.items():
                for g, m, v, p in zip(grads[k], state[f"m/{k}"], state[f"v/{k}"], ps):
                    g = _clipped(g, scale)
                    mf, vf = m.float(), v.float()  # m, v themselves in float32
                    mf.mul_(b1).add_((1 - b1) * g)
                    vf.mul_(b2).add_((1 - b2) * g * g)
                    u = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
                    u.add_(weight_decay * p.float())
                    p.copy_(p.float() - lr_t * u)
                    if mf is not m:
                        m.copy_(mf)
                        v.copy_(vf)
        return params, state

    return Optimizer("adamw", init, update)


def adafactor(lr: Schedule, *, eps: float = 1e-30, clip_norm: float = 1.0,
              min_dim_factored: int = 128, decay: float = 0.8) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern). A parameter with
    >= 2 dims of size >= ``min_dim_factored`` keeps row and column
    statistics only. The update's RMS is taken over a unit leaf's units
    together, as the JAX optimizer takes it over the stacked array. (The
    JAX optimizer judges a unit leaf with its ``n_units`` axis, which
    changes nothing while ``n_units < min_dim_factored``.)"""

    def factored(p) -> bool:
        return p.dim() >= 2 and sum(d >= min_dim_factored for d in p.shape) >= 2

    def init(params: Leaves) -> Leaves:
        out: Leaves = {}
        for k, ps in params.items():
            if factored(ps[0]):
                out[f"{k}/vr"] = [torch.zeros(p.shape[:-1], dtype=torch.float32,
                                              device=p.device) for p in ps]
                out[f"{k}/vc"] = [torch.zeros(p.shape[:-2] + p.shape[-1:],
                                              dtype=torch.float32, device=p.device)
                                  for p in ps]
            else:
                out[f"{k}/v"] = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
        return out

    def update(grads, state, params, step):
        scale = _clip_scale(grads, clip_norm)
        dev = _device(params)
        t = _f32(step) + 1.0
        beta = (1.0 - torch.pow(t, -decay)).to(dev)
        lr_t = lr(step).to(dev)
        with torch.no_grad():
            for k, ps in params.items():
                us = []
                for i, g in enumerate(grads[k]):
                    g = _clipped(g, scale)
                    g2 = g * g + eps
                    if f"{k}/vr" in state:
                        vr, vc = state[f"{k}/vr"][i], state[f"{k}/vc"][i]
                        vr.copy_(beta * vr + (1 - beta) * g2.mean(dim=-1))
                        vc.copy_(beta * vc + (1 - beta) * g2.mean(dim=-2))
                        denom = (vr[..., None] * vc[..., None, :]) / torch.clamp_min(
                            vr.mean(dim=-1, keepdim=True)[..., None], eps)
                        us.append(g * torch.rsqrt(denom + eps))
                    else:
                        v = state[f"{k}/v"][i]
                        v.copy_(beta * v + (1 - beta) * g2)
                        us.append(g * torch.rsqrt(v + eps))
                # update clipping (RMS <= 1) per Adafactor, over the whole leaf
                n = sum(u.numel() for u in us)
                sq = sum(torch.sum(u * u) for u in us)
                rms = torch.sqrt(sq / torch.full_like(sq, n) + eps)
                for p, u in zip(ps, us):
                    u = u / torch.clamp_min(rms, 1.0)
                    p.copy_(p.float() - lr_t * u)
        return params, state

    return Optimizer("adafactor", init, update)


def sgdm(lr: Schedule, *, momentum: float = 0.9, clip_norm: float = 1.0) -> Optimizer:
    def init(params: Leaves) -> Leaves:
        return {f"m/{k}": [torch.zeros_like(p, dtype=torch.float32) for p in ps]
                for k, ps in params.items()}

    def update(grads, state, params, step):
        scale = _clip_scale(grads, clip_norm)
        lr_t = lr(step).to(_device(params))
        with torch.no_grad():
            for k, ps in params.items():
                for g, m, p in zip(grads[k], state[f"m/{k}"], ps):
                    m.mul_(momentum).add_(_clipped(g, scale))
                    p.copy_(p.float() - lr_t * m)
        return params, state

    return Optimizer("sgdm", init, update)


def make_optimizer(name: str, *, peak_lr: float = 3e-4, warmup: int = 100,
                   total: int = 10_000, **kw) -> Optimizer:
    sched = cosine_schedule(peak_lr, warmup, total)
    if name == "adamw":
        return adamw(sched, **kw)
    if name == "adafactor":
        return adafactor(sched, **kw)
    if name == "sgdm":
        return sgdm(sched, **kw)
    raise ValueError(name)
