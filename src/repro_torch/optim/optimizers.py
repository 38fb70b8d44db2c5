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

``update(grads, state, params, step, placed=None)`` returns ``(params,
state)`` like the JAX optimizers, but updates both in place: at full width the states are
21 GB, and a second copy would not fit beside them. The per-step scalars
(learning rate, bias corrections) are float32 tensors on the parameters'
device, so every division is a true division as in the JAX code (PyTorch
on the card divides by a host scalar as a multiply by its reciprocal).

Every float32 temporary is one span of a tensor's leading axis
(:func:`_spans`): one expert of a MoE leaf, rows of at most ``CHUNK``
elements of a matrix. Masters and gradients may be bfloat16 (arctic-480b's
28 GB of masters and as much of gradients leave no room for a float32 copy
of a whole expert leaf: 35.7 GB for its ``w_in``). The formulas are the
JAX package's; what spans change is the order of float32 sums only (the
global norm, Adafactor's column means and its update RMS), and
Adafactor's RMS stays one value over the whole leaf (two passes: the
statistics and the sum of u², then the update, u recomputed).

On a mesh (``placed``: each tensor's ``repro_torch.distributed.zero.Placed``)
the parameters, gradients and AdamW / SGD-M states are this rank's blocks
and Adafactor's states are whole on every rank, as the JAX specs place
them (``vr``, ``vc`` and ``v`` replicated). Every sum over a tensor that a
mesh dim splits (the global norm, Adafactor's row and column statistics
and its RMS) is then all-reduced over the dims that split it
(``Placed.sum``), so the update of the blocks is the meshless update; a
tensor that no dim splits takes the meshless arithmetic.
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
    update: Callable[..., Tuple[Leaves, Leaves]]
    # update(grads, state, params, step, placed=None) -> (params, state), both
    # in place


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


#: the most elements of a span of a matrix (:func:`_spans`): 256 MB in float32
CHUNK = 1 << 26


def _device(leaves: Leaves) -> torch.device:
    return next(iter(leaves.values()))[0].device


def _spans(t: torch.Tensor) -> list:
    """Index spans of ``t``'s leading axis, each taken in turn: one slice at
    a time of a tensor of three or more dims (an expert of a MoE leaf, a
    head of the sLSTM recurrence), rows of at most ``CHUNK`` elements (at
    least one) of a matrix, a vector whole."""
    if t.dim() < 2:
        return [...]
    step = 1 if t.dim() > 2 else max(1, CHUNK // t.shape[1])
    return [slice(i, i + step) for i in range(0, t.shape[0], step)]


def _placed(placed, key: str, i: int):
    """Tensor ``i`` of leaf ``key``'s placement when a mesh dim splits it."""
    if placed is None:
        return None
    pl = placed[key][i]
    return pl if pl.split else None


def global_norm(leaves: Leaves, placed=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32, leaf by
    leaf in order, each tensor span by span; a tensor split over a mesh
    (``placed``) adds its blocks' sum all-reduced over the splitting dims."""
    total = torch.zeros((), dtype=torch.float32, device=_device(leaves))
    for k, ts in leaves.items():
        for i, t in enumerate(ts):
            pl = _placed(placed, k, i)
            part = total if pl is None else torch.zeros_like(total)
            for s in _spans(t):
                part = part + torch.sum(torch.square(t[s].float()))
            total = part if pl is None else total + pl.sum(part)
    return torch.sqrt(total)


def _clip_scale(grads: Leaves, max_norm: float, norm=None, placed=None) -> torch.Tensor:
    norm = global_norm(grads, placed) if norm is None else norm
    return torch.minimum(torch.ones_like(norm),
                         torch.full_like(norm, max_norm) / torch.clamp_min(norm, 1e-9))


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g`` (a span) clipped as the JAX ``clip_by_global_norm`` clips it,
    rounded to its own dtype, then in float32: a fresh tensor."""
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

    def update(grads, state, params, step, placed=None):
        scale = _clip_scale(grads, clip_norm, placed=placed)
        dev = _device(params)
        t = _f32(step) + 1.0
        lr_t = lr(step).to(dev)
        bc1 = (1 - torch.pow(b1, t)).to(dev)
        bc2 = (1 - torch.pow(b2, t)).to(dev)
        with torch.no_grad():
            for k, ps in params.items():
                for g, m, v, p in zip(grads[k], state[f"m/{k}"], state[f"v/{k}"], ps):
                    for s in _spans(p):
                        gs = _clipped(g[s], scale)
                        ms, vs = m[s], v[s]
                        mf, vf = ms.float(), vs.float()  # m, v themselves in float32
                        mf.mul_(b1).add_((1 - b1) * gs)
                        vf.mul_(b2).add_((1 - b2) * gs * gs)
                        u = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
                        u.add_(weight_decay * p[s].float())
                        p[s].copy_(p[s].float() - lr_t * u)
                        if mf is not ms:
                            ms.copy_(mf)
                            vs.copy_(vf)
        return params, state

    return Optimizer("adamw", init, update)


def adafactor(lr: Schedule, *, eps: float = 1e-30, clip_norm: float = 1.0,
              min_dim_factored: int = 128, decay: float = 0.8) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern). A parameter with
    >= 2 dims of size >= ``min_dim_factored`` keeps row and column
    statistics only. The update's RMS is taken over a unit leaf's units
    together, as the JAX optimizer takes it over the stacked array. (The
    JAX optimizer judges a unit leaf with its ``n_units`` axis, which
    changes nothing while ``n_units < min_dim_factored``.)

    Each tensor is worked span by span (:func:`_spans`): a first pass
    updates the statistics and sums u² over the whole leaf, a second
    recomputes u from the updated statistics and applies
    ``u / max(1, rms)``. A span of three or more dims holds whole rows of
    its ``vr`` and ``vc`` (an expert's own); a matrix's column statistic
    ``vc`` sums over every row span first, so its u follows in a pass of
    its own."""

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

    def update(grads, state, params, step, placed=None):
        scale = _clip_scale(grads, clip_norm, placed=placed)
        dev = _device(params)
        t = _f32(step) + 1.0
        beta = (1.0 - torch.pow(t, -decay)).to(dev)
        lr_t = lr(step).to(dev)

        def u_of(gs, st, s, whole_vc):
            """The update of span ``s`` from its clipped gradient ``gs`` (in
            place) and the statistics ``st``."""
            if len(st) == 1:
                return gs.mul_(torch.rsqrt(st[0][s] + eps))
            vr, vc = st
            rows = vr if whole_vc else vr[s]  # a matrix's row mean spans its rows
            denom = (vr[s][..., None] * (vc if whole_vc else vc[s])[..., None, :]) / (
                torch.clamp_min(rows.mean(dim=-1, keepdim=True)[..., None], eps))
            return gs.mul_(torch.rsqrt(denom.add_(eps)))

        with torch.no_grad():
            for k, ps in params.items():
                st_of = ([(vr, vc) for vr, vc in zip(state[f"{k}/vr"], state[f"{k}/vc"])]
                         if f"{k}/vr" in state else [(v,) for v in state[f"{k}/v"]])
                pls = [_placed(placed, k, i) for i in range(len(ps))]
                if any(pls):
                    _split_leaf(grads[k], ps, st_of, pls, scale, beta, lr_t, eps)
                    continue
                sq = torch.zeros((), dtype=torch.float32, device=dev)
                n = 0
                for g, p, st in zip(grads[k], ps, st_of):
                    n += p.numel()
                    whole_vc = len(st) == 2 and p.dim() == 2
                    colsum = 0
                    for s in _spans(p):
                        gs = _clipped(g[s], scale)
                        g2 = gs * gs + eps
                        if len(st) == 1:
                            st[0][s] = beta * st[0][s] + (1 - beta) * g2
                        else:
                            st[0][s] = beta * st[0][s] + (1 - beta) * g2.mean(dim=-1)
                            if whole_vc:
                                colsum = colsum + g2.sum(dim=-2)
                            else:
                                st[1][s] = beta * st[1][s] + (1 - beta) * g2.mean(dim=-2)
                        del g2
                        if not whole_vc:
                            u = u_of(gs, st, s, whole_vc)
                            sq = sq + torch.sum(u * u)
                    if whole_vc:  # the column mean over every row span
                        vc = st[1]
                        vc.copy_(beta * vc + (1 - beta) * (
                            colsum / torch.full_like(colsum, p.shape[0])))
                        for s in _spans(p):
                            u = u_of(_clipped(g[s], scale), st, s, whole_vc)
                            sq = sq + torch.sum(u * u)
                # update clipping (RMS <= 1) per Adafactor, over the whole leaf
                rms = torch.sqrt(sq / torch.full_like(sq, n) + eps)
                for g, p, st in zip(grads[k], ps, st_of):
                    whole_vc = len(st) == 2 and p.dim() == 2
                    for s in _spans(p):
                        u = u_of(_clipped(g[s], scale), st, s, whole_vc)
                        u = u / torch.clamp_min(rms, 1.0)
                        p[s].copy_(p[s].float() - lr_t * u)
        return params, state

    return Optimizer("adafactor", init, update)


def _split_leaf(grads, ps, st_of, pls, scale, beta, lr_t, eps) -> None:
    """Adafactor's update of one leaf whose tensors a mesh splits: ``ps`` and
    ``grads`` are this rank's blocks (``pls`` their placements), the
    statistics ``st_of`` whole. Each statistic's sum over this rank's block
    is laid into a whole-size zero tensor at the block's place and
    all-reduced over the splitting dims (the other blocks fill their places,
    the column blocks of one row add up), then divided by the global count,
    so every rank holds the meshless statistics; the RMS of the update is
    the all-reduced sum of u² over the whole leaf."""

    def stats_u(g, st, pl):
        gs = _clipped(g, scale)
        idx = pl.index
        if len(st) == 1:
            return gs.mul_(torch.rsqrt(st[0][idx] + eps))
        vr, vc = st
        rows = vr.mean(dim=-1, keepdim=True)[idx[:-2]]
        denom = (vr[idx[:-1]][..., None] * vc[idx[:-2] + idx[-1:]][..., None, :]) / (
            torch.clamp_min(rows[..., None], eps))
        return gs.mul_(torch.rsqrt(denom.add_(eps)))

    sq = torch.zeros((), dtype=torch.float32, device=ps[0].device)
    for g, st, pl in zip(grads, st_of, pls):
        gs = _clipped(g, scale)
        g2 = gs * gs + eps
        idx = pl.index
        if len(st) == 1:
            whole = torch.zeros_like(st[0])
            whole[idx] = g2
            st[0].copy_(beta * st[0] + (1 - beta) * pl.sum(whole))
        else:
            vr, vc = st
            rows = torch.zeros_like(vr)
            rows[idx[:-1]] = g2.sum(dim=-1)
            cols = torch.zeros_like(vc)
            cols[idx[:-2] + idx[-1:]] = g2.sum(dim=-2)
            vr.copy_(beta * vr + (1 - beta) * (pl.sum(rows) / pl.shape[-1]))
            vc.copy_(beta * vc + (1 - beta) * (pl.sum(cols) / pl.shape[-2]))
        del g2, gs
        u = stats_u(g, st, pl)
        sq = sq + torch.sum(u * u)
    n = sum(math.prod(pl.shape) for pl in pls)
    rms = torch.sqrt(pls[0].sum(sq) / torch.full_like(sq, n) + eps)
    for g, p, st, pl in zip(grads, ps, st_of, pls):
        u = stats_u(g, st, pl) / torch.clamp_min(rms, 1.0)
        p.copy_(p.float() - lr_t * u)


def sgdm(lr: Schedule, *, momentum: float = 0.9, clip_norm: float = 1.0) -> Optimizer:
    def init(params: Leaves) -> Leaves:
        return {f"m/{k}": [torch.zeros_like(p, dtype=torch.float32) for p in ps]
                for k, ps in params.items()}

    def update(grads, state, params, step, placed=None):
        scale = _clip_scale(grads, clip_norm, placed=placed)
        lr_t = lr(step).to(_device(params))
        with torch.no_grad():
            for k, ps in params.items():
                for g, m, p in zip(grads[k], state[f"m/{k}"], ps):
                    for s in _spans(p):
                        m[s].mul_(momentum).add_(_clipped(g[s], scale))
                        p[s].copy_(p[s].float() - lr_t * m[s])
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
