"""The plain reference of the training step: the loss and its gradients
(``lm.loss``), the gradients clipped to a global norm, then AdamW with
decoupled weight decay under a warm-up and cosine learning-rate schedule,
all in float32, as the traffic file's ``optimizer`` states them:

    g  = grad * min(1, clip / |grad|)            (|.| over every weight)
    m  = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g^2
    p -= lr_t ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

``lr_t`` rises linearly over ``warmup`` steps to ``peak_lr`` (from 0 at
step 0; with ``warmup`` 0 it starts at the peak) and then decays along a
cosine to a tenth of it at ``total_steps``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from . import lm

#: the most elements an update works on at once
SPAN = 1 << 26


def lr_at(step: int, opt: dict) -> float:
    peak, warm, total = opt["peak_lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return peak * min(step / max(warm, 1), 1.0)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


def _spans(p: torch.Tensor) -> List[slice]:
    rows = max(1, SPAN // max(1, p[0].numel())) if p.dim() > 1 else p.shape[0]
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def train_readings(P: lm.Params, run: dict, opt: dict,
                   batches: List[Tuple[torch.Tensor, torch.Tensor]],
                   p0: Callable[[], Iterable[Tuple[str, torch.Tensor]]],
                   prec: str = "fp32", rows: Optional[int] = None) -> Dict[str, object]:
    """Train ``len(batches)`` steps from the weights ``P`` (float32, updated
    in place) and read what the comparison takes: each step's loss, the
    norm of each weight's first gradient as the optimizer takes it
    (clipped), and the norm of each weight's change over the steps against
    ``p0()`` (the initial weights, drawn again name by name). ``rows``
    keeps only the first rows of each batch (a planted fault)."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    m = {k: torch.zeros_like(p) for k, p in P.items()}
    v = {k: torch.zeros_like(p) for k, p in P.items()}
    losses, first = [], {}
    for step, (tokens, targets) in enumerate(batches):
        if rows is not None:
            tokens, targets = tokens[:rows], targets[:rows]
        for p in P.values():
            p.requires_grad_(True)
            p.grad = None
        loss = lm.loss(P, run, tokens, targets, prec)
        loss.backward()
        losses.append(float(loss.detach()))
        del loss
        norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in P.values()))
        scale = torch.clamp(opt["clip_norm"] / torch.clamp_min(norm, 1e-9), max=1.0)
        t = step + 1
        lr, bc1, bc2 = lr_at(step, opt), 1 - b1 ** t, 1 - b2 ** t
        with torch.no_grad():
            for k, p in P.items():
                g = p.grad
                p.grad = None
                g.mul_(scale)
                if step == 0:
                    first[k] = float(torch.linalg.vector_norm(g))
                for s in _spans(p):
                    m[k][s].mul_(b1).add_((1 - b1) * g[s])
                    v[k][s].mul_(b2).add_((1 - b2) * g[s] * g[s])
                    u = (m[k][s] / bc1) / (torch.sqrt(v[k][s] / bc2) + eps)
                    p[s].sub_(lr * (u + wd * p[s]))
                del g
    del m, v
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(P[k] - w)) for k, w in p0()}
    return {"losses": losses, "grad": first, "change": change}
