"""Error-feedback int8 gradient compression: the port of
``repro.optim.compress``.

Each gradient tensor is compressed to int8 with a per-tensor float32 scale
before the exchange, and the quantization residual stays in an
error-feedback accumulator (Seide et al. / EF-SGD), which restores
convergence to the uncompressed rate.

:func:`compressed_psum_tree` is the data-parallel exchange with an 8-bit
wire format: quantize, ``all_gather_into_tensor`` the int8 values and the
scales over a ``torch.distributed`` group (4x fewer bytes than a bf16
all-reduce at the same algorithmic bandwidth), then the dequantized sum on
each rank. As in the JAX package no train step calls it; it is the
primitive a compressed exchange is built on.

``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q`` and
``scale`` are the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

Leaves = Dict[str, List[torch.Tensor]]


def ef_int8_compress(g: torch.Tensor, err: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32 0-d, new_err float32)`` of ``g`` plus the
    carried error ``err`` (float32): the scale is ``max |g + err| / 127``
    with a floor of 1e-12 / 127, ``q`` the rounded quotient clipped to
    [-127, 127], ``new_err`` what ``q * scale`` misses."""
    gc = g.float() + err
    peak = torch.clamp_min(torch.max(torch.abs(gc)), 1e-12)
    # a true division (a CUDA tensor divided by a host scalar is a multiply
    # by its rounded reciprocal)
    scale = peak / torch.full_like(peak, 127.0)
    q = torch.clamp(torch.round(gc / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gc - deq


def ef_int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(leaves: Leaves) -> Leaves:
    """Zero float32 error accumulators shaped as ``leaves``."""
    return {k: [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in ts]
            for k, ts in leaves.items()}


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new first dim, rank order."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.numel(),))
    # the newer name where torch has it (the older one warns there)
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, x.contiguous().reshape(-1), group=group)
    return out.view((n,) + tuple(x.shape))


def _reduce_one(g: torch.Tensor, e: torch.Tensor, group
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    q, scale, new_e = ef_int8_compress(g, e)
    qs = _gather(q, group)  # int8 on the wire
    ss = _gather(scale, group)
    summed = torch.tensordot(ss, qs.float(), dims=([0], [0]))
    return summed.to(g.dtype), new_e


def compressed_psum_tree(grads: Leaves, err: Leaves, group=None
                         ) -> Tuple[Leaves, Leaves]:
    """The sum of ``grads`` over the ranks of ``group`` (default: the
    world) with int8 on the wire: each tensor quantized on its own with
    its carried error, the int8 values and the scales gathered, the sum of
    ``scale_r * q_r`` over the ranks formed in float32 on every rank (the
    JAX ``tensordot(ss, qs)``) and cast to the gradient's dtype. Returns
    ``(reduced, new_err)`` shaped as ``grads``. Every rank calls it with
    the same leaves in the same order."""
    reduced: Leaves = {}
    new_err: Leaves = {}
    for k, gs in grads.items():
        outs = [_reduce_one(g, e, group) for g, e in zip(gs, err[k])]
        reduced[k] = [o[0] for o in outs]
        new_err[k] = [o[1] for o in outs]
    return reduced, new_err
