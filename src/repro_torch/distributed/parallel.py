"""The collectives of the compute split over the ``model`` mesh axis.

Where the JAX models constrain an activation to a block of the sequence,
heads, ``d_ff`` or experts on ``model`` (``plan.constrain``), GSPMD inserts
the collectives that move it there. The port's layers call them by hand
with a :class:`Split` (the rank's :class:`~repro_torch.distributed.sharding.RankView`
at one sequence length): the residual stream lives in sequence blocks
between layers, attention gathers K/V over the sequence (or, under head
TP, the rows, and sums its heads' partial outputs back onto the blocks),
and so on (``repro_torch.models.layers``).

The differentiable collectives, each along the sequence dim (dim 1) on the
model axis's process group, each the identity on a group of one rank:

  - :func:`gather_seq`: all-gather the blocks; backward a reduce-scatter;
  - :func:`keep_seq`: this rank's block of a whole-sequence tensor; the
    backward is the block's gradient in place, zeros elsewhere;
  - :func:`scatter_sum`: a partial sum (this rank's heads, ``d_ff``
    columns or experts) reduce-scattered onto the blocks, backward an
    all-gather; where the sequence is not split, all-reduced, backward an
    all-reduce.

Gradients follow one rule: where ranks hold the same activation (after a
gather, or where nothing splits it), each holds a *partial* gradient, its
own consumers' share, and the true gradient is the sum over the ranks.
A parameter's gradient is then a partial sum over every mesh dim that
splits the compute (``repro_torch.distributed.zero``), and a loss that
several ranks compute alike is weighted by the share of them. Under that
rule :func:`keep_seq`'s backward is the zero-padded block, not the
all-gather of Megatron's replicated-gradient form (an all-gather would
count a whole-sequence mixer's weight gradients once on every rank), and
an all-reduce's backward sums the partial gradients where Megatron's
passes the replicated one on.

Serving on a mesh adds collectives with no backward: :func:`all_reduce_max_`,
and :func:`softmax_combine`, a decode step's attention over a KV cache whose
slots are split over the model axis (the global max of the scores, the
global sum of their exponentials, the ranks' partial ``probs @ v`` summed),
so each rank reads only its block of the cache; :func:`all_gather` gathers
along any dim (the logits' vocab blocks, the cache's blocks).

The primitives :func:`all_gather`, :func:`reduce_scatter`,
:func:`all_reduce_` and :func:`all_reduce_max_` (also the ZeRO gathers and
reductions of ``zero.Placed``) call ``torch.distributed`` directly, never
DTensor (whose ``full_tensor`` of a CUDA tensor over gloo ends the
process), and never move a tensor off its device themselves (gloo stages a
CUDA tensor through the host on its own). Every call adds its input's
bytes to :data:`COUNTS` by kind, and its result's bytes to
:data:`RESULT_BYTES` (an all-gather's gathered tensor, a reduce-scatter's
block, an all-reduce's tensor itself), the bytes
``repro_torch.launch.comm_analysis`` charges an all-gather on the wire.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .sharding import Block, RankView

#: collectives by kind: [calls, bytes of this rank's input]
COUNTS: Dict[str, List[int]] = {}
#: collectives by kind: bytes of this rank's results
RESULT_BYTES: Dict[str, int] = {}


def reset_counts() -> None:
    COUNTS.clear()
    RESULT_BYTES.clear()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count(kind: str, x: torch.Tensor, out: torch.Tensor) -> None:
    c = COUNTS.setdefault(kind, [0, 0])
    c[0] += 1
    c[1] += _nbytes(x)
    RESULT_BYTES[kind] = RESULT_BYTES.get(kind, 0) + _nbytes(out)


def _size(group) -> int:
    return dist.get_world_size(group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``x`` along ``dim`` (negative counts from the last)
    from every rank of ``group``, concatenated in rank order (``x`` itself
    on a group of one)."""
    w = _size(group)
    if w == 1:
        return x
    dim = dim % x.dim()
    x = x.contiguous()
    out = x.new_empty((w * x.shape[0],) + tuple(x.shape[1:]))
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)
    _count("all_gather", x, out)
    if dim == 0:
        return out
    shape = x.shape[:dim] + (w * x.shape[dim],) + x.shape[dim + 1:]
    return out.view((w,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``group``
    (the blocks in rank order; ``x`` itself on a group of one)."""
    w = _size(group)
    if w == 1:
        return x
    n = x.shape[dim]
    if n % w:
        raise ValueError(f"a dim of {n} does not split over {w} ranks")
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n // w,) + tuple(xs.shape[1:]))
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, xs, group=group)
    _count("reduce_scatter", xs, out)
    return out.movedim(0, dim).contiguous()


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed in place over ``group``."""
    if _size(group) > 1:
        dist.all_reduce(x, group=group)
        _count("all_reduce", x, x)
    return x


def all_reduce_max_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` replaced in place by its elementwise max over ``group``."""
    if _size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
        _count("all_reduce_max", x, x)
    return x


def softmax_combine(scores: torch.Tensor, v: torch.Tensor, group,
                    dtype: torch.dtype) -> torch.Tensor:
    """Grouped attention whose keys are split over ``group``: ``scores``
    (B, Hkv, G, S, T) float32, scaled and masked (to ``NEG_INF``), over this
    rank's T keys, and ``v`` (B, T, Hkv, D) their values; returns the output
    (B, S, Hkv * G, D) in ``dtype`` over every rank's keys, the same on
    every rank. The local max, then the global max ``m``; ``exp(s - m)``
    and its sum over every rank's keys ``l``; the probabilities ``p / l``
    rounded to ``dtype`` (as the meshless softmax's are) and this rank's
    ``probs @ v`` in float32 (or ``dtype``, if wider), summed over the
    ranks and rounded once. A rank whose keys are all masked adds
    nothing."""
    acc = torch.promote_types(dtype, torch.float32)
    m = all_reduce_max_(scores.amax(dim=-1, keepdim=True), group)
    p = torch.exp(scores - m)
    l = all_reduce_(p.sum(dim=-1, keepdim=True), group)
    probs = (p / l).to(dtype).to(acc)
    out = all_reduce_(torch.einsum("bkgst,btkd->bskgd", probs, v.to(acc)), group)
    B, Hkv, G, S, _ = scores.shape
    return out.reshape(B, S, Hkv * G, v.shape[-1]).to(dtype)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, 1, ctx.group), None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, 1, ctx.group), None


class _SumPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


@dataclasses.dataclass(frozen=True)
class Split:
    """A :class:`RankView` at one call's sequence length: ``seq``, this
    rank's block of the sequence (None: not split)."""

    view: RankView
    seq: Optional[Block]

    @property
    def group(self):
        return self.view.group

    def heads(self, n: int) -> Optional[Block]:
        return self.view.heads(n)

    def ffn(self, f: int) -> Optional[Block]:
        return self.view.ffn(f)

    def experts(self, E: int) -> Optional[Block]:
        return self.view.experts(E)

    def cache(self, L: int) -> Optional[Block]:
        return self.view.cache(L)


def split_at(view: Optional[RankView], S: int) -> Optional[Split]:
    """``view`` at sequence length ``S``; None without a view or where the
    model axis has one rank (the meshless arithmetic)."""
    if view is None or view.parts == 1:
        return None
    return Split(view, view.seq(S))


def gather_seq(x: torch.Tensor, sp: Optional[Split]) -> torch.Tensor:
    """The whole sequence of ``x`` (B, S/parts, ...) when ``sp`` splits it,
    else ``x``."""
    if sp is None or sp.seq is None:
        return x
    return _GatherSeq.apply(x, sp.group)


def keep_seq(x: torch.Tensor, sp: Optional[Split]) -> torch.Tensor:
    """This rank's block of the whole-sequence ``x`` when ``sp`` splits the
    sequence, else ``x``."""
    if sp is None or sp.seq is None:
        return x
    return x[:, sp.seq.start:sp.seq.stop]


def scatter_sum(x: torch.Tensor, sp: Optional[Split]) -> torch.Tensor:
    """The sum over the model axis of the partial ``x`` (B, S, ...): this
    rank's sequence block of it where ``sp`` splits the sequence, else the
    whole sum."""
    if sp is None:
        return x
    if sp.seq is None:
        return _SumPartial.apply(x, sp.group)
    return _ScatterSum.apply(x, sp.group)
