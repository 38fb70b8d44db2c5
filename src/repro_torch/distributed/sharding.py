"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) for the model zoo:
the port of ``repro.distributed.sharding`` on a ``torch.distributed``
``DeviceMesh``.

Production meshes are fixed -- single-pod ``(data=16, model=16)`` or
multi-pod ``(pod=2, data=16, model=16)`` -- but *how* each architecture
uses the axes is chosen per config here, with divisibility-aware
fallbacks, so that parameter specs always divide:

  - batch           -> ("pod", "data")   [pure DP across pods]
  - attention heads -> "model" when n_(kv_)heads % model == 0 (head TP),
                       else sequence parallelism on "model" (SP mode);
  - d_ff / experts / vocab -> "model" (TP / EP);
  - d_model on parameters -> "data" (FSDP / ZeRO-3: params, grads and
    optimizer state all carry the same spec);
  - KV-cache sequence dim -> "model".

The decisions are the JAX package's line for line. A *spec* is a tuple
with one entry per tensor dim: ``None`` (replicated), a mesh axis name, or
a tuple of names (the dim split over their product, the first major); it
stands where JAX has a ``PartitionSpec``. :func:`spec_to_sharding` turns
it into the DTensor placements of that spec over the mesh.

``ShardingPlan.constrain`` is a no-op without a mesh and on a plain tensor.
The port's models do not call it: where JAX constrains an activation, a
model on a mesh (a trainer's, or one placed for serving) asks
:class:`RankView` (the plan at one rank's coordinate) which block of the
sequence, heads, ``d_ff``, experts, vocab or KV cache is this rank's, and
runs that block (``repro_torch.distributed.parallel``, the layers of
``repro_torch.models``).

:func:`cache_leaf_spec`, :func:`cache_specs` and :func:`input_specs` are
the JAX package's (``repro.models.model``) line for line: the specs of a
decode cache's leaves, keyed by their shapes as JAX keys them, and of the
abstract inputs of a train or prefill step, each leaf a :class:`LeafSpec`
(shape, dtype name, spec; no spec without a mesh), nothing allocated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

AxisSpec = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisSpec, ...]


class LeafSpec(NamedTuple):
    """An abstract array (JAX's ``ShapeDtypeStruct``): its shape, dtype
    name (``"bfloat16"``, ``"int32"``, ...) and spec (None: no sharding)."""

    shape: Tuple[int, ...]
    dtype: str
    spec: Optional[Spec] = None


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Named mesh geometry; ``data_axes`` may span ("pod", "data")."""

    data_axes: Tuple[str, ...]
    model_axis: str
    sizes: dict

    @property
    def data_size(self) -> int:
        return int(math.prod(self.sizes[a] for a in self.data_axes))

    @property
    def model_size(self) -> int:
        return int(self.sizes[self.model_axis])


def mesh_shape_of(mesh: Any) -> MeshShape:
    """The geometry of a ``DeviceMesh`` (its ``mesh_dim_names`` and
    ``shape``): the ``model`` axis, or the last one, and the rest as data
    axes, as JAX's ``mesh_shape_of`` reads a ``Mesh``."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, (int(s) for s in mesh.shape)))
    model_axis = "model" if "model" in names else names[-1]
    data_axes = tuple(a for a in names if a != model_axis)
    return MeshShape(data_axes=data_axes, model_axis=model_axis, sizes=sizes)


@dataclasses.dataclass
class ShardingPlan:
    """Resolves logical tensor dims to mesh axes for one (config, mesh)."""

    mesh: Any
    shape: Optional[MeshShape]
    attn_mode: str  # "head_tp" | "seq_tp" | "ddp"
    kv_heads_sharded: bool
    heads_sharded: bool
    # ddp mode: True when the global batch does NOT cover the model axis, so
    # sequences shard over it instead (e.g. batch 256 on the 512-device
    # multi-pod mesh). Resolved at plan build from the cell's global batch.
    ddp_seq_over_model: bool = False

    # ---- logical dim -> axis spec (divisibility already resolved) ----
    def batch(self, size: int) -> AxisSpec:
        if self.shape is None:
            return None
        axes = []
        rem = size
        cand = list(self.shape.data_axes)
        if self.attn_mode == "ddp":
            cand.append(self.shape.model_axis)  # pure DP over every axis
        for a in cand:
            s = self.shape.sizes[a]
            if rem % s == 0:
                axes.append(a)
                rem //= s
            else:
                break
        return tuple(axes) if axes else None

    def model_dim(self, size: int) -> AxisSpec:
        """TP axis for d_ff / experts / padded vocab / flattened head dims."""
        if self.shape is None or self.attn_mode == "ddp":
            return None
        return self.shape.model_axis if size % self.shape.model_size == 0 else None

    def fsdp_dim(self, size: int) -> AxisSpec:
        """FSDP axis for the d_model dim of parameters: the innermost data
        axis only (the pod axis stays pure DP, so cross-pod traffic is the
        gradient all-reduce, not parameter gathers). A 1-D mesh has no data
        axis (its one axis is the model axis) and so no FSDP axis, where
        the JAX package's ``fsdp_dim`` raises ``IndexError``."""
        if self.shape is None or not self.shape.data_axes:
            return None
        a = self.shape.data_axes[-1]
        return a if size % self.shape.sizes[a] == 0 else None

    def heads(self, n: int) -> AxisSpec:
        if self.shape is None or self.attn_mode != "head_tp":
            return None
        return self.shape.model_axis if n % self.shape.model_size == 0 else None

    def seq(self, size: int) -> AxisSpec:
        """Sequence-parallel axis (SP mode activations / KV cache seq dim)."""
        if self.shape is None:
            return None
        if self.attn_mode == "ddp" and not self.ddp_seq_over_model:
            return None
        return self.shape.model_axis if size % self.shape.model_size == 0 else None

    # ---- specs and placements ----
    def spec(self, *dims: AxisSpec) -> Spec:
        return tuple(dims)

    def constrain(self, x, *dims: AxisSpec):
        """``x`` redistributed to the spec ``dims`` when it is a ``DTensor``
        on this plan's mesh; else (no mesh, a plain tensor) ``x``."""
        from torch.distributed.tensor import DTensor

        if self.mesh is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, spec_to_sharding(self.mesh, dims))

    def sharding(self, *dims: AxisSpec):
        return spec_to_sharding(self.mesh, tuple(dims))


def make_plan(mesh: Any, *, n_heads: int, n_kv_heads: int,
              prefer: str = "auto", global_batch: Optional[int] = None) -> ShardingPlan:
    """``prefer``:
      - "auto"/"seq": context-parallel ZeRO-3 -- activations stay
        (batch, seq/model) sharded; K/V and weights are gathered at use;
      - "head": head-TP attention + d_ff TP (requires n_heads % model == 0);
      - "ddp": pure data parallelism over EVERY mesh axis (batch spans
        pod x data x model; params replicated -- pair with ``fsdp=False``).
    """
    if mesh is None:
        return ShardingPlan(None, None, attn_mode="seq_tp", kv_heads_sharded=False,
                            heads_sharded=False)
    shape = mesh_shape_of(mesh)
    heads_ok = n_heads % shape.model_size == 0
    kv_ok = n_kv_heads % shape.model_size == 0
    if prefer == "ddp":
        attn_mode = "ddp"
    else:
        attn_mode = "head_tp" if (prefer == "head" and heads_ok) else "seq_tp"
    seq_over_model = False
    if attn_mode == "ddp" and global_batch is not None:
        # Does the greedy batch sharding reach/cover the model axis? If not,
        # the model axis would sit idle -- give it to the sequence dim.
        rem = global_batch
        covered = True
        for a in shape.data_axes:
            if rem % shape.sizes[a] == 0:
                rem //= shape.sizes[a]
            else:
                covered = False
                break
        seq_over_model = not (covered and rem % shape.model_size == 0)
    return ShardingPlan(mesh, shape, attn_mode=attn_mode,
                        kv_heads_sharded=kv_ok and attn_mode == "head_tp",
                        heads_sharded=heads_ok and attn_mode == "head_tp",
                        ddp_seq_over_model=seq_over_model)


@dataclasses.dataclass(frozen=True)
class Block:
    """A rank's block ``start:stop`` of a dim split in equal blocks."""

    start: int
    stop: int

    @property
    def size(self) -> int:
        return self.stop - self.start


class RankView:
    """What of the compute is this rank's under ``plan``: the blocks of a
    dim that the ``model`` axis splits, at this rank's coordinate on it
    (``index`` of ``parts``). Each answer follows the plan's own rules, and
    is None where the dim is not split (also when the axis has one rank):

      - :meth:`seq`: the sequence, where ``plan.seq(S)`` names the axis
        (``seq_tp``, ``head_tp``, and ``ddp`` with ``ddp_seq_over_model``);
      - :meth:`heads`: the attention heads, under ``head_tp`` where
        ``plan.heads(n)`` names it;
      - :meth:`ffn`: the columns of a SwiGLU of width ``f`` (the gate's and
        the up-projection's alike), under ``head_tp`` where
        ``plan.model_dim(2 f)`` names it and ``f`` divides too (JAX's
        split of the concatenated ``2 f`` pairs each gate with its up
        column only when it does);
      - :meth:`experts`: the MoE experts, where ``plan.model_dim(E)``
        names it;
      - :meth:`vocab`: the rows of the embedding table and the columns of
        the unembedding (``padded_vocab``), where ``plan.model_dim(V)``
        names the axis, as ``param_specs`` splits ``embed`` and ``head``;
      - :meth:`cache`: the sequence of a KV cache of ``L`` slots (a
        self-attention layer's or a cross cache's frames), where
        ``plan.seq(L)`` names it, as :func:`cache_leaf_spec` splits it.

    ``mesh`` (a ``DeviceMesh``, or anything with ``get_group``) gives the
    model axis's process ``group``, taken when first asked."""

    def __init__(self, plan: ShardingPlan, mesh: Any, coordinate):
        names = tuple(mesh.mesh_dim_names)
        self.plan = plan
        self.mesh = mesh
        self.dim = names.index(plan.shape.model_axis)
        self.parts = plan.shape.model_size
        self.index = int(list(coordinate)[self.dim])
        self._group = None

    @property
    def group(self):
        if self._group is None:
            self._group = self.mesh.get_group(self.dim)
        return self._group

    def _block(self, n: int, axis: AxisSpec) -> Optional[Block]:
        if axis is None or self.parts == 1:
            return None
        step = n // self.parts
        return Block(self.index * step, (self.index + 1) * step)

    def seq(self, S: int) -> Optional[Block]:
        return self._block(S, self.plan.seq(S))

    def heads(self, n: int) -> Optional[Block]:
        return self._block(n, self.plan.heads(n))

    def ffn(self, f: int) -> Optional[Block]:
        if self.plan.attn_mode != "head_tp" or f % self.parts:
            return None
        return self._block(f, self.plan.model_dim(2 * f))

    def experts(self, E: int) -> Optional[Block]:
        return self._block(E, self.plan.model_dim(E))

    def vocab(self, V: int) -> Optional[Block]:
        return self._block(V, self.plan.model_dim(V))

    def cache(self, L: int) -> Optional[Block]:
        return self._block(L, self.plan.seq(L))


def rank_view(plan: ShardingPlan, mesh: Any) -> Optional[RankView]:
    """This rank's :class:`RankView` of ``plan`` on ``mesh``; None without
    a mesh."""
    if mesh is None or plan.shape is None:
        return None
    return RankView(plan, mesh, mesh.get_coordinate())


def axes_of(entry: AxisSpec) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_to_sharding(mesh: Any, spec: Spec):
    """The DTensor placements of ``spec`` over ``mesh``, one per mesh dim:
    ``Shard(i)`` on each mesh dim that tensor dim ``i`` names, else
    ``Replicate()``; None without a mesh. A dim named by several axes is
    split over them in order, the first major, as a ``PartitionSpec``
    splits it (DTensor's default order of nested shards, so the names of
    one entry must come in the mesh's order)."""
    if mesh is None:
        return None
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        dims = [names.index(a) for a in axes_of(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for d in dims:
            out[d] = Shard(i)
    return tuple(out)


# ---------------------------------------------------------------------------
# Input and cache specs (the JAX ``input_specs`` / ``cache_specs``)
# ---------------------------------------------------------------------------


def input_specs(cfg, seq_len: int, global_batch: int, kind: str,
                plan: Optional[ShardingPlan] = None) -> Dict[str, LeafSpec]:
    """Abstract inputs for ``kind`` in {train, prefill}; decode uses
    ``cache_specs`` + a (B, 1) token. Specs attached when a plan is given."""

    def sds(shape, dtype, *dims):
        if plan is not None and plan.mesh is not None:
            return LeafSpec(shape, dtype, plan.spec(*dims))
        return LeafSpec(shape, dtype)

    B, S = global_batch, seq_len
    batch: Dict[str, LeafSpec] = {}
    bspec = plan.batch(B) if plan is not None else None
    if cfg.encoder_layers:
        batch["frames"] = sds((B, S, cfg.d_model), "bfloat16", bspec, None, None)
        batch["tokens"] = sds((B, S), "int32", bspec, None)
    elif cfg.input_kind == "embeddings":
        batch["embeds"] = sds((B, S, cfg.d_model), "bfloat16", bspec, None, None)
    else:
        batch["tokens"] = sds((B, S), "int32", bspec, None)
    if kind == "train":
        batch["targets"] = sds((B, S), "int32", bspec, None)
    return batch


def cache_specs(cfg, plan: Optional[ShardingPlan], batch: int, cache_len: int) -> Any:
    """:class:`LeafSpec` tree matching ``init_cache`` in the JAX layout
    (``repro_torch.interop.cache_to_jax``), with specs on a mesh. The cache
    is built on the meta device: nothing is allocated."""
    from ..interop import cache_layout
    from ..models.model import Model, init_cache

    model = Model(cfg, device="meta")
    cache = init_cache(model, batch, cache_len)

    def leaf(shape: Tuple[int, ...], dtype: str) -> LeafSpec:
        if plan is None or plan.mesh is None:
            return LeafSpec(shape, dtype)
        return LeafSpec(shape, dtype, cache_leaf_spec(cfg, plan, shape))

    def name(t) -> str:
        return str(t.dtype).split(".")[-1]

    return cache_layout(model, cache, lambda t: leaf(tuple(t.shape), name(t)),
                        lambda ts: leaf((len(ts),) + tuple(ts[0].shape), name(ts[0])),
                        lambda _pos: leaf((), "int32"))


def cache_leaf_spec(cfg, plan: ShardingPlan, shape: Tuple[int, ...]) -> Spec:
    """Sharding for a cache leaf, keyed by rank/shape structure."""
    nd = len(shape)
    if nd == 0:
        return ()
    # leading scan-units dim?
    off = 1 if (cfg.n_units > 0 and shape[0] == cfg.n_units and nd >= 2) else 0
    dims: List[Any] = [None] * nd
    body = shape[off:]
    if len(body) == 4:  # (B, L, H, D) KV cache
        dims[off + 0] = plan.batch(body[0])
        dims[off + 1] = plan.seq(body[1])
    elif len(body) >= 1:
        dims[off + 0] = plan.batch(body[0])
    return tuple(dims)
