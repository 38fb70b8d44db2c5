"""Model assembly: the training loss, prefill and greedy decode.

The port of ``repro.models.model`` for the layer kinds ``rglru``,
``sliding``, ``full``, ``mlstm`` and ``slstm``, with the ``swiglu`` FFN,
``moe`` (arctic-480b, kimi-k2-1t-a32b) or none (recurrentgemma-2b,
qwen2-1.5b, gemma3-4b, yi-9b, phi4-mini-3.8b, phi-3-vision-4.2b;
xlstm-350m, whose layers have no FFN), and the encoder-decoder
whisper-tiny:

    embed (tokens, or precomputed embeddings) -> prefix layers -> pattern
    units -> tail layers -> final RMSNorm -> unembedding (the tied table,
    or ``head``)

The ``cfg.first_k_dense`` prefix layers (kimi's first) are of the
pattern's first kind with a dense SwiGLU of ``cfg.d_ff`` in place of the
config's MoE (:func:`_ffn_kind`'s ``dense_override``, as JAX). A MoE
layer's FFN returns its load-balancing loss beside its output; the
training loss adds ``MOE_AUX_WEIGHT`` times their sum over layers.

With ``cfg.input_kind == "embeddings"`` (phi-3-vision's stubbed vision
frontend) a batch's ``embeds`` (B, S, d) enter the first layer in the
compute dtype, unscaled; decode still embeds tokens. An untied model
(``tie_embeddings=False``, yi-9b) has its own ``head`` (d, padded_vocab).
With ``cfg.rope_theta <= 0`` (whisper) attention has no RoPE and the
inputs get sinusoidal absolute positions (:func:`sinusoidal`). With
``cfg.encoder_layers > 0`` (whisper, its audio frontend stubbed) a batch's
``frames`` (B, T, d) run through the encoder (:func:`_encode`:
``encoder_layers`` non-causal ``full`` layers, then ``encoder_norm``), and
every decoder layer cross-attends to its output, the memory, after its
mixer; a decode cache then also holds each layer's cross cache.

The JAX package stacks each pattern position's params over ``n_units`` and
runs the units with ``lax.scan``; here the units are a Python loop over one
``Block`` per layer, in order. The JAX code threads a ``ShardingPlan``
through every call; here a ``Model`` on a mesh (a trainer's, or one placed
for serving by ``repro_torch.runtime.place_on_mesh``) holds the plan at its
rank's coordinate (``view``, a ``distributed.sharding.RankView``), and the
training loss and a prefill pass it, at the batch's sequence length, to
every layer (``split``): the residual stream is this rank's sequence block
between layers, and each layer runs this rank's share of the sequence,
heads, ``d_ff`` or experts (``repro_torch.models.layers``). Such a model
also holds each rank's shards as its parameters and a ``gather`` hook:
every part of a layer (and the embedding, head and final norms around
them) runs with its parameters gathered whole for that part only
(:func:`_whole`, :func:`_caller`), so under a checkpointing ``remat`` the
recompute gathers them again.

Serving on a mesh (``rows``, the ``distributed.zero.MeshSplit`` of the
batch, set): ``prefill``, ``init_cache`` and ``decode_step`` take this
rank's rows of the batch. The cache holds this rank's block of each
attention cache's slots and of the cross caches' frames where the plan
splits them (``RankView.cache``; the global lengths in ``kv_len`` and
``cross_len``), the recurrent states whole; a decode step passes
``parallel.split_at(view, 1)`` to every layer. The embedding table and
the unembedding stay this rank's block of the vocab where ``param_specs``
splits it (gathered over the other mesh dims only): the lookup is a masked
lookup of the block summed over the model axis (exact: one rank holds each
row) and the logits are the blocks' products all-gathered.

Entry points: :func:`init_params` (a ``Model`` with weights drawn from a
``torch.Generator``; ``trainable=True`` for masters in ``cfg.param_dtype``
that require grad), :func:`loss_fn` (the training loss, with
:func:`cross_entropy` and :func:`_chunked_xent`, and ``cfg.remat`` over
each pattern unit: :func:`backbone`),
:func:`init_cache`, :func:`prefill` and :func:`decode_step`. A cache is
``{"layers": [per-layer state, prefix layers first], "pos": int}``, and
for an encoder model
``"cross"``: [per-layer ``{"ck", "cv"}``]; on a mesh also ``"kv_len"``
(each layer's global KV slots, None for a recurrent state) and, with
``"cross"``, ``"cross_len"``;
``repro_torch.interop.cache_to_jax`` gives it in the JAX package's layout.
:func:`param_leaves` groups the parameters as the JAX params pytree holds
them, for the optimizers, the checkpoint and the interop helpers.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from ..distributed import parallel as P
from . import layers as L
from .config import ArchConfig

Cache = Dict[str, Any]

#: the weight of the MoE load-balancing loss in the training loss (JAX
#: ``repro.models.model.MOE_AUX_WEIGHT``)
MOE_AUX_WEIGHT = 0.01
#: the layer kinds (all of the JAX package's); another raises ``ValueError``
#: as the JAX ``_layer_init`` does
KINDS = ("rglru", "sliding", "full", "mlstm", "slstm")
_MIXERS = {"rglru": L.RGLRU, "mlstm": L.MLSTM, "slstm": L.SLSTM}


# ---------------------------------------------------------------------------
# Structure helpers
# ---------------------------------------------------------------------------


def layer_kinds(cfg: ArchConfig) -> Dict[str, List[str]]:
    """prefix / pattern / tail mixer kinds."""
    prefix = [cfg.pattern[0] if cfg.pattern else "full"] * cfg.first_k_dense
    return {"prefix": prefix, "pattern": list(cfg.pattern), "tail": list(cfg.tail_kinds)}


def _ffn_kind(cfg: ArchConfig, *, dense_override: bool = False) -> str:
    """A layer's FFN, as the JAX ``_ffn_kind``: ``moe`` for a MoE config
    unless ``dense_override`` (the prefix layers), ``swiglu``, or ``none``
    when ``d_ff == 0`` (the xLSTM blocks carry their own projections)."""
    if cfg.d_ff == 0 and cfg.ffn_kind != "moe":
        return "none"
    if cfg.ffn_kind == "moe" and not dense_override:
        return "moe"
    return "swiglu" if cfg.d_ff > 0 else "none"


# ---------------------------------------------------------------------------
# Layers and model
# ---------------------------------------------------------------------------


def _direct(part, *inputs):
    return part(*inputs)


class Block(nn.Module):
    """One layer: pre-norm mixer (RG-LRU, mLSTM, sLSTM, or attention over
    the whole prefix or over ``cfg.window`` positions; ``causal=False``:
    over every position, the encoder's), with ``cross`` a pre-norm
    cross-attention to the encoder's memory (``norm_cross``, ``cross``),
    and, unless the FFN kind ``ffn`` (default ``_ffn_kind(cfg)``) is
    ``none``, the pre-norm FFN: SwiGLU, or ``moe`` (:class:`layers.MoE`),
    each added to the residual stream in that order. A layer without an
    FFN has no ``norm2`` and no ``ffn``, as the JAX ``_layer_init`` builds
    it. ``forward(..., return_aux=True)`` also returns the layer's MoE
    load-balancing loss (None for another FFN)."""

    def __init__(self, cfg: ArchConfig, kind: str, device=None, trainable: bool = False,
                 cross: bool = False, causal: bool = True, ffn: Optional[str] = None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(kind)
        self.kind = kind
        self.ffn_kind = ffn = ffn or _ffn_kind(cfg)
        pdt = L.param_dtype(cfg)
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device, trainable, pdt)
        if kind in _MIXERS:
            self.mixer = _MIXERS[kind](cfg, device, trainable)
        else:  # the window as the JAX _layer_apply passes it
            self.mixer = L.Attention(cfg, device, trainable,
                                     window=cfg.window if kind == "sliding" else None,
                                     causal=causal)
        if cross:
            self.norm_cross = L.RMSNorm(cfg.d_model, cfg.norm_eps, device, trainable, pdt)
            self.cross = L.Attention(cfg, device, trainable, causal=False)
        else:
            self.norm_cross = self.cross = None
        if ffn != "none":
            self.norm2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device, trainable, pdt)
            self.ffn = (L.MoE if ffn == "moe" else L.SwiGLU)(cfg, device, trainable)
        else:
            self.norm2 = self.ffn = None

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.norm1, self.mixer, self.norm_cross, self.cross, self.norm2, self.ffn):
            if m is not None:
                m.init_(gen)

    def _mixer_out(self, x: torch.Tensor, split: Optional[P.Split] = None) -> torch.Tensor:
        return self.mixer(self.norm1(x), split=split)

    def _mixer_state(self, x: torch.Tensor, cache_len: Optional[int],
                     split: Optional[P.Split] = None):
        return self.mixer(self.norm1(x), return_state=True, cache_len=cache_len, split=split)

    def _mixer_step(self, x: torch.Tensor, cache: L.Cache, pos: int,
                    split: Optional[P.Split] = None, length: Optional[int] = None):
        kw = {"split": split, "length": length} if isinstance(self.mixer, L.Attention) else {}
        return self.mixer.decode(self.norm1(x), cache, pos, **kw)

    def _cross_out(self, x: torch.Tensor, memory: torch.Tensor,
                   split: Optional[P.Split] = None) -> torch.Tensor:
        return self.cross(self.norm_cross(x), memory=memory, split=split)

    def _cross_step(self, x: torch.Tensor, cross: L.Cache, split: Optional[P.Split] = None,
                    length: Optional[int] = None) -> torch.Tensor:
        return self.cross.cross_decode(self.norm_cross(x), cross, split, length)

    def part_modules(self, part) -> Tuple[nn.Module, ...]:
        """The modules whose parameters ``part`` (one of ``_mixer_out``,
        ``_mixer_state``, ``_mixer_step``, ``_cross_out``, ``_cross_step``,
        ``_ffn_out``) uses."""
        name = part.__name__
        if name.startswith("_mixer"):
            return self.norm1, self.mixer
        if name.startswith("_cross"):
            return self.norm_cross, self.cross
        return self.norm2, self.ffn

    def _ffn_out(self, x: torch.Tensor, split: Optional[P.Split] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The FFN of norm2(x), and a MoE FFN's aux loss (else None)."""
        out = self.ffn(self.norm2(x), split)
        return out if self.ffn_kind == "moe" else (out, None)

    def _add_ffn(self, x: torch.Tensor, call=_direct, split: Optional[P.Split] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x plus the FFN of norm2(x), and a MoE FFN's aux loss (else None)."""
        if self.ffn is None:
            return x, None
        out, aux = call(self._ffn_out, x, split)
        return x + out, aux

    def forward(self, x: torch.Tensor, *, memory: Optional[torch.Tensor] = None,
                return_state: bool = False, cache_len: Optional[int] = None,
                return_aux: bool = False, call=_direct, split: Optional[P.Split] = None):
        """``call(part, *inputs)`` runs each part that adds to the residual
        stream (norm and mixer, norm and cross-attention, norm and FFN):
        directly, or as a checkpointed region under ``remat="names"``, and
        on a mesh with the part's parameters gathered (:func:`_caller`).
        With ``split`` (on a mesh) ``x`` is this rank's block of the
        residual stream and each part runs its share
        (``repro_torch.models.layers``); with ``return_state`` the mixer's
        state is this rank's (its block of an attention cache)."""
        if return_state:
            out, state = call(self._mixer_state, x, cache_len, split)
        else:
            out = call(self._mixer_out, x, split)
        x = x + out
        if self.cross is not None and memory is not None:
            x = x + call(self._cross_out, x, memory, split)
        x, aux = self._add_ffn(x, call, split)
        outs = (x,) + ((state,) if return_state else ())
        if return_aux:
            outs += (aux,)
        return outs if len(outs) > 1 else x

    def cache_init(self, batch: int, cache_len: int) -> L.Cache:
        return self.mixer.cache_init(batch, cache_len)

    def decode(self, x: torch.Tensor, cache: L.Cache, pos: int,
               cross: Optional[L.Cache] = None, call=_direct,
               split: Optional[P.Split] = None, length: Optional[int] = None,
               cross_len: Optional[int] = None) -> Tuple[torch.Tensor, L.Cache]:
        """One token; with ``cross`` (this layer's cross cache) the
        cross-attention to the cached memory follows the mixer. ``call``
        runs each part as in :meth:`forward`; on a mesh ``split`` (at S = 1)
        and the global lengths of the attention cache (``length``) and of
        the cross cache (``cross_len``) say which block of them this rank
        holds."""
        out, new = call(self._mixer_step, x, cache, pos, split, length)
        x = x + out
        if self.cross is not None and cross is not None:
            x = x + call(self._cross_step, x, cross, split, cross_len)
        return self._add_ffn(x, call, split)[0], new


class Model(nn.Module):
    """The model: the embedding, the ``cfg.first_k_dense`` prefix layers
    (``n_prefix``; a dense FFN), ``n_units`` pattern units then the tail,
    as ``Block``s in order (``kinds[i]`` is layer i's kind; each with
    cross-attention when ``cfg.encoder_layers``), the final norm and,
    unless ``cfg.tie_embeddings``, the output ``head``; an encoder model
    also has ``encoder`` (``cfg.encoder_layers`` non-causal ``full``
    ``Block``s) and ``encoder_norm``. Weights are
    uninitialised; :func:`init_params` or
    ``repro_torch.interop.model_from_jax`` fills them. ``trainable=True``
    holds masters that require grad (training) in ``cfg.param_dtype``, and
    float32 where the JAX package names it (``layers.new_param``); the
    default stores the matrix weights in ``cfg.dtype`` without grad
    (serving)."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        kinds = layer_kinds(cfg)
        self.n_prefix = len(kinds["prefix"])
        self.kinds = kinds["prefix"] + kinds["pattern"] * cfg.n_units + kinds["tail"]
        dt, pdt = L.compute_dtype(cfg), L.param_dtype(cfg)
        self.embed = L.new_param((cfg.padded_vocab, cfg.d_model), dt, device, trainable, pdt)
        cross = cfg.encoder_layers > 0
        dense = _ffn_kind(cfg, dense_override=True)
        self.layers = nn.ModuleList(
            Block(cfg, k, device, trainable, cross=cross,
                  ffn=dense if i < self.n_prefix else None)
            for i, k in enumerate(self.kinds))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device, trainable, pdt)
        self.head = None if cfg.tie_embeddings else L.new_param(
            (cfg.d_model, cfg.padded_vocab), dt, device, trainable, pdt)
        if cross:
            self.encoder = nn.ModuleList(Block(cfg, "full", device, trainable, causal=False,
                                               ffn="swiglu")
                                         for _ in range(cfg.encoder_layers))
            self.encoder_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device, trainable, pdt)
        else:
            self.encoder = self.encoder_norm = None
        # a mesh's hooks: gather(modules, keep=) -> a context in which the
        # modules' own parameters are whole (repro_torch.distributed.zero),
        # view, the plan at this rank's coordinate (sharding.RankView), and
        # for serving rows, the batch's split over the mesh (zero.MeshSplit)
        self.gather = None
        self.view = None
        self.rows = None

    def forward(self, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full causal forward: logits (B, S, padded_vocab) at every
        position; an encoder model attends to its ``frames`` (B, T, d)."""
        memory = _encode(self, frames) if self.encoder is not None else None
        x = _embed_inputs(self, {"tokens": tokens})
        for layer in self.layers:
            x = layer(x, memory=memory)
        return logits_of(self, x)


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator,
                trainable: bool = False, place=None) -> Model:
    """A ``Model`` on the generator's device with the JAX package's shapes,
    scales and init: N(0, 1) * scale drawn in float32 (``head`` at 0.02,
    as the embedding), norms at one, ``lam`` at 2.0. ``jax.random`` and
    ``torch.Generator`` give different numbers for one seed; a seed gives
    the same draws with or without ``trainable``.

    With ``place`` (a mesh trainer's) the model is built on the meta
    device and each module is made whole on the generator's device only
    while it is drawn: ``place(model)`` gives the function
    ``put(module, recurse)`` that then swaps the module's parameters (its
    own, or all with ``recurse``) for this rank's shards. The draws are the
    same as without, so the shards are slices of the meshless model."""
    model = Model(cfg, device="meta" if place else generator.device, trainable=trainable)
    put = place(model) if place is not None else None

    def draw(module: nn.Module, init, recurse: bool = True) -> None:
        if put is not None:
            module.to_empty(device=generator.device, recurse=recurse)
        init(generator)
        if put is not None:
            put(module, recurse)

    def tables(gen: torch.Generator) -> None:
        L.normal_(model.embed, gen, 0.02)
        if model.head is not None:
            L.normal_(model.head, gen, 0.02)

    draw(model, tables, recurse=False)
    draw(model.final_norm, model.final_norm.init_)
    for layer in model.layers:
        draw(layer, layer.init_)
    if model.encoder is not None:
        draw(model.encoder_norm, model.encoder_norm.init_)
        for layer in model.encoder:
            draw(layer, layer.init_)
    return model


# ---------------------------------------------------------------------------
# Forward paths
# ---------------------------------------------------------------------------


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal absolute positions, float32 (len(positions), d): the JAX
    ``_sinusoidal`` table's rows at ``positions``, in its operation order,
    ``pos / 10000 ** (2 * dim / d)`` then sin and cos concatenated; a
    decode step's row (JAX ``decode_step``) is the same formula at one
    position."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)[None, :]
    ang = positions.float()[:, None] / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _with_positions(cfg: ArchConfig, x: torch.Tensor, start: int = 0) -> torch.Tensor:
    """``x`` (B, S, d) plus the sinusoid rows of positions start..start+S-1
    cast to ``x``'s dtype when ``cfg.rope_theta <= 0``, else ``x``."""
    if cfg.rope_theta > 0:
        return x
    pos = torch.arange(start, start + x.shape[1], device=x.device)
    return x + sinusoidal(pos, cfg.d_model).to(x.dtype)


def _embed_inputs(model: Model, batch: Dict[str, torch.Tensor], start: int = 0,
                  split: Optional[P.Split] = None) -> torch.Tensor:
    """The first layer's input: ``batch["embeds"]`` cast to the compute
    dtype for an ``embeddings`` model given them, else the tokens' rows of
    the table times sqrt(d_model); then, with sinusoidal positions, the
    rows from position ``start`` on (0 for a full sequence, ``pos`` for a
    decode step). With ``split`` splitting the sequence, this rank's
    block of it: its positions' rows, the same rows the whole sequence's
    input holds there. Where the table in hand is this rank's block of the
    vocab (serving on a mesh), each rank looks up the whole rows' tokens
    that fall in its block, zeros elsewhere, and the sum over the model
    axis (reduce-scattered onto the sequence blocks) is the lookup."""
    cfg = model.cfg
    if split is not None and split.seq is not None:
        start += split.seq.start
    dt = L.compute_dtype(cfg)
    scale = math.sqrt(cfg.d_model)
    if cfg.input_kind == "embeddings" and "embeds" in batch:
        x = P.keep_seq(batch["embeds"], split).to(dt)
    elif model.embed.shape[0] == cfg.padded_vocab:
        x = F.embedding(P.keep_seq(batch["tokens"], split), model.embed.to(dt)) * scale
    else:
        vocab = split.view.vocab(cfg.padded_vocab)
        local = batch["tokens"] - vocab.start
        inside = (local >= 0) & (local < vocab.size)
        rows = F.embedding(local.clamp(0, vocab.size - 1), model.embed.to(dt))
        x = P.scatter_sum(torch.where(inside[..., None], rows, 0) * scale, split)
    return _with_positions(cfg, x, start)


def _encode(model: Model, frames: torch.Tensor, split: Optional[P.Split] = None
            ) -> torch.Tensor:
    """The encoder's memory (B, T, d) of precomputed ``frames`` (B, T, d):
    cast to the compute dtype, the sinusoid rows added, the non-causal
    encoder layers, then ``encoder_norm``, as the JAX ``_encode``. With
    ``split`` (at T) splitting the frames, each rank runs its block of them
    and the memory is gathered whole at the end."""
    start = 0
    if split is not None and split.seq is not None:
        frames, start = P.keep_seq(frames, split), split.seq.start
    x = _with_positions(model.cfg, frames.to(L.compute_dtype(model.cfg)), start)
    call = _caller(model)
    for layer in model.encoder:
        x = layer(x, call=call, split=split)
    return P.gather_seq(model.encoder_norm(x), split)


def _unembedding(model: Model) -> torch.Tensor:
    """The (d_model, padded_vocab) output matrix in the compute dtype:
    ``head``, else the tied table transposed."""
    W = model.head if model.head is not None else model.embed.t()
    return W.to(L.compute_dtype(model.cfg))


def logits_of(model: Model, h: torch.Tensor, split: Optional[P.Split] = None
              ) -> torch.Tensor:
    """The final norm of ``h`` times the unembedding: (..., padded_vocab).
    Where the unembedding in hand is this rank's vocab block (serving on a
    mesh), each rank's block of the logits, all-gathered over the model
    axis."""
    W = _unembedding(model)
    logits = model.final_norm(h) @ W
    if W.shape[1] != model.cfg.padded_vocab:
        logits = P.all_gather(logits, -1, split.group)
    return logits


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def _unit_body(layers, call=_direct, split: Optional[P.Split] = None):
    def body(x: torch.Tensor, memory: Optional[torch.Tensor]):
        aux = 0
        for layer in layers:
            x, a = layer(x, memory=memory, return_aux=True, call=call, split=split)
            if a is not None:
                aux = aux + a
        return x, aux

    return body


def _checkpointed(part, *inputs):
    return torch.utils.checkpoint.checkpoint(part, *inputs, use_reentrant=False)


def _whole(model: Model, modules, keep=None) -> contextlib.AbstractContextManager:
    """A context in which the own parameters of ``modules`` are whole (on
    a mesh axis named ``keep``, this rank's block along it): the model's
    ``gather`` hook on a mesh, else nothing to do."""
    return contextlib.nullcontext() if model.gather is None else model.gather(modules, keep=keep)


@contextlib.contextmanager
def _serving_tops(model: Model, split: Optional[P.Split]):
    """The modules of :func:`_top_modules` gathered for serving: the
    norms whole; the embedding table and the unembedding whole where the
    vocab is not split (no mesh, or a plan that keeps it whole), else this
    rank's block of the vocab gathered over the other mesh dims."""
    keep = None
    if split is not None and split.view.vocab(model.cfg.padded_vocab) is not None:
        keep = split.view.plan.shape.model_axis
    with _whole(model, _top_modules(model)[1:]), _whole(model, [model], keep):
        yield


def _top_modules(model: Model) -> list:
    """The modules whose own parameters the loss uses outside the layers:
    the model (``embed``, ``head``), ``final_norm`` and ``encoder_norm``."""
    return [m for m in (model, model.final_norm, model.encoder_norm) if m is not None]


def _caller(model: Model, checkpointed: bool = False):
    """The ``call`` with which a ``Block`` runs its parts: directly (or
    checkpointed); on a mesh each part runs with its modules' parameters
    gathered for it alone, inside the checkpointed region, so the
    recompute gathers them again."""
    if model.gather is None:
        return _checkpointed if checkpointed else _direct

    def call(part, *inputs):
        mods = [m for top in part.__self__.part_modules(part) for m in top.modules()]

        def run(*xs):
            with model.gather(mods):
                return part(*xs)

        return _checkpointed(run, *inputs) if checkpointed else run(*inputs)

    return call


def _saves_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: keep the outputs of the matrix products without
    batch dims (``aten.mm`` / ``aten.addmm``: each ``x @ w``), recompute
    everything else, the batched products (``bmm``: the attention scores,
    the expert products) too, as JAX's
    ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_saves_products)


def _remat_body(model: Model, layers, split: Optional[P.Split] = None):
    """A pattern unit's body under ``cfg.remat``, as the JAX ``_remat_wrap``:
    ``none`` as it is; ``dots`` checkpointed keeping the products of
    :func:`_saves_products`; ``names`` with each part of each layer (norm and
    mixer, norm and cross-attention, norm and FFN or MoE) a checkpointed
    region, so what is kept is their outputs, the tensors JAX tags
    ``attn_out``, ``ffn_out`` and ``moe_out``, and the residual stream
    between them; any other value checkpointed whole (``full``): only the
    unit's inputs are kept. Checkpoints are non-reentrant; ``memory`` is an
    input, so its gradient flows back to the encoder. On a mesh the
    recompute runs the same collectives again, on every rank alike."""
    cfg = model.cfg
    if cfg.remat == "none":
        return _unit_body(layers, _caller(model), split)
    if cfg.remat == "names":
        return _unit_body(layers, _caller(model, checkpointed=True), split)
    kw = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = _dots_contexts
    body = _unit_body(layers, _caller(model), split)
    return lambda x, memory: torch.utils.checkpoint.checkpoint(body, x, memory, **kw)


def backbone(model: Model, x: torch.Tensor, memory: Optional[torch.Tensor] = None,
             split: Optional[P.Split] = None
             ) -> Tuple[torch.Tensor, Union[torch.Tensor, int]]:
    """The prefix layers, the pattern units, then the tail, each layer
    cross-attending to ``memory`` when given; returns (hidden, the MoE aux
    losses summed over layers: a float32 tensor, or 0 without a MoE layer,
    so a dense model does no work for it). Each unit's body runs under
    ``cfg.remat`` (:func:`_remat_body`), and the backward recomputes the
    unit and not the encoder, as the JAX ``_remat_wrap`` wraps each unit
    body and neither the prefix, the tail nor ``_encode``. ``split``: a
    mesh trainer's (``x`` its sequence block), passed to every layer."""
    cfg = model.cfg
    n_pat, n0 = len(cfg.pattern), model.n_prefix
    call = _caller(model)
    x, aux = _unit_body(model.layers[:n0], call, split)(x, memory)
    for u in range(cfg.n_units):
        unit = model.layers[n0 + u * n_pat:n0 + (u + 1) * n_pat]
        x, a = _remat_body(model, unit, split)(x, memory)
        aux = aux + a
    x, a = _unit_body(model.layers[n0 + cfg.n_units * n_pat:], call, split)(x, memory)
    return x, aux + a


def _pad_mask(cfg: ArchConfig, lf: torch.Tensor) -> torch.Tensor:
    """Padded vocab entries of float32 logits set to -1e9."""
    if cfg.padded_vocab == cfg.vocab:
        return lf
    pad = torch.arange(cfg.padded_vocab, device=lf.device) >= cfg.vocab
    return torch.where(pad, torch.full((), -1e9, device=lf.device), lf)


def cross_entropy(cfg: ArchConfig, logits: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of (B, S, padded_vocab) logits, in float32."""
    lf = _pad_mask(cfg, logits.float())
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _chunked_xent(model: Model, h: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The cross-entropy without (B, S, V) logits: the final norm, then
    chunks of ``cfg.logits_chunk`` positions, the sequence zero-padded to a
    whole number of chunks and the padding weighted out; the sum over
    chunks divided by B * S."""
    cfg = model.cfg
    h = model.final_norm(h)
    W = _unembedding(model)
    B, S, _ = h.shape
    C = cfg.logits_chunk
    n_chunk = (S + C - 1) // C
    pad = n_chunk * C - S
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
    valid = (torch.arange(n_chunk * C, device=h.device) < S).reshape(n_chunk, C)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunk):
        hb, tb, vb = h[:, c * C:(c + 1) * C], targets[:, c * C:(c + 1) * C], valid[c]
        logits = _pad_mask(cfg, (hb @ W).float())
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tb[..., None].long())[..., 0]
        total = total + torch.sum((logz - gold) * vb[None, :])
    return total / (B * S)


def loss_fn(model: Model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The training loss of ``repro.models.loss_fn``: an encoder model's
    ``batch["frames"]`` encoded first, embed, backbone, then the
    cross-entropy against ``batch["targets"]`` (chunked when
    ``cfg.logits_chunk > 0``), plus ``MOE_AUX_WEIGHT`` times the MoE
    layers' aux losses (none without MoE layers). On a mesh the embedding,
    head and final norms are gathered for the whole loss, each layer's
    parameters part by part, and with the model's ``view`` every layer runs
    this rank's share: the residual stream, the loss too, in this rank's
    sequence block where the plan splits the sequence, so the loss is the
    mean over the block's positions (the trainer weights each rank's)."""
    view = model.view
    targets = batch["targets"]
    split = P.split_at(view, targets.shape[1])
    with _whole(model, _top_modules(model)):
        memory = None
        if model.encoder is not None:
            frames = batch["frames"]
            memory = _encode(model, frames, P.split_at(view, frames.shape[1]))
        x = _embed_inputs(model, batch, split=split)
        h, aux = backbone(model, x, memory, split)
        targets = P.keep_seq(targets, split)
        if model.cfg.logits_chunk > 0:
            loss = _chunked_xent(model, h, targets)
        else:
            loss = cross_entropy(model.cfg, logits_of(model, h), targets)
    return loss + MOE_AUX_WEIGHT * aux if torch.is_tensor(aux) else loss


# ---------------------------------------------------------------------------
# Parameters in the JAX layout
# ---------------------------------------------------------------------------


def _jax_path(cfg: ArchConfig, name: str) -> str:
    """A parameter name of the port (``layers.4.mixer.w_a``,
    ``layers.0.mixer.bq``, ``layers.1.cross.wq``, ``encoder.0.ffn.w_in``,
    ``layers.1.ffn.shared.w_in``) as its leaf path in the JAX params pytree
    (``units/p1/mixer/w_a``, ``units/p0/mixer/bq``, ``units/p0/cross/wq``,
    ``encoder/0/ffn/w_in``, ``units/p0/ffn/shared/w_in``); the
    ``first_k_dense`` prefix layers are ``prefix/{i}/...`` and the units and
    the tail count from after them."""
    if not name.startswith("layers."):
        return name.replace(".", "/")
    _, i, rest = name.split(".", 2)
    rest = rest.replace(".", "/")
    i = int(i) - cfg.first_k_dense
    if i < 0:
        return f"prefix/{i + cfg.first_k_dense}/{rest}"
    unit, p = divmod(i, len(cfg.pattern))
    if unit < cfg.n_units:
        return f"units/p{p}/{rest}"
    return f"tail/{i - cfg.n_units * len(cfg.pattern)}/{rest}"


def _path_key(path: str):
    # the JAX flatten order: dict keys sorted, list entries by index
    return [(0, int(k), "") if k.isdigit() else (1, 0, k) for k in path.split("/")]


def param_leaves(model: Model) -> Dict[str, List[nn.Parameter]]:
    """The parameters grouped as the JAX params pytree holds them, in its
    flatten order: a leaf path (``units/p0/mixer/w_gate``, ``tail/0/...``,
    ``prefix/0/...``, ``embed``) maps to its parameters, one per unit for a pattern leaf
    (the JAX leaf stacks them on a leading ``n_units`` axis), else one
    (``embed``, ``final_norm/scale``, ``head``)."""
    out: Dict[str, List[nn.Parameter]] = {}
    for name, p in model.named_parameters():
        out.setdefault(_jax_path(model.cfg, name), []).append(p)
    return {k: out[k] for k in sorted(out, key=_path_key)}


def _cut(view, t: torch.Tensor, length: int) -> torch.Tensor:
    """This rank's block of a cache tensor's slots (dim 1) of ``length``
    where the plan splits them (a copy: a view of one batch row's block
    would keep every rank's slots alive), else ``t``."""
    blk = view.cache(length) if view is not None else None
    return t if blk is None else t[:, blk.start:blk.stop].clone(
        memory_format=torch.contiguous_format)


def _kv_lens(model: Model, cache_len: int, prefilled: bool) -> List[Optional[int]]:
    """Each layer's KV slots (None for a recurrent state): ``cache_len``
    after a prefill, :meth:`layers.Attention.cache_length` in an empty
    cache."""
    return [None if not isinstance(layer.mixer, L.Attention)
            else cache_len if prefilled else layer.mixer.cache_length(cache_len)
            for layer in model.layers]


def init_cache(model: Model, batch: int, cache_len: int) -> Cache:
    """An empty decode cache; an encoder model's cross caches hold
    ``cfg.encoder_seq or cache_len`` frames, as the JAX ``init_cache``. On a
    mesh ``batch`` is this rank's rows and each cache holds this rank's
    block of its slots."""
    view = model.view
    cfg = model.cfg
    lens = _kv_lens(model, cache_len, prefilled=False)
    layers = []
    for layer, n in zip(model.layers, lens):
        c = layer.cache_init(batch, cache_len)
        layers.append(c if n is None else {k: _cut(view, t, n) for k, t in c.items()})
    cache = {"layers": layers, "pos": 0}
    T = cfg.encoder_seq or cache_len
    if model.encoder is not None:
        shape = (batch, T, cfg.n_kv_heads, cfg.resolved_head_dim)
        kw = {"dtype": L.compute_dtype(cfg), "device": model.embed.device}
        cache["cross"] = [{k: _cut(view, torch.zeros(shape, **kw), T) for k in ("ck", "cv")}
                          for _ in model.layers]
    if view is not None:
        cache["kv_len"] = lens
        if model.encoder is not None:
            cache["cross_len"] = T
    return cache


def prefill(model: Model, batch: Dict[str, torch.Tensor],
            cache_len: int) -> Tuple[Cache, torch.Tensor]:
    """Run the full prompt (``tokens`` (B, S), or ``embeds`` (B, S, d) for
    an ``embeddings`` model; an encoder model's ``frames`` (B, T, d) are
    encoded first), returning (decode cache, last-position logits
    (B, 1, padded_vocab)); the cache's ``pos`` is S. Every RG-LRU layer's
    scan is one call of ``kernels.ops.rglru_scan``; an xLSTM layer's state
    is its mixer's after the last position; each decoder layer's cross
    cache is its ``cross.memory_kv`` of the memory.

    On a mesh (``model.view``) the batch is this rank's rows and the
    prefill runs as the training loss does: each layer's parameters
    gathered a part at a time, this rank's share of every layer, the
    residual stream in sequence blocks where the plan splits S; the last
    position's hidden state comes from the rank that holds it, and the
    cache holds this rank's blocks (:func:`init_cache`)."""
    view = model.view
    S = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]
    split = P.split_at(view, S)
    call = _caller(model)
    with _serving_tops(model, split):
        memory = None
        if model.encoder is not None:
            frames = batch["frames"]
            memory = _encode(model, frames, P.split_at(view, frames.shape[1]))
        x = _embed_inputs(model, batch, split=split)
        states = []
        for layer in model.layers:
            x, st = layer(x, memory=memory, return_state=True, cache_len=cache_len,
                          call=call, split=split)
            states.append(st)
        last = x[:, -1:]
        if split is not None and split.seq is not None:
            last = P.all_gather(last.contiguous(), 1, split.group)[:, -1:]
        logits = logits_of(model, last, split)
    cache = {"layers": states, "pos": S}
    if view is not None:
        cache["kv_len"] = _kv_lens(model, cache_len, prefilled=True)
    if memory is not None:
        T = memory.shape[1]
        cache["cross"] = []
        for layer in model.layers:
            with _whole(model, [layer.cross]):
                kv = layer.cross.memory_kv(memory)
            cache["cross"].append({k: _cut(view, t, T) for k, t in kv.items()})
        if view is not None:
            cache["cross_len"] = T
    return cache, logits


def decode_step(model: Model, cache: Cache,
                tokens: torch.Tensor) -> Tuple[Cache, torch.Tensor]:
    """One decode step: tokens (B, 1) -> (new cache, logits (B, 1, V)),
    the token embedded at position ``cache["pos"]`` (its sinusoid row, with
    sinusoidal positions). The attention layers' KV caches (prefixes and
    ring buffers) are updated in place (the JAX package returns new
    arrays); the RG-LRU and xLSTM states are new tensors; the cross caches
    are carried as they are. On a mesh ``tokens`` are this rank's rows,
    every layer takes ``parallel.split_at(view, 1)`` and its parameters
    gathered a part at a time (:func:`prefill`), and its cache's blocks."""
    pos = cache["pos"]
    split = P.split_at(model.view, 1)
    call = _caller(model)
    n = len(model.layers)
    cross = cache.get("cross", [None] * n)
    lens = cache.get("kv_len", [None] * n)
    with _serving_tops(model, split):
        x = _embed_inputs(model, {"tokens": tokens}, pos, split)
        new_layers = []
        for layer, c, xc, length in zip(model.layers, cache["layers"], cross, lens):
            x, new = layer.decode(x, c, pos, xc, call, split, length, cache.get("cross_len"))
            new_layers.append(new)
        logits = logits_of(model, x, split)
    new = dict(cache, layers=new_layers, pos=pos + 1)
    return new, logits
