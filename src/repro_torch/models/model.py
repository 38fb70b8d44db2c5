"""Model assembly for serving: prefill and greedy decode.

The port of ``repro.models.model`` for the layer kinds ``rglru`` and
``sliding`` with the ``swiglu`` FFN (recurrentgemma-2b):

    embed -> pattern units -> tail layers -> final RMSNorm -> tied unembedding

The JAX package stacks each pattern position's params over ``n_units`` and
runs the units with ``lax.scan``; here the units are a Python loop over one
``Block`` per layer, in order. The JAX code threads a ``ShardingPlan``
through every call; this is one card with no mesh, where every
``plan.constrain`` is a no-op, so the plan is dropped.

Entry points: :func:`init_params` (a ``Model`` with weights drawn from a
``torch.Generator``), :func:`init_cache`, :func:`prefill` and
:func:`decode_step`. A cache is ``{"layers": [per-layer state], "pos": int}``;
``repro_torch.interop.cache_to_jax`` gives it in the JAX package's layout.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L
from .config import ArchConfig

Cache = Dict[str, Any]

#: layer kinds the port runs; the JAX package's others are not ported yet.
KINDS = ("rglru", "sliding")


# ---------------------------------------------------------------------------
# Structure helpers
# ---------------------------------------------------------------------------


def layer_kinds(cfg: ArchConfig) -> Dict[str, List[str]]:
    """prefix / pattern / tail mixer kinds."""
    prefix = [cfg.pattern[0] if cfg.pattern else "full"] * cfg.first_k_dense
    return {"prefix": prefix, "pattern": list(cfg.pattern), "tail": list(cfg.tail_kinds)}


def _ffn_kind(cfg: ArchConfig) -> str:
    """The FFN of every layer: ``moe`` is refused by ``_check_supported``
    (the JAX package's dense-prefix override of it is not ported)."""
    if cfg.ffn_kind == "moe":
        return "moe"
    return "swiglu" if cfg.d_ff > 0 else "none"


def _check_supported(cfg: ArchConfig) -> None:
    """Refuse what the JAX model has and the port does not run yet."""
    kinds = layer_kinds(cfg)
    missing = []
    if kinds["prefix"]:
        missing.append("dense prefix layers (first_k_dense)")
    other = sorted(set(kinds["pattern"] + kinds["tail"]) - set(KINDS))
    if other:
        missing.append(f"layer kinds {other}")
    if _ffn_kind(cfg) != "swiglu":
        missing.append(f"FFN kind {_ffn_kind(cfg)!r}")
    if cfg.encoder_layers:
        missing.append("the encoder and cross-attention")
    if cfg.input_kind != "tokens":
        missing.append(f"input_kind {cfg.input_kind!r}")
    if cfg.rope_theta <= 0:
        missing.append("sinusoidal positions")
    if not cfg.tie_embeddings:
        missing.append("an untied output head")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch "
            f"(ROADMAP.md, Queue A)")


# ---------------------------------------------------------------------------
# Layers and model
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer: pre-norm mixer (RG-LRU or sliding attention) and pre-norm
    SwiGLU, each added to the residual stream."""

    def __init__(self, cfg: ArchConfig, kind: str, device=None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(kind)
        self.kind = kind
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mixer = L.Attention(cfg, device) if kind == "sliding" else L.RGLRU(cfg, device)
        self.norm2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ffn = L.SwiGLU(cfg, device)

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.norm1, self.mixer, self.norm2, self.ffn):
            m.init_(gen)

    def forward(self, x: torch.Tensor, *, return_state: bool = False,
                cache_len: Optional[int] = None):
        out = self.mixer(self.norm1(x), return_state=return_state, cache_len=cache_len)
        if return_state:
            out, state = out
        x = x + out
        x = x + self.ffn(self.norm2(x))
        return (x, state) if return_state else x

    def cache_init(self, batch: int, cache_len: int) -> L.Cache:
        return self.mixer.cache_init(batch, cache_len)

    def decode(self, x: torch.Tensor, cache: L.Cache,
               pos: int) -> Tuple[torch.Tensor, L.Cache]:
        out, new = self.mixer.decode(self.norm1(x), cache, pos)
        x = x + out
        x = x + self.ffn(self.norm2(x))
        return x, new


class Model(nn.Module):
    """The serving model: tied embedding, ``n_units`` pattern units then the
    tail, as ``Block``s in order (``kinds[i]`` is layer i's kind). Weights
    are uninitialised; :func:`init_params` or
    ``repro_torch.interop.model_from_jax`` fills them."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        kinds = layer_kinds(cfg)
        self.kinds = kinds["pattern"] * cfg.n_units + kinds["tail"]
        self.embed = L.new_param((cfg.padded_vocab, cfg.d_model),
                                 L.compute_dtype(cfg), device)
        self.layers = nn.ModuleList(Block(cfg, k, device) for k in self.kinds)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full causal forward: logits (B, S, padded_vocab) at every position."""
        x = _embed_inputs(self, {"tokens": tokens})
        for layer in self.layers:
            x = layer(x)
        return logits_of(self, x)


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator) -> Model:
    """A ``Model`` on the generator's device with the JAX package's shapes,
    scales and init: N(0, 1) * scale drawn in float32, norms at one, ``lam``
    at 2.0. ``jax.random`` and ``torch.Generator`` give different numbers
    for one seed."""
    model = Model(cfg, device=generator.device)
    L.normal_(model.embed, generator, 0.02)
    model.final_norm.init_(generator)
    for layer in model.layers:
        layer.init_(generator)
    return model


# ---------------------------------------------------------------------------
# Forward paths
# ---------------------------------------------------------------------------


def _embed_inputs(model: Model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return F.embedding(batch["tokens"], model.embed) * math.sqrt(model.cfg.d_model)


def logits_of(model: Model, h: torch.Tensor) -> torch.Tensor:
    h = model.final_norm(h)
    return h @ model.embed.t()


def init_cache(model: Model, batch: int, cache_len: int) -> Cache:
    return {"layers": [layer.cache_init(batch, cache_len) for layer in model.layers],
            "pos": 0}


def prefill(model: Model, batch: Dict[str, torch.Tensor],
            cache_len: int) -> Tuple[Cache, torch.Tensor]:
    """Run the full prompt, returning (decode cache, last-position logits
    (B, 1, padded_vocab)). Every RG-LRU layer's scan is one call of
    ``kernels.ops.rglru_scan``."""
    x = _embed_inputs(model, batch)
    states = []
    for layer in model.layers:
        x, st = layer(x, return_state=True, cache_len=cache_len)
        states.append(st)
    logits = logits_of(model, x[:, -1:])
    return {"layers": states, "pos": batch["tokens"].shape[1]}, logits


def decode_step(model: Model, cache: Cache,
                tokens: torch.Tensor) -> Tuple[Cache, torch.Tensor]:
    """One decode step: tokens (B, 1) -> (new cache, logits (B, 1, V)). The
    attention layers' KV ring buffers are updated in place (the JAX
    package returns new arrays); the RG-LRU states are new tensors."""
    pos = cache["pos"]
    x = _embed_inputs(model, {"tokens": tokens})
    new_layers = []
    for layer, c in zip(model.layers, cache["layers"]):
        x, new = layer.decode(x, c, pos)
        new_layers.append(new)
    return {"layers": new_layers, "pos": pos + 1}, logits_of(model, x)
