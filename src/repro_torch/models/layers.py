"""Layers of the ported models, as ``nn.Module``s.

The port of ``repro.models.layers`` for what recurrentgemma-2b, qwen2-1.5b
and gemma3-4b use: RMSNorm, RoPE, grouped-query attention over the whole
prefix (``full``) or a sliding window (``sliding``), with the optional QKV
bias and a ``head_dim`` of its own (full-sequence apply with decode-cache
building, cache init and one-token decode: a prefix cache for full
attention, a ring buffer for a window), SwiGLU and the RG-LRU recurrent
block. Not ported: the blocked attention path (``attention_impl="blocked"``
raises), the head-parallel branch (it needs a mesh), non-causal and
cross-attention, MoE, mLSTM and sLSTM.

The two mixers, ``Attention`` and ``RGLRU``, share one interface:
``forward(x, return_state=, cache_len=)`` for a full sequence,
``cache_init(batch, max_len)`` and ``decode(x, cache, pos)`` for one token.

Conventions, as in the JAX package:
  - weights keep the JAX layout, ``x @ w`` with ``w`` of shape
    (d_in, d_out), and the JAX names, so carrying JAX params across is a
    copy (``repro_torch.interop.model_from_jax``);
  - activations are (B, S, D) in ``cfg.dtype``; softmax, norm and
    recurrence-gate math in float32; attention heads grouped for GQA
    without repeating KV.

The JAX code keeps float32 params and casts each weight to ``cfg.dtype``
at every use (``.astype(dt)`` at every product). A layer built with
``trainable=True`` does the same: float32 parameters that require grad,
each matrix weight and bias cast to ``cfg.dtype`` where it is used. A
serving layer (the default) stores the matrix-product weights and the QKV
biases in ``cfg.dtype`` once, when the model is built or loaded, with no
grad: the values are the same, the cast at use is then a no-op, and a
decode step does not re-read float32 weights to cast them. In both the
RG-LRU gate weights ``w_a``, ``w_i`` and ``lam`` are float32 (``u @ w_a``
is a float32 product) and the norm scales are applied in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops as kops
from .config import ArchConfig

Cache = Dict[str, torch.Tensor]

NEG_INF = -1e9
_RGLRU_C = 8.0


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def new_param(shape, dtype, device, trainable: bool = False) -> nn.Parameter:
    """An uninitialised parameter: float32 that requires grad when
    ``trainable`` (a master weight), else ``dtype`` without grad."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32 if trainable else dtype,
                                    device=device), requires_grad=trainable)


def normal_(w: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """Fill ``w`` with N(0, 1) * scale drawn in float32 on ``gen``'s device,
    then cast, as the JAX package's ``_init`` draws."""
    z = torch.randn(tuple(w.shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    w.copy_(z.mul_(scale))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None, trainable: bool = False):
        super().__init__()
        self.eps = eps
        self.scale = new_param((d,), torch.float32, device, trainable)

    def init_(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1f * cos - x2f * sin, x1f * sin + x2f * cos],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (full / sliding window), GQA, optional QKV bias
# ---------------------------------------------------------------------------


def _group_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """GQA scores without repeating KV. q: (B,S,Hq,D), k: (B,T,Hkv,D) ->
    (B, Hkv, G, S, T) with G = Hq // Hkv."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    return torch.einsum("bskgd,btkd->bkgst", qg, k)


def _group_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,Hkv,G,S,T), v: (B,T,Hkv,D) -> (B,S,Hq,D)."""
    B, Hkv, G, S, T = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, Hkv * G, out.shape[-1])


def _attn_mask(sq: int, skv: int, window: Optional[int], device=None) -> torch.Tensor:
    """Causal mask: query i sees keys j <= i, and with a ``window`` only
    i - window < j."""
    diff = (torch.arange(sq, device=device)[:, None]
            - torch.arange(skv, device=device)[None, :])
    mask = diff >= 0
    if window is not None:
        mask &= diff < window
    return mask


def _masked_probs(scores: torch.Tensor, valid: torch.Tensor, hd: int,
                  dt: torch.dtype) -> torch.Tensor:
    """softmax(where(valid, scores / sqrt(hd), NEG_INF)) in float32, cast to
    ``dt``. ``scores`` is a fresh float32 tensor and is overwritten."""
    scores.div_(math.sqrt(hd))
    scores.masked_fill_(~valid, NEG_INF)
    return torch.softmax(scores, dim=-1).to(dt)


class Attention(nn.Module):
    """Causal GQA attention with RoPE over every earlier position
    (``window=None``: a ``full`` layer) or over the last ``window``
    positions (a ``sliding`` layer), with ``bq``, ``bk``, ``bv`` added to
    the projections when ``cfg.qkv_bias`` (zeros at init, as in JAX)."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False,
                 window: Optional[int] = None):
        super().__init__()
        if cfg.attention_impl == "blocked":
            raise NotImplementedError(
                "attention_impl='blocked' is not ported to repro_torch; the "
                "grouped path runs for 'xla' and 'pallas' (ROADMAP.md, Queue A)")
        self.cfg = cfg
        self.window = window
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        self.dt = dt = compute_dtype(cfg)
        self.wq = new_param((d, nq * hd), dt, device, trainable)
        self.wk = new_param((d, nkv * hd), dt, device, trainable)
        self.wv = new_param((d, nkv * hd), dt, device, trainable)
        self.wo = new_param((nq * hd, d), dt, device, trainable)
        if cfg.qkv_bias:
            self.bq = new_param((nq * hd,), dt, device, trainable)
            self.bk = new_param((nkv * hd,), dt, device, trainable)
            self.bv = new_param((nkv * hd,), dt, device, trainable)
        else:
            self.bq = self.bk = self.bv = None

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            normal_(w, gen, 0.02)
        normal_(self.wo, gen, 0.02 / math.sqrt(2 * self.cfg.n_layers))
        if self.bq is not None:  # zeros, drawing nothing from gen
            for b in (self.bq, self.bk, self.bv):
                b.zero_()

    def _qkv(self, x: torch.Tensor):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        B, S = x.shape[0], x.shape[1]
        q, k, v = (x @ w.to(self.dt) for w in (self.wq, self.wk, self.wv))
        if self.bq is not None:  # added in the compute dtype, as JAX adds them
            q = q + self.bq.to(self.dt)
            k = k + self.bk.to(self.dt)
            v = v + self.bv.to(self.dt)
        return (q.reshape(B, S, cfg.n_heads, hd), k.reshape(B, S, cfg.n_kv_heads, hd),
                v.reshape(B, S, cfg.n_kv_heads, hd))

    def forward(self, x: torch.Tensor, *, return_state: bool = False,
                cache_len: Optional[int] = None):
        """Full-sequence attention (prefill). With ``return_state`` also
        returns the decode cache of length ``cache_len`` (default S)."""
        cfg = self.cfg
        dt = x.dtype
        hd = cfg.resolved_head_dim
        B, S, _ = x.shape
        q, k, v = self._qkv(x)
        T = k.shape[1]
        cos, sin = rope_table(torch.arange(S, device=x.device), hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        mask = _attn_mask(S, T, self.window, device=x.device)
        probs = _masked_probs(_group_scores(q, k).float(), mask, hd, dt)
        out = _group_out(probs, v).reshape(B, S, cfg.n_heads * hd)
        del probs
        y = out @ self.wo.to(self.dt)
        if not return_state:
            return y
        # a decode-ready KV cache from the prefill K/V, as the JAX package
        # builds it: its length is cache_len even for a sliding layer
        L = cache_len if cache_len is not None else T
        if L > T:
            k_c, v_c = (F.pad(t, (0, 0, 0, 0, 0, L - T)) for t in (k, v))
        elif self.window is not None:
            # ring buffer: valid because prefill length is a multiple of L
            k_c, v_c = k[:, -L:], v[:, -L:]
        else:
            k_c, v_c = k[:, :L], v[:, :L]
        return y, {"k": k_c.contiguous(), "v": v_c.contiguous()}

    def cache_init(self, batch: int, max_len: int) -> Cache:
        """KV cache: ``max_len`` slots for full attention, a ring buffer of
        ``min(window, max_len)`` for a sliding layer."""
        cfg = self.cfg
        length = max_len if self.window is None else min(self.window, max_len)
        shape = (batch, length, cfg.n_kv_heads, cfg.resolved_head_dim)
        kw = {"dtype": self.dt, "device": self.wq.device}
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}

    def decode(self, x: torch.Tensor, cache: Cache,
               pos: int) -> Tuple[torch.Tensor, Cache]:
        """One token ``x`` (B, 1, d) at absolute position ``pos``. Writes its
        K/V into the cache in place and returns (out, cache)."""
        cfg = self.cfg
        dt = x.dtype
        B = x.shape[0]
        hd = cfg.resolved_head_dim
        q, k, v = self._qkv(x)
        cos, sin = rope_table(torch.full((1,), pos, device=x.device), hd,
                              cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_cache, v_cache = cache["k"], cache["v"]
        L = k_cache.shape[1]
        idx = torch.arange(L, device=x.device)
        if self.window is None:
            # a prefix: past its end the last slot is overwritten, as in JAX
            slot = min(pos, L - 1)
            valid = idx <= pos
        else:
            slot = pos % L  # floored, as jnp.mod
            # valid slots of the ring buffer: slot i holds absolute position
            # p where p % L == i and p <= pos (floored remainder: pos - i < 0)
            abs_pos = pos - torch.remainder(pos - idx, L)
            valid = (abs_pos >= 0) & (abs_pos >= pos - self.window + 1) & (abs_pos <= pos)
        k_cache[:, slot] = k[:, 0]
        v_cache[:, slot] = v[:, 0]
        probs = _masked_probs(_group_scores(q, k_cache).float(), valid, hd, dt)
        out = _group_out(probs, v_cache).reshape(B, 1, cfg.n_heads * hd)
        return out @ self.wo.to(self.dt), cache


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------


class SwiGLU(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        self.dt = dt = compute_dtype(cfg)
        self.w_in = new_param((d, 2 * f), dt, device, trainable)
        self.w_out = new_param((f, d), dt, device, trainable)

    def init_(self, gen: torch.Generator) -> None:
        normal_(self.w_in, gen, 0.02)
        normal_(self.w_out, gen, 0.02 / math.sqrt(2 * self.cfg.n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.w_in.to(self.dt)
        gate, up = h.chunk(2, dim=-1)
        act = F.silu(gate.float()).to(x.dtype) * up
        del h, gate, up
        return act @ self.w_out.to(self.dt)


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin recurrent block)
# ---------------------------------------------------------------------------


class RGLRU(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        dr = d  # lru width = d_model (RecurrentGemma-2B)
        self.dt = dt = compute_dtype(cfg)
        self.w_gate = new_param((d, dr), dt, device, trainable)
        self.w_rec_in = new_param((d, dr), dt, device, trainable)
        self.w_a = new_param((dr, dr), torch.float32, device, trainable)
        self.w_i = new_param((dr, dr), torch.float32, device, trainable)
        self.lam = new_param((dr,), torch.float32, device, trainable)
        self.w_down = new_param((dr, d), dt, device, trainable)

    def init_(self, gen: torch.Generator) -> None:
        normal_(self.w_gate, gen, 0.02)
        normal_(self.w_rec_in, gen, 0.02)
        normal_(self.w_a, gen, 0.01)
        normal_(self.w_i, gen, 0.01)
        # a = sigmoid(lam): the JAX init is the constant 2.0
        self.lam.fill_(2.0)
        normal_(self.w_down, gen, 0.02 / math.sqrt(2 * self.cfg.n_layers))

    def _coeffs(self, u: torch.Tensor):
        """u: (B,S,dr) float32 -> per-step decay a_t and input b_t."""
        r = torch.sigmoid(u @ self.w_a)  # recurrence gate
        i = torch.sigmoid(u @ self.w_i)  # input gate
        log_a0 = F.logsigmoid(self.lam)  # log a in (-inf, 0)
        log_a = _RGLRU_C * r * log_a0  # a_t = a^(c * r_t)
        del r
        a = torch.exp(log_a)
        b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * u)
        return a, b

    def _gate_and_input(self, x: torch.Tensor):
        gate = F.gelu((x @ self.w_gate.to(self.dt)).float(), approximate="tanh")
        u = (x @ self.w_rec_in.to(self.dt)).float()
        return gate, u

    def forward(self, x: torch.Tensor, *, return_state: bool = False,
                cache_len: Optional[int] = None):
        """Full sequence: the scan is ``kernels.ops.rglru_scan`` from a zero
        state, the CUDA kernel on the card (its plain version on the CPU),
        differentiable through its backward kernel. The state is one vector
        per row, whatever ``cache_len``."""
        B = x.shape[0]
        gate, u = self._gate_and_input(x)
        a, b = self._coeffs(u)
        del u
        h = kops.rglru_scan(a, b, torch.zeros((B, a.shape[-1]), dtype=torch.float32,
                                              device=x.device))
        del a, b
        y = (h * gate).to(x.dtype) @ self.w_down.to(self.dt)
        if return_state:
            return y, {"h": h[:, -1].contiguous()}
        return y

    def cache_init(self, batch: int, max_len: int) -> Cache:
        return {"h": torch.zeros((batch, self.cfg.d_model), dtype=torch.float32,
                                 device=self.w_a.device)}

    def decode(self, x: torch.Tensor, state: Cache,
               pos: int) -> Tuple[torch.Tensor, Cache]:
        """One token: one elementwise step of the recurrence, no kernel."""
        gate, u = self._gate_and_input(x[:, 0])
        a, b = self._coeffs(u[:, None, :])
        h = a[:, 0] * state["h"] + b[:, 0]
        y = (h * gate).to(x.dtype)[:, None]
        return y @ self.w_down.to(self.dt), {"h": h}
