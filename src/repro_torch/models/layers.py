"""Layers of the ported models, as ``nn.Module``s.

The port of ``repro.models.layers`` for what recurrentgemma-2b, qwen2-1.5b,
gemma3-4b, xlstm-350m, yi-9b, phi4-mini-3.8b, phi-3-vision-4.2b and
whisper-tiny use, and the MoE layer of arctic-480b and kimi-k2-1t-a32b:
RMSNorm, RoPE, grouped-query attention over the whole prefix (``full``) or
a sliding window (``sliding``), with the optional QKV bias and a
``head_dim`` of its own (full-sequence apply with decode-cache building,
cache init and one-token decode: a prefix cache for full attention, a ring
buffer for a window), SwiGLU, the RG-LRU recurrent block and the two xLSTM
mixers, the mLSTM (chunkwise over 256 positions) and the sLSTM (a loop over
time). A full sequence's attention is the grouped einsum over fp32 scores
(``attention_impl`` ``"xla"`` or ``"pallas"``) or, with ``"blocked"``,
:func:`blocked_attention`: the flash kernel on the card when serving, its
blockwise twin otherwise; non-causal self-attention (whisper's encoder)
and cross-attention to an encoder's memory, with cached memory K/V in
decode; :class:`MoE`, the sort-dispatched top-k experts with shared
experts and a dense residual, and :func:`moe_plain`, its plain twin.

The mixers, ``Attention``, ``RGLRU``, ``MLSTM`` and ``SLSTM``, share one
interface: ``forward(x, return_state=, cache_len=, split=)`` for a full
sequence, ``cache_init(batch, max_len)`` and ``decode(x, cache, pos)`` for
one token (``Attention.decode`` also takes ``split=`` and ``length=``).

A model on a mesh passes ``split`` (``distributed.parallel.Split``, the
rank's view of the plan at the call's sequence length) to every layer of
the training loss and of a prefill, where JAX's ``plan.constrain`` calls
shard the compute over the ``model`` axis; ``x`` is then this rank's block
of the sequence when ``split.seq`` is set (else the whole rows), and so is
the output:

  - ``Attention``: Q, K, V of the block, RoPE and the causal or window
    mask at the block's global positions, K/V gathered over the sequence;
    under head TP (``split.heads``) the whole rows' Q of this rank's heads
    against K/V repeated to them (JAX's ``jnp.repeat``), the partial
    ``wo`` product reduce-scattered onto the blocks; cross-attention
    against the whole memory;
  - ``SwiGLU``: the block's rows, or under head TP this rank's ``d_ff``
    columns of the whole rows, reduce-scattered;
  - ``MoE``: the whole rows routed (the capacity, the sort and the aux
    statistics see every token of a row), this rank's experts
    (``split.experts``) run, their gate-weighted partial output
    reduce-scattered; ``shared`` and ``dense`` on the block's rows;
  - ``RGLRU``, ``MLSTM``, ``SLSTM``: the whole sequence gathered and run,
    this rank's block kept (JAX's scans are unconstrained).

A prefill's attention cache is built from the whole K/V as the meshless
code builds it, then cut to this rank's block of its slots
(``split.cache(L)``, where the plan splits a cache of ``L`` slots). A
decode step (``split`` at S = 1: nothing of the sequence is split) runs
every head on this rank's block of the cache, its softmax combined over the
model axis (``parallel.softmax_combine``; the token's K/V written by the
rank that owns its slot), and cross-attention the same over its block of
the memory's frames; SwiGLU and MoE take their split forwards at S = 1
(``d_ff`` columns under head TP, experts, each ending in an all-reduce);
the recurrent mixers' decode steps are whole on every rank, their states
held by batch rows.

Conventions, as in the JAX package:
  - weights keep the JAX layout, ``x @ w`` with ``w`` of shape
    (d_in, d_out), and the JAX names, so carrying JAX params across is a
    copy (``repro_torch.interop.model_from_jax``);
  - activations are (B, S, D) in ``cfg.dtype``; softmax, norm and
    recurrence-gate math in float32; attention heads grouped for GQA
    without repeating KV.

The JAX code keeps its params in ``cfg.param_dtype`` (``_pdtype``: float32
by default, bfloat16 for arctic-480b and kimi-k2-1t-a32b) and casts each
weight to ``cfg.dtype`` at every use (``.astype(dt)`` at every product). A
layer built with ``trainable=True`` does the same: masters that require
grad in ``cfg.param_dtype`` (:func:`param_dtype`), each matrix weight and
bias cast to ``cfg.dtype`` where it is used (a no-op when the two dtypes
are one). A serving layer (the default) stores the matrix-product weights
and the QKV biases in ``cfg.dtype`` once, when the model is built or
loaded, with no grad: the values are the same, the cast at use is then a
no-op, and a decode step does not re-read float32 weights to cast them.
Where JAX names float32 for a leaf, it is float32 in both: the RG-LRU gate
weights ``w_a``, ``w_i`` and ``lam``, the mLSTM gate weights ``w_if``,
``b_if``, the sLSTM recurrence ``r`` and bias ``b`` (their products are
float32 products) and the MoE ``router`` (cast to ``cfg.dtype`` at use).
The norm scales (``_pdtype`` masters in training) are applied in float32,
and a serving layer stores them in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import parallel as P
from ..kernels import ops as kops
from ..kernels.slstm import slstm_cell, slstm_scan
from .config import ArchConfig

Cache = Dict[str, torch.Tensor]

NEG_INF = -1e9
_RGLRU_C = 8.0


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    """The masters' dtype, ``cfg.param_dtype`` (the JAX ``_pdtype``)."""
    return getattr(torch, cfg.param_dtype)


def new_param(shape, dtype, device, trainable: bool, master: torch.dtype) -> nn.Parameter:
    """An uninitialised parameter: a ``master`` one that requires grad when
    ``trainable`` (the dtype JAX stores the leaf in: :func:`param_dtype`,
    or float32 where JAX names it), else ``dtype`` without grad."""
    return nn.Parameter(torch.empty(shape, dtype=master if trainable else dtype,
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
    """The scale is float32 when serving, and a ``master`` (the config's
    :func:`param_dtype`, as the JAX ``rmsnorm_init``) when training."""

    def __init__(self, d: int, eps: float, device=None, trainable: bool = False,
                 master: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = new_param((d,), torch.float32, device, trainable, master)

    def init_(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS-normalise ``x`` over its last axis in float32, scale by
    ``scale`` in float32 and cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


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


def _attn_mask(sq: int, skv: int, window: Optional[int], device=None,
               offset: int = 0) -> torch.Tensor:
    """Causal mask: query i (at position ``offset + i``) sees keys
    j <= offset + i, and with a ``window`` only offset + i - window < j."""
    diff = (torch.arange(offset, offset + sq, device=device)[:, None]
            - torch.arange(skv, device=device)[None, :])
    mask = diff >= 0
    if window is not None:
        mask &= diff < window
    return mask


def _masked_probs(scores: torch.Tensor, valid: Optional[torch.Tensor], hd: int,
                  dt: torch.dtype) -> torch.Tensor:
    """softmax(where(valid, scores / sqrt(hd), NEG_INF)) in float32, cast to
    ``dt``; with ``valid=None`` (non-causal, no window: the encoder and
    cross-attention) nothing is masked. ``scores`` is a fresh float32
    tensor and is overwritten."""
    scores.div_(math.sqrt(hd))
    if valid is not None:
        scores.masked_fill_(~valid, NEG_INF)
    return torch.softmax(scores, dim=-1).to(dt)


def _blocked_tiles(S: int, T: int, block_q: int, block_kv: int) -> Tuple[int, int]:
    """The blocked path's tiles, ``min(block, length)``; raises the JAX
    ``_blocked_attention``'s ``ValueError`` when they do not divide S, T."""
    bq, bkv = min(block_q, S), min(block_kv, T)
    if S % bq or T % bkv:
        raise ValueError(
            f"blocked attention needs divisible tiles: S={S} vs block_q={bq}, "
            f"T={T} vs block_kv={bkv}; adjust attention_block_q/_kv in the config"
        )
    return bq, bkv


def blocked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            window: Optional[int], bq: int, bkv: int,
                            q_offset: int = 0) -> torch.Tensor:
    """The JAX ``_blocked_attention``, step for step: causal GQA attention
    of q (B, S, Hq, D) on k, v (B, T, Hkv, D) (query head h on KV head
    h // (Hq // Hkv)) as a Python loop over query tiles of ``bq`` and KV
    tiles of ``bkv`` (tiles that divide S and T, as :func:`_blocked_tiles`
    gives them), never building the (S, T) scores. Query i is at position
    ``q_offset + i`` (a sequence block's start), key j at j. Tile pairs
    above the causal diagonal or wholly outside the ``window`` are skipped;
    each pair's scores are float32, scaled by 1/sqrt(D), masked to
    ``NEG_INF`` and folded into the online max ``m``, sum ``l`` and float32
    ``acc`` (``p @ v`` on float32 V). Returns (B, S, Hq, D) in q's dtype."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    f32 = {"dtype": torch.float32, "device": q.device}
    out_blocks = []
    for qi in range(S // bq):
        qblk = q[:, qi * bq:(qi + 1) * bq].reshape(B, bq, Hkv, G, D)
        m = torch.full((B, Hkv, G, bq), NEG_INF, **f32)
        l = torch.zeros((B, Hkv, G, bq), **f32)
        acc = torch.zeros((B, Hkv, G, bq, D), **f32)
        q_lo, q_hi = q_offset + qi * bq, q_offset + (qi + 1) * bq - 1
        for ki in range(T // bkv):
            k_lo, k_hi = ki * bkv, (ki + 1) * bkv - 1
            if k_lo > q_hi:
                continue  # strictly above the causal diagonal
            if window is not None and k_hi < q_lo - window + 1:
                continue  # entirely outside the sliding window
            kblk, vblk = k[:, k_lo:k_hi + 1], v[:, k_lo:k_hi + 1]
            s = torch.einsum("bqkgd,btkd->bkgqt", qblk, kblk).float() * scale
            diff = (torch.arange(q_lo, q_hi + 1, device=q.device)[:, None]
                    - torch.arange(k_lo, k_hi + 1, device=q.device)[None, :])
            mask = diff >= 0
            if window is not None:
                mask &= diff < window
            s = torch.where(mask, s, torch.full((), NEG_INF, **f32))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, vblk.float())
            m = m_new
        out = (acc / torch.clamp_min(l, 1e-20)[..., None]).to(q.dtype)
        out_blocks.append(out.permute(0, 3, 1, 2, 4).reshape(B, bq, Hq, D))
    return torch.cat(out_blocks, dim=1)


def _on_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The blocked path's rule: the flash kernel for CUDA tensors none of
    which requires grad (serving), the twin for all else. It reads the
    device and ``requires_grad`` only, so a checkpointed forward and its
    recompute take the same branch."""
    return q.device.type == "cuda" and not (q.requires_grad or k.requires_grad
                                             or v.requires_grad)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: Optional[int], block_q: int, block_kv: int,
                      q_offset: int = 0) -> torch.Tensor:
    """``attention_impl="blocked"``: q (B, S, Hq, D), k, v (B, T, Hkv, D)
    -> (B, S, Hq, D) in q's dtype, query i at position ``q_offset + i`` (a
    sequence block's start). When :func:`_on_kernel`, one launch of
    ``kernels.ops.flash_attention_gqa`` on heads-first copies at that
    offset (a failed build or launch raises ``KernelError``); else
    :func:`blocked_attention_plain`, which autograd differentiates (the JAX
    model differentiates its jnp loop, and the kernel has no backward).
    Either way tiles that do not divide S, T raise the JAX ``ValueError``."""
    S, T = q.shape[1], k.shape[1]
    bq, bkv = _blocked_tiles(S, T, block_q, block_kv)
    if not _on_kernel(q, k, v):
        return blocked_attention_plain(q, k, v, window=window, bq=bq, bkv=bkv,
                                       q_offset=q_offset)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = kops.flash_attention_gqa(qh, kh, vh, causal=True, window=window,
                                   block_q=bq, block_k=bkv, q_offset=q_offset)
    return out.transpose(1, 2)


def local_slot(slot: int, block) -> Optional[int]:
    """The index in a rank's ``block`` (``sharding.Block``) of a cache's
    global ``slot``, or None where another rank's block holds it."""
    return slot - block.start if block.start <= slot < block.stop else None


class Attention(nn.Module):
    """GQA attention with ``bq``, ``bk``, ``bv`` added to the projections
    when ``cfg.qkv_bias`` (zeros at init, as in JAX), in the three forms
    the JAX ``attention_apply`` / ``attention_decode`` take:

    - causal self-attention with RoPE (unless ``cfg.rope_theta <= 0``,
      whisper's sinusoidal positions) over every earlier position
      (``window=None``: a ``full`` layer) or the last ``window`` positions
      (a ``sliding`` layer), with a decode cache;
    - ``causal=False``: self-attention over every position, no mask (the
      encoder);
    - ``forward(x, memory=)``: cross-attention, q from ``x`` and k, v from
      the (B, T, d) ``memory`` (T may differ from S), with no RoPE and no
      mask; in decode :meth:`cross_decode` against the cached K/V of the
      memory (:meth:`memory_kv`).

    A full sequence runs :func:`blocked_attention` when
    ``cfg.attention_impl == "blocked"`` and the attention is causal
    self-attention, as the JAX ``attention_apply`` routes (the encoder
    and cross-attention stay on the grouped einsum); decode is the same
    for both paths (the JAX package has no blocked decode)."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False,
                 window: Optional[int] = None, causal: bool = True):
        super().__init__()
        self.cfg = cfg
        self.window = window
        self.causal = causal
        self.use_rope = cfg.rope_theta > 0
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        self.dt = dt = compute_dtype(cfg)
        pdt = param_dtype(cfg)
        self.wq = new_param((d, nq * hd), dt, device, trainable, pdt)
        self.wk = new_param((d, nkv * hd), dt, device, trainable, pdt)
        self.wv = new_param((d, nkv * hd), dt, device, trainable, pdt)
        self.wo = new_param((nq * hd, d), dt, device, trainable, pdt)
        if cfg.qkv_bias:
            self.bq = new_param((nq * hd,), dt, device, trainable, pdt)
            self.bk = new_param((nkv * hd,), dt, device, trainable, pdt)
            self.bv = new_param((nkv * hd,), dt, device, trainable, pdt)
        else:
            self.bq = self.bk = self.bv = None

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            normal_(w, gen, 0.02)
        normal_(self.wo, gen, 0.02 / math.sqrt(2 * self.cfg.n_layers))
        if self.bq is not None:  # zeros, drawing nothing from gen
            for b in (self.bq, self.bk, self.bv):
                b.zero_()

    def _qkv(self, x: torch.Tensor, xkv: Optional[torch.Tensor] = None):
        """q from ``x``; k, v from ``xkv`` (default ``x``), each reshaped by
        its own source's length, as the JAX ``_qkv``."""
        cfg = self.cfg
        q = x @ self.wq.to(self.dt)
        if self.bq is not None:  # added in the compute dtype, as JAX adds them
            q = q + self.bq.to(self.dt)
        return (q.reshape(x.shape[0], x.shape[1], cfg.n_heads, cfg.resolved_head_dim),
                *self._kv(x if xkv is None else xkv))

    def _kv(self, xkv: torch.Tensor):
        """k, v (B, T, n_kv_heads, head_dim) of ``xkv`` (B, T, d)."""
        cfg = self.cfg
        shape = xkv.shape[:2] + (cfg.n_kv_heads, cfg.resolved_head_dim)
        k, v = (xkv @ w.to(self.dt) for w in (self.wk, self.wv))
        if self.bk is not None:
            k = k + self.bk.to(self.dt)
            v = v + self.bv.to(self.dt)
        return k.reshape(shape), v.reshape(shape)

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                offset: int = 0) -> torch.Tensor:
        """q (B, S, Hq, D) against k, v (B, T, Hkv, D) -> (B, S, Hq, D): the
        blocked path for causal self-attention when the config names it,
        else the grouped einsum over float32 scores, masked when ``causal``
        (query i at position ``offset + i``)."""
        cfg = self.cfg
        S, T = q.shape[1], k.shape[1]
        if cfg.attention_impl == "blocked" and causal:
            return blocked_attention(q, k, v, window=self.window,
                                     block_q=cfg.attention_block_q,
                                     block_kv=cfg.attention_block_kv, q_offset=offset)
        # non-causal attention (the encoder, cross-attention) has no window
        mask = _attn_mask(S, T, self.window, q.device, offset) if causal else None
        probs = _masked_probs(_group_scores(q, k).float(), mask, cfg.resolved_head_dim, q.dtype)
        return _group_out(probs, v)

    def forward(self, x: torch.Tensor, *, memory: Optional[torch.Tensor] = None,
                return_state: bool = False, cache_len: Optional[int] = None,
                split: Optional[P.Split] = None):
        """Full-sequence attention (prefill, training), or cross-attention
        to ``memory``. With ``return_state`` (self-attention) also returns
        the decode cache of length ``cache_len`` (default S). With ``split``
        (on a mesh) this rank's share (:meth:`_split_forward`)."""
        if split is not None:
            return self._split_forward(x, memory, split, return_state, cache_len)
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        B, S, _ = x.shape
        q, k, v = self._qkv(x, memory)
        T = k.shape[1]
        if self.use_rope and memory is None:
            cos, sin = rope_table(torch.arange(S, device=x.device), hd, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        out = self._attend(q, k, v, self.causal and memory is None)
        y = out.reshape(B, S, cfg.n_heads * hd) @ self.wo.to(self.dt)
        if not return_state:
            return y
        return y, self._cache_of(k, v, cache_len)

    def _cache_of(self, k: torch.Tensor, v: torch.Tensor, cache_len: Optional[int],
                  sp: Optional[P.Split] = None) -> Cache:
        """A decode-ready KV cache from the prefill's whole K/V (B, T, Hkv,
        D), as the JAX package builds it: its length is ``cache_len``
        (default T) even for a sliding layer. With ``sp``, this rank's block
        of its slots where the plan splits them (``sp.cache(L)``)."""
        T = k.shape[1]
        L = cache_len if cache_len is not None else T
        if L > T:
            k_c, v_c = (F.pad(t, (0, 0, 0, 0, 0, L - T)) for t in (k, v))
        elif self.window is not None:
            # ring buffer: valid because prefill length is a multiple of L
            k_c, v_c = k[:, -L:], v[:, -L:]
        else:
            k_c, v_c = k[:, :L], v[:, :L]
        blk = sp.cache(L) if sp is not None else None
        if blk is not None:
            k_c, v_c = k_c[:, blk.start:blk.stop], v_c[:, blk.start:blk.stop]
        return {"k": k_c.contiguous(), "v": v_c.contiguous()}

    def _split_forward(self, x: torch.Tensor, memory: Optional[torch.Tensor],
                       sp: P.Split, return_state: bool = False,
                       cache_len: Optional[int] = None):
        """This rank's share of the attention of ``x`` (its sequence block
        when ``sp.seq``, else the whole rows). Under head TP
        (``sp.heads``): the whole rows' Q of this rank's heads, K/V of every
        KV head repeated to them, the partial ``wo`` product summed onto
        the blocks. Else Q, K, V of the block at its global positions, K/V
        gathered over the sequence (one all-gather of both), the mask
        offset by the block's start; cross-attention takes K/V from the
        whole ``memory``. With ``return_state``, also this rank's block of
        the decode cache, from the whole K/V of every KV head
        (:meth:`_cache_of`)."""
        cfg = self.cfg
        hd, nq = cfg.resolved_head_dim, cfg.n_heads
        causal = self.causal and memory is None
        heads = sp.heads(nq)
        if heads is not None:
            xs = P.gather_seq(x, sp)
            B, S, _ = xs.shape
            cols = slice(heads.start * hd, heads.stop * hd)
            q = xs @ self.wq[:, cols].to(self.dt)
            if self.bq is not None:
                q = q + self.bq[cols].to(self.dt)
            q = q.reshape(B, S, heads.size, hd)
            k, v = self._kv(xs if memory is None else memory)
            if self.use_rope and memory is None:
                cos, sin = rope_table(torch.arange(S, device=x.device), hd, cfg.rope_theta)
                q = apply_rope(q, cos, sin)
                k = apply_rope(k, cos, sin)
            state = self._cache_of(k, v, cache_len, sp) if return_state else None
            kv = torch.arange(heads.start, heads.stop, device=x.device) // (nq // cfg.n_kv_heads)
            k, v = k.index_select(2, kv), v.index_select(2, kv)
            out = self._attend(q, k, v, causal)
            y = out.reshape(B, S, heads.size * hd) @ self.wo[cols].to(self.dt)
            y = P.scatter_sum(y, sp)
            return (y, state) if return_state else y
        B, n, _ = x.shape
        start = sp.seq.start if sp.seq is not None else 0
        q, k, v = self._qkv(x, memory)
        if self.use_rope and memory is None:
            cos, sin = rope_table(torch.arange(start, start + n, device=x.device), hd,
                                  cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        if memory is None and sp.seq is not None:
            k, v = P.gather_seq(torch.cat([k, v], dim=-1), sp).chunk(2, dim=-1)
        out = self._attend(q, k, v, causal, start)
        y = out.reshape(B, n, nq * hd) @ self.wo.to(self.dt)
        return (y, self._cache_of(k, v, cache_len, sp)) if return_state else y

    def cache_init(self, batch: int, max_len: int) -> Cache:
        """KV cache: ``max_len`` slots for full attention, a ring buffer of
        ``min(window, max_len)`` for a sliding layer."""
        cfg = self.cfg
        length = self.cache_length(max_len)
        shape = (batch, length, cfg.n_kv_heads, cfg.resolved_head_dim)
        kw = {"dtype": self.dt, "device": self.wq.device}
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}

    def cache_length(self, max_len: int) -> int:
        """The slots of :meth:`cache_init`'s cache (a prefill's cache has
        ``cache_len`` slots whatever the window, as in JAX)."""
        return max_len if self.window is None else min(self.window, max_len)

    def decode(self, x: torch.Tensor, cache: Cache, pos: int,
               split: Optional[P.Split] = None,
               length: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
        """One token ``x`` (B, 1, d) at absolute position ``pos``. Writes its
        K/V into the cache in place and returns (out, cache). With ``split``
        (on a mesh) and ``length``, the cache's global slots: where the plan
        splits them (``split.cache(length)``) ``cache`` is this rank's block
        of them; slot validity is taken at the global slots, only the rank
        that owns the token's slot writes it, and the softmax is combined
        over the model axis (``parallel.softmax_combine``). Under head TP
        with KV heads that divide the model axis it raises ``ValueError``
        there, where the JAX ``attention_decode``'s cache constraint names
        the axis twice."""
        cfg = self.cfg
        dt = x.dtype
        B = x.shape[0]
        hd = cfg.resolved_head_dim
        blk = split.cache(length) if split is not None and length is not None else None
        if blk is not None and split.view.plan.kv_heads_sharded:
            raise ValueError(
                f"decode under head TP with {cfg.n_kv_heads} KV heads on a model axis of "
                f"{split.view.parts}: the cache's slots and its KV heads would both be split "
                f"over it (the JAX attention_decode raises DuplicateSpecError here)")
        q, k, v = self._qkv(x)
        if self.use_rope:
            cos, sin = rope_table(torch.full((1,), pos, device=x.device), hd,
                                  cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        k_cache, v_cache = cache["k"], cache["v"]
        n = k_cache.shape[1]
        L, start = (length, blk.start) if blk is not None else (n, 0)
        idx = torch.arange(start, start + n, device=x.device)
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
        mine = local_slot(slot, blk) if blk is not None else slot
        if mine is not None:
            k_cache[:, mine] = k[:, 0]
            v_cache[:, mine] = v[:, 0]
        scores = _group_scores(q, k_cache).float()
        if blk is None:
            out = _group_out(_masked_probs(scores, valid, hd, dt), v_cache)
        else:
            scores.div_(math.sqrt(hd)).masked_fill_(~valid, NEG_INF)
            out = P.softmax_combine(scores, v_cache, split.group, dt)
        return out.reshape(B, 1, cfg.n_heads * hd) @ self.wo.to(self.dt), cache

    def memory_kv(self, memory: torch.Tensor) -> Cache:
        """The cross cache of a (B, T, d) ``memory``: ``ck = memory @ wk``
        and ``cv = memory @ wv`` as (B, T, n_kv_heads, head_dim), without
        ``bk`` / ``bv``, as the JAX ``_layer_apply`` builds it."""
        cfg = self.cfg
        shape = (memory.shape[0], memory.shape[1], cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"ck": (memory @ self.wk.to(self.dt)).reshape(shape),
                "cv": (memory @ self.wv.to(self.dt)).reshape(shape)}

    def cross_decode(self, x: torch.Tensor, cross: Cache, split: Optional[P.Split] = None,
                     length: Optional[int] = None) -> torch.Tensor:
        """One token ``x`` (B, 1, d) against the cross cache ``cross``
        (:meth:`memory_kv`): q (plus ``bq``) only, then a softmax over
        every cached frame, unmasked. With ``split`` and ``length`` (the
        frames' global count) where the plan splits the frames, ``cross``
        is this rank's block of them and the softmax is combined over the
        model axis."""
        cfg = self.cfg
        B = x.shape[0]
        hd = cfg.resolved_head_dim
        q = (x @ self.wq.to(self.dt)).reshape(B, 1, cfg.n_heads, hd)
        if self.bq is not None:
            q = q + self.bq.to(self.dt).reshape(1, 1, cfg.n_heads, hd)
        scores = _group_scores(q, cross["ck"]).float()
        if split is None or length is None or split.cache(length) is None:
            out = _group_out(_masked_probs(scores, None, hd, x.dtype), cross["cv"])
        else:
            out = P.softmax_combine(scores.div_(math.sqrt(hd)), cross["cv"], split.group,
                                    x.dtype)
        return out.reshape(B, 1, cfg.n_heads * hd) @ self.wo.to(self.dt)


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------


class SwiGLU(nn.Module):
    """The gated FFN of width ``d_ff`` (default ``cfg.d_ff``), as the JAX
    ``swiglu_init(cfg, key, d_ff=)``: a MoE layer's shared expert and dense
    residual take their own width."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False,
                 d_ff: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.dt = dt = compute_dtype(cfg)
        self.w_in = new_param((d, 2 * f), dt, device, trainable, param_dtype(cfg))
        self.w_out = new_param((f, d), dt, device, trainable, param_dtype(cfg))

    def init_(self, gen: torch.Generator) -> None:
        normal_(self.w_in, gen, 0.02)
        normal_(self.w_out, gen, 0.02 / math.sqrt(2 * self.cfg.n_layers))

    def forward(self, x: torch.Tensor, split: Optional[P.Split] = None) -> torch.Tensor:
        """With ``split`` under head TP (``split.ffn``): this rank's ``d_ff``
        columns of the gate and the up-projection (and rows of ``w_out``)
        on the whole rows, the partial product summed onto the blocks;
        else ``x``'s own rows."""
        cols = split.ffn(self.w_out.shape[0]) if split is not None else None
        if cols is None:
            return self._product(x, self.w_in, self.w_out)
        f = self.w_out.shape[0]
        w_in = torch.cat([self.w_in[:, cols.start:cols.stop],
                          self.w_in[:, f + cols.start:f + cols.stop]], dim=1)
        out = self._product(P.gather_seq(x, split), w_in, self.w_out[cols.start:cols.stop])
        return P.scatter_sum(out, split)

    def _product(self, x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
        h = x @ w_in.to(self.dt)
        gate, up = h.chunk(2, dim=-1)
        act = F.silu(gate.float()).to(x.dtype) * up
        del h, gate, up
        return act @ w_out.to(self.dt)


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity-based sort dispatch)
# ---------------------------------------------------------------------------


def moe_capacity(cfg: ArchConfig, S: int) -> int:
    """Each expert's slots in a group (one batch row) of S tokens, as the
    JAX ``moe_apply`` sizes them: ``max(1, ceil(S * k / E *
    capacity_factor))``, so a decode step (S 1) gets one."""
    return max(1, int(math.ceil(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


class MoE(nn.Module):
    """The JAX ``moe_init`` / ``moe_apply``: ``cfg.n_experts`` SwiGLU
    experts ``w_in`` (E, d, 2f), ``w_out`` (E, f, d) of width
    ``cfg.resolved_moe_dff``, a ``router`` (d, E) kept in float32 (as the
    JAX leaf, serving too) and cast to the compute dtype at use, and when
    the config has them ``shared`` (kimi's always-on experts, a
    :class:`SwiGLU` of ``n_shared_experts * f``) and ``dense`` (arctic's
    dense residual, a :class:`SwiGLU` of ``cfg.d_ff``), added to the routed
    output. ``forward(x)`` returns (out, aux), aux the Switch load-balancing
    loss.

    Each token picks its top ``k`` experts by router probability (ties to
    the lower index, as ``lax.top_k``), gates renormalised to sum to one.
    Each batch row is a group: its S * k assignments are sorted by expert
    (stable), and each expert keeps its first :func:`moe_capacity` of them;
    the rest are dropped and add nothing. The kept tokens are laid into one
    (E, B * cap, d) buffer, the batch folded into the capacity axis, and
    run through one batched product per projection. Every step's backward
    sums in a fixed order, so two identical training steps give bit-equal
    gradients on the card too.

    ``batch_sum`` (None, or a mesh trainer's differentiable sum over the
    ranks that split the batch) makes the load-balancing loss the global
    batch's: its mean router probabilities and expert loads are sums over
    those ranks divided by their token count, as the JAX loss computes
    them over the whole batch."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        d, f, E = cfg.d_model, cfg.resolved_moe_dff, cfg.n_experts
        self.dt = dt = compute_dtype(cfg)
        self.router = new_param((d, E), torch.float32, device, trainable, torch.float32)
        self.w_in = new_param((E, d, 2 * f), dt, device, trainable, param_dtype(cfg))
        self.w_out = new_param((E, f, d), dt, device, trainable, param_dtype(cfg))
        self.shared = (SwiGLU(cfg, device, trainable, d_ff=cfg.n_shared_experts * f)
                       if cfg.n_shared_experts else None)
        self.dense = (SwiGLU(cfg, device, trainable, d_ff=cfg.d_ff)
                      if cfg.moe_dense_residual else None)
        self.batch_sum = None

    def init_(self, gen: torch.Generator) -> None:
        """The scales of ``moe_init``. The experts are drawn one at a time,
        so no float32 temporary outgrows one expert's slice (arctic's whole
        ``w_in`` in float32 would be 35.7 GB)."""
        normal_(self.router, gen, 0.02)
        for w, scale in ((self.w_in, 0.02),
                         (self.w_out, 0.02 / math.sqrt(2 * self.cfg.n_layers))):
            for e in range(w.shape[0]):
                normal_(w[e], gen, scale)
        for m in (self.shared, self.dense):
            if m is not None:
                m.init_(gen)

    def route(self, x: torch.Tensor):
        """x (B, S, d) -> the router logits (``x @ router`` in the compute
        dtype, then float32) and their softmax (B, S, E), and the gates and
        expert ids (B, S, k): a stable descending sort of the probabilities
        cut to k (``torch.topk`` does not promise ``lax.top_k``'s order on
        ties), the gates divided by ``max(sum, 1e-9)``."""
        logits = (x @ self.router.to(self.dt)).float()
        probs = torch.softmax(logits, dim=-1)
        k = self.cfg.top_k
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[..., :k], idx[..., :k]
        return logits, probs, gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9), idx

    def dispatch(self, idx: torch.Tensor, S: int):
        """The sort dispatch of expert ids ``idx`` (B, S, k), each row a
        group: ``order`` (B, S * k), the stable argsort of the flat ids;
        ``keep``, whether the assignment at each sorted place is within its
        expert's capacity (JAX's ``pos_in_exp < cap``); ``slot``, its row of
        the (E * B * cap, d) buffer, expert-major then batch row then place
        (a dropped one clipped to the last place, where it adds zero); and
        ``cap``."""
        cfg = self.cfg
        B, E = idx.shape[0], cfg.n_experts
        cap = moe_capacity(cfg, S)
        flat = idx.reshape(B, S * cfg.top_k)
        sorted_exp, order = torch.sort(flat, dim=-1, stable=True)
        counts = torch.zeros((B, E), dtype=flat.dtype, device=flat.device).scatter_add_(
            1, flat, torch.ones_like(flat))
        starts = torch.cumsum(counts, dim=-1) - counts
        pos = (torch.arange(flat.shape[1], device=flat.device)[None, :]
               - torch.gather(starts, 1, sorted_exp))
        row = torch.arange(B, device=flat.device)[:, None]
        slot = (sorted_exp * B + row) * cap + torch.clamp(pos, 0, cap - 1)
        return order, pos < cap, slot, cap

    def forward(self, x: torch.Tensor, split: Optional[P.Split] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(out, aux)``. With ``split`` the whole rows are gathered and
        routed, this rank runs its experts only (``split.experts``; all of
        them where they are not split) and the gate-weighted partial output
        is summed onto the sequence blocks (or, all experts run, the block
        kept); ``shared`` and ``dense`` take ``x``'s own rows."""
        x_in = x
        x = P.gather_seq(x, split)
        cfg = self.cfg
        dt = x.dtype
        B, S, d = x.shape
        E, k = cfg.n_experts, cfg.top_k
        _, probs, gates, idx = self.route(x)
        # each expert's copies, as ``bincount`` counts them, in a tensor whose
        # shape does not depend on the routes (a trace with fake tensors runs it)
        flat = idx.reshape(-1)
        counts = flat.new_zeros(E).scatter_add_(0, flat, torch.ones_like(flat)).float()
        if self.batch_sum is None:
            aux = E * torch.sum(probs.mean(dim=(0, 1)) * (counts / (B * S * k)))
        else:
            counts = self.batch_sum(counts)
            n = counts.sum() / k  # the tokens of the global batch
            aux = E * torch.sum((self.batch_sum(probs.sum(dim=(0, 1))) / n)
                                * (counts / (n * k)))
        order, keep, slot, cap = self.dispatch(idx, S)
        # each token's k copies in token order, then permuted into the sorted
        # order: the backward sums a token's k gradients over this (B, S, k, d)
        # view in a fixed order, and the permutation adds each gradient once
        # (a gather by ``order // k`` would scatter-add k copies into each
        # token, with atomics in no fixed order on the card)
        rows = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
        rows = torch.gather(rows, 1, order[..., None].expand(-1, -1, d))
        rows = torch.where(keep[..., None], rows, 0)
        buf = x.new_zeros((E * B * cap, d)).index_add_(0, slot.reshape(-1), rows.reshape(-1, d))
        del rows
        n = B * cap  # one expert's rows of the buffer
        buf, w_in, w_out = buf.view(E, n, d), self.w_in, self.w_out
        mine = split.experts(E) if split is not None else None
        if mine is not None:  # this rank's experts and the assignments to them
            lo, hi = mine.start * n, mine.stop * n
            buf, w_in, w_out = (t[mine.start:mine.stop] for t in (buf, w_in, w_out))
            keep = keep & (slot >= lo) & (slot < hi)
            slot = torch.clamp(slot - lo, 0, hi - lo - 1)
        h = torch.bmm(buf, w_in.to(self.dt))
        del buf
        gate, up = h.chunk(2, dim=-1)
        act = F.silu(gate.float()).to(dt) * up
        del h, gate, up
        y = torch.bmm(act, w_out.to(self.dt)).view(-1, d)
        del act
        picked = torch.where(keep[..., None], y[slot], 0)
        del y
        # undo the sort: sorted place j holds flat assignment order[j]
        picked = torch.empty_like(picked).scatter_(
            1, order[..., None].expand(-1, -1, d), picked)
        out = torch.einsum("bskd,bsk->bsd", picked.view(B, S, k, d), gates.to(dt))
        out = P.scatter_sum(out, split) if mine is not None else P.keep_seq(out, split)
        for m in (self.shared, self.dense):
            if m is not None:
                out = out + m(x_in, split)
        return out, aux


def moe_plain(moe: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe(x)`` written plainly and apart from :class:`MoE`'s dispatch,
    for the tests and ``chip_smoke.py`` (no model path calls it): the top
    k as k rounds of argmax (the first of equal maxima, ``lax.top_k``'s
    order), each (token, slot)'s place in its expert's queue as the count
    of earlier assignments to that expert in its row (tokens in order, a
    token's slots in order; no sort), kept below the capacity, and a loop
    over experts running each one's SwiGLU on the tokens it keeps."""
    cfg = moe.cfg
    dt = x.dtype
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax((x @ moe.router.to(dt)).float(), dim=-1)
    left, picks = probs.clone(), []
    for _ in range(k):
        i = torch.argmax(left, dim=-1)
        picks.append(i)
        left.scatter_(-1, i[..., None], float("-inf"))
    idx = torch.stack(picks, dim=-1)  # (B, S, k)
    gates = torch.gather(probs, -1, idx)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    load = F.one_hot(idx, E).sum(dim=(0, 1, 2)).float() / (B * S * k)
    aux = E * torch.sum(probs.mean(dim=(0, 1)) * load)
    hot = F.one_hot(idx.reshape(B, S * k), E)
    place = ((torch.cumsum(hot, dim=1) - hot) * hot).sum(-1).reshape(B, S, k)
    kept = place < moe_capacity(cfg, S)
    parts = torch.zeros((B, S, k, d), dtype=dt, device=x.device)
    for e in range(E):
        b, t, j = torch.nonzero((idx == e) & kept, as_tuple=True)
        if b.numel():
            gate, up = (x[b, t] @ moe.w_in[e].to(dt)).chunk(2, dim=-1)
            parts[b, t, j] = (F.silu(gate.float()).to(dt) * up) @ moe.w_out[e].to(dt)
    out = torch.einsum("bskd,bsk->bsd", parts, gates.to(dt))
    for m in (moe.shared, moe.dense):
        if m is not None:
            out = out + m(x)
    return out, aux


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block), chunkwise-parallel linear attention form
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """The xLSTM matrix-memory mixer with its stabilised sigmoid gating, as
    the JAX package writes it: an up-projection to ``di = 2 d`` (u and the
    output gate z), per-head q, k, v of width ``di / H``, a forget gate
    ``f in (0, 1)`` and a bounded input gate ``i = exp(min(pre, 0))``.
    A full sequence runs chunkwise (``chunk`` positions at a time, S padded
    to a whole number of chunks) in float32; decode carries the matrix
    memory ``C`` (B, H, hd, hd) and the normaliser ``n`` (B, H, hd)."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        d, H = cfg.d_model, cfg.n_heads
        di = 2 * d  # up-projection factor 2 (xLSTM paper)
        self.dt = dt = compute_dtype(cfg)
        pdt, f32 = param_dtype(cfg), torch.float32
        self.w_up = new_param((d, 2 * di), dt, device, trainable, pdt)  # u and gate z
        self.wq = new_param((di, di), dt, device, trainable, pdt)
        self.wk = new_param((di, di), dt, device, trainable, pdt)
        self.wv = new_param((di, di), dt, device, trainable, pdt)
        self.w_if = new_param((d, 2 * H), f32, device, trainable, f32)
        self.b_if = new_param((2 * H,), f32, device, trainable, f32)
        self.w_down = new_param((di, d), dt, device, trainable, pdt)
        # a plain scale, as the JAX leaf ``mixer/norm`` (not ``norm/scale``)
        self.norm = new_param((di,), f32, device, trainable, pdt)

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.w_up, self.wq, self.wk, self.wv, self.w_if):
            normal_(w, gen, 0.02)
        H = self.cfg.n_heads
        self.b_if[:H] = 0.0  # input gate
        self.b_if[H:] = 3.0  # forget gate, open at init
        normal_(self.w_down, gen, 0.02 / math.sqrt(2 * self.cfg.n_layers))
        self.norm.fill_(1.0)

    def _gates(self, x: torch.Tensor):
        """x: (B, S, d) -> the input gate and log forget gate, (B, S, H)
        float32, from x cast to float32."""
        gif = x.float() @ self.w_if + self.b_if
        i_pre, f_pre = gif.chunk(2, dim=-1)
        return torch.exp(torch.clamp_max(i_pre, 0.0)), F.logsigmoid(f_pre)

    def _up(self, x: torch.Tensor):
        u, z = (x @ self.w_up.to(self.dt)).chunk(2, dim=-1)
        q, k, v = (u @ w.to(self.dt) for w in (self.wq, self.wk, self.wv))
        return z, q, k, v

    def _out(self, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """h (in ``cfg.dtype``) normalised, gated by silu(z) and projected
        down."""
        h = rms_norm(h, self.norm, self.cfg.norm_eps)
        h = h * F.silu(z.float()).to(self.dt)
        return h @ self.w_down.to(self.dt)

    def forward(self, x: torch.Tensor, *, return_state: bool = False,
                cache_len: Optional[int] = None, chunk: int = 256,
                split: Optional[P.Split] = None):
        """Full sequence from a zero state, ``chunk`` positions at a time.
        The state ``{"C", "n"}`` after the last position does not depend on
        ``cache_len``. With ``split``, the whole sequence gathered and run,
        this rank's block kept."""
        x = P.gather_seq(x, split)
        dt = self.dt
        B, S, _ = x.shape
        H = self.cfg.n_heads
        z, q, k, v = self._up(x)
        di = q.shape[-1]
        hd = di // H
        q = q.reshape(B, S, H, hd)
        k = k.reshape(B, S, H, hd) / math.sqrt(hd)  # in cfg.dtype, as JAX
        v = v.reshape(B, S, H, hd)
        i_gate, log_f = self._gates(x)  # (B, S, H)
        C = max(1, min(chunk, S))
        n_chunks = (S + C - 1) // C
        pad = n_chunks * C - S
        # heads first: (B, H, S, hd) float32 and (B, H, S), zero-padded to
        # whole chunks (a padded position adds nothing and decays nothing)
        q, k, v = (F.pad(a.float().transpose(1, 2), (0, 0, 0, pad)) for a in (q, k, v))
        i_gate, log_f = (F.pad(a.transpose(1, 2), (0, pad)) for a in (i_gate, log_f))
        Cst = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        nst = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        tri = torch.ones((C, C), dtype=torch.bool, device=x.device).tril()
        hs = []
        for qc, kc, vc, ic, fc in zip(*(a.split(C, dim=2) for a in (q, k, v, i_gate, log_f))):
            Cst, nst, h = _mlstm_chunk(Cst, nst, qc, kc, vc, ic, fc, tri)
            hs.append(h.to(dt))
        h = torch.cat(hs, dim=2).transpose(1, 2).reshape(B, n_chunks * C, di)[:, :S]
        y = P.keep_seq(self._out(h, z), split)
        return (y, {"C": Cst, "n": nst}) if return_state else y

    def cache_init(self, batch: int, max_len: int) -> Cache:
        H = self.cfg.n_heads
        hd = 2 * self.cfg.d_model // H
        kw = {"dtype": torch.float32, "device": self.w_if.device}
        return {"C": torch.zeros((batch, H, hd, hd), **kw),
                "n": torch.zeros((batch, H, hd), **kw)}

    def decode(self, x: torch.Tensor, state: Cache,
               pos: int) -> Tuple[torch.Tensor, Cache]:
        """One token: one step of the recurrence in float32 (q, k, v cast
        up before k is scaled, as the JAX decode casts)."""
        B = x.shape[0]
        H = self.cfg.n_heads
        z, q, k, v = self._up(x)
        di = q.shape[-1]
        hd = di // H
        q = q.reshape(B, H, hd).float()
        k = k.reshape(B, H, hd).float() / math.sqrt(hd)
        v = v.reshape(B, H, hd).float()
        i_gate, log_f = self._gates(x)
        f = torch.exp(log_f[:, 0])  # (B, H)
        ki = k * i_gate[:, 0, :, None]
        Cn = state["C"] * f[..., None, None] + ki[..., :, None] * v[..., None, :]
        nn_ = state["n"] * f[..., None] + ki
        num = (q[..., None, :] @ Cn)[..., 0, :]  # (B, H, hd)
        den = torch.clamp_min(torch.abs(torch.sum(q * nn_, dim=-1)), 1.0)
        h = (num / den[..., None]).reshape(B, 1, di).to(self.dt)
        return self._out(h, z), {"C": Cn, "n": nn_}


def _mlstm_chunk(Cst, nst, q, k, v, i_gate, log_f, tri):
    """One chunk of the mLSTM, heads first: q, k, v (B, H, C, hd) float32,
    ``i_gate``, ``log_f`` (B, H, C), the carried state ``Cst`` (B, H, hd,
    hd) and ``nst`` (B, H, hd). Returns the new state and h (B, H, C, hd).

    The JAX ``chunk_step``'s four-operand einsums as pairwise products in
    their left-to-right order: nothing larger than (B, H, C, C) or
    (B, H, hd, hd) is built."""
    cum = torch.cumsum(log_f, dim=-1)  # (B, H, C) inclusive
    total = cum[..., -1]  # (B, H)
    # intra-chunk: causal decayed attention, w = exp(F(q) - F(k)) for k <= q
    # (the upper triangle set to -inf before exp: the same values as JAX's
    # where after exp, without an inf whose zero gradient would be a NaN)
    decay = cum[..., :, None] - cum[..., None, :]  # (B, H, Cq, Ck)
    w = torch.exp(decay.masked_fill_(~tri, float("-inf")))
    s = q @ k.transpose(-1, -2)  # (B, H, Cq, Ck)
    p = s * i_gate[..., None, :] * w
    intra = p @ v  # (B, H, Cq, hd)
    n_intra = torch.sum(p, dim=-1)  # (B, H, Cq)
    # inter-chunk: the carried state, decayed from the chunk start to q
    qdecay = torch.exp(cum)
    inter = (q @ Cst) * qdecay[..., None]
    n_inter = (q @ nst[..., None])[..., 0] * qdecay
    # the state after the chunk
    kdecay = torch.exp(total[..., None] - cum)  # from k to the chunk's end
    kw = k * i_gate[..., None] * kdecay[..., None]  # (B, H, Ck, hd)
    g = torch.exp(total)
    Cnew = Cst * g[..., None, None] + kw.transpose(-1, -2) @ v
    nnew = nst * g[..., None] + torch.sum(kw, dim=-2)
    h = intra + inter
    norm = torch.clamp_min(torch.abs(n_intra + n_inter), 1.0)[..., None]
    return Cnew, nnew, h / norm


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory block), block-diagonal recurrence over time
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """The xLSTM scalar-memory mixer: input pre-activations ``x @ w_x``
    ([i | f | z | o] blocks of width d), a block-diagonal recurrence ``r``
    (H, hd, 4 hd) on h, and the stabilised exponential gating of the
    xLSTM paper (eq. 15-17), stepped over time in float32 with the state
    ``h, c, n, m`` (B, d) (``m`` starts at -1e9) by the op
    ``kernels.slstm.slstm_scan``, prefill and decode alike."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        d, H = cfg.d_model, cfg.n_heads
        hd = d // H
        self.dt = dt = compute_dtype(cfg)
        pdt, f32 = param_dtype(cfg), torch.float32
        self.w_x = new_param((d, 4 * d), dt, device, trainable, pdt)  # i, f, z, o pre-acts
        self.r = new_param((H, hd, 4 * hd), f32, device, trainable, f32)
        self.b = new_param((4 * d,), f32, device, trainable, f32)
        self.w_down = new_param((d, d), dt, device, trainable, pdt)

    def init_(self, gen: torch.Generator) -> None:
        d = self.cfg.d_model
        normal_(self.w_x, gen, 0.02)
        normal_(self.r, gen, 0.02)
        self.b.zero_()
        self.b[d:2 * d] = 3.0  # forget gate, open at init
        normal_(self.w_down, gen, 0.02 / math.sqrt(2 * self.cfg.n_layers))

    def _cell(self, xwb: torch.Tensor, state: Tuple[torch.Tensor, ...]):
        """One step, plain torch (``kernels.slstm.slstm_cell``). xwb: (B, 4d)
        float32 input pre-activation with the bias added; state: h, c, n, m
        (B, d)."""
        return slstm_cell(xwb, self.r, state)

    def forward(self, x: torch.Tensor, *, return_state: bool = False,
                cache_len: Optional[int] = None, split: Optional[P.Split] = None):
        """Full sequence from the initial state: ``kernels.slstm.slstm_scan``
        (the JAX ``lax.scan``): one kernel launch on the card, the plain
        loop over positions on the CPU; h stays float32 until the
        down-projection. With ``split``, the whole sequence gathered and
        run, this rank's block kept."""
        x = P.gather_seq(x, split)
        xwb = (x @ self.w_x.to(self.dt)).float() + self.b  # (B, S, 4d)
        hs, *state = slstm_scan(xwb, self.r, *self._state(x.shape[0]))
        y = P.keep_seq(hs.to(self.dt) @ self.w_down.to(self.dt), split)
        return (y, dict(zip("hcnm", state))) if return_state else y

    def _state(self, batch: int) -> Tuple[torch.Tensor, ...]:
        h, c, n = (torch.zeros((batch, self.cfg.d_model), dtype=torch.float32,
                               device=self.r.device) for _ in range(3))
        return h, c, n, torch.full_like(h, NEG_INF)

    def cache_init(self, batch: int, max_len: int) -> Cache:
        return dict(zip("hcnm", self._state(batch)))

    def decode(self, x: torch.Tensor, state: Cache,
               pos: int) -> Tuple[torch.Tensor, Cache]:
        """One position from the cached state: the same scan at S = 1."""
        xwb = (x @ self.w_x.to(self.dt)).float() + self.b  # (B, 1, 4d)
        hs, *new = slstm_scan(xwb, self.r, *(state[k] for k in "hcnm"))
        out = hs.to(self.dt) @ self.w_down.to(self.dt)
        return out, dict(zip("hcnm", new))


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
        pdt, f32 = param_dtype(cfg), torch.float32
        self.w_gate = new_param((d, dr), dt, device, trainable, pdt)
        self.w_rec_in = new_param((d, dr), dt, device, trainable, pdt)
        self.w_a = new_param((dr, dr), f32, device, trainable, f32)
        self.w_i = new_param((dr, dr), f32, device, trainable, f32)
        self.lam = new_param((dr,), f32, device, trainable, f32)
        self.w_down = new_param((dr, d), dt, device, trainable, pdt)

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
                cache_len: Optional[int] = None, split: Optional[P.Split] = None):
        """Full sequence: the scan is ``kernels.ops.rglru_scan`` from a zero
        state, the CUDA kernel on the card (its plain version on the CPU),
        differentiable through its backward kernel. The state is one vector
        per row, whatever ``cache_len``. With ``split``, the whole sequence
        gathered and scanned, this rank's block kept."""
        x = P.gather_seq(x, split)
        B = x.shape[0]
        gate, u = self._gate_and_input(x)
        a, b = self._coeffs(u)
        del u
        h = kops.rglru_scan(a, b, torch.zeros((B, a.shape[-1]), dtype=torch.float32,
                                              device=x.device))
        del a, b
        y = P.keep_seq((h * gate).to(x.dtype) @ self.w_down.to(self.dt), split)
        return (y, {"h": h[:, -1].contiguous()}) if return_state else y

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
