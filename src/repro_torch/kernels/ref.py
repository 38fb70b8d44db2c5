"""Plain torch oracles of the workload kernels (the ``ref.py`` contract).

Each function is the mathematical specification of one kernel, written as
the JAX package's ``repro.kernels.ref`` writes it, in plain tensor ops on
any device. The CPU tests hold each one against its jnp twin, and the
kernels' plain versions against these.
"""
from __future__ import annotations

import math

import torch

#: the finite mask value of the attention oracle and the flash kernel.
NEG_INF = -1e30


def attention_mask(Sq: int, Sk: int, causal: bool, window, device,
                   q_offset: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool, True where query ``q`` sees key ``k``: ``diff = q - k``
    counted from position 0 for both (top-left alignment), query row i at
    position ``q_offset + i`` (default 0), ``diff >= 0`` when causal,
    ``diff < window`` when a window is given."""
    diff = (torch.arange(q_offset, q_offset + Sq, device=device)[:, None]
            - torch.arange(Sk, device=device)[None, :])
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= diff >= 0
    if window is not None:
        mask &= diff < window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0):
    """Naive softmax attention. q, k, v: (B, H, S, D) -> (B, H, Sq, D).

    Scores in float32, masked entries set to ``-1e30`` (so a row with no
    visible key averages all of V), output in q's dtype. Query row i is at
    position ``q_offset + i`` (the JAX oracle's is 0: its rows
    ``q_offset:q_offset + Sq`` of the whole sequence's queries)."""
    D = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    mask = attention_mask(q.shape[2], k.shape[2], causal, window, q.device, q_offset)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def rglru_scan_ref(a, b, h0):
    """Sequential linear recurrence h_t = a_t * h_{t-1} + b_t.

    a, b: (B, S, D); h0: (B, D). Returns h: (B, S, D)."""
    hs = []
    h = h0
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def xent_ref(logits, targets):
    """Per-token cross-entropy: logsumexp(logits) - logits[target]. (N, V).

    Targets must lie in ``[0, V)``: ``torch.gather`` raises on others (the
    jnp twin wraps negative ids and gives NaN for ids >= V)."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, 1, targets[:, None].long())[:, 0]
    return logz - gold


def mlstm_recurrent_ref(q, k, v, i_gate, log_f):
    """Step-by-step mLSTM recurrence oracle (validates the chunkwise form).

    q,k,v: (B, S, H, D); i_gate/log_f: (B, S, H). Returns h: (B, S, H, D).
    C_t = f_t C_{t-1} + i_t k_t v_t^T ; n_t = f_t n_{t-1} + i_t k_t ;
    h_t = (q_t . C_t) / max(|q_t . n_t|, 1).
    """
    B, S, H, D = q.shape
    q, k, v = q.float(), k.float(), v.float()
    C = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    hs = []
    for t in range(S):
        qt, kt, vt, it = q[:, t], k[:, t], v[:, t], i_gate[:, t]
        f = torch.exp(log_f[:, t])  # (B, H)
        C = C * f[..., None, None] + torch.einsum("bhd,bh,bhe->bhde", kt, it, vt)
        n = n * f[..., None] + kt * it[..., None]
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", qt, n)), min=1.0)
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=1)
