"""The plain reference of a decoder-only language model, in float32.

It follows the equations of the configurations the benchmark runs, as the
configuration file's ``run`` sizes state them, and nothing of the program
under test: no kernel, no cache, no batching trick, no import of the
program. Supported layer kinds: ``full`` (causal grouped-query attention
with RoPE over the whole head), ``mlstm`` (the xLSTM matrix memory, in its
parallel form over the whole sequence) and ``slstm`` (the xLSTM scalar
memory, a loop over positions); the FFN is SwiGLU, or none when
``d_ff`` is 0; the unembedding is the tied table.

    x = table[tokens] * sqrt(d)
    each layer: x += mixer(rmsnorm(x)); x += swiglu(rmsnorm(x)) if d_ff
    logits = rmsnorm(x) @ table[:vocab].T

``prec="fp8"`` is the control: what the configuration computes and holds
in bfloat16 (the products of the projections, attention's two products and
the unembedding, their operands and results, and the residual stream)
is rounded to float8 e4m3 with one scale a tensor; what it computes in
float32 (norms, gates, softmax, the recurrences) stays float32. Gradients
pass the rounding straight through.

Weights are a dict from the program's parameter names to float32 tensors:
:func:`weight_spec` lists each name, shape and initial fill, and the
benchmark draws them from its seed for both sides.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Params = Dict[str, torch.Tensor]
NEG = -1e9


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------


def kinds(run: dict) -> List[str]:
    """Each layer's mixer kind: the pattern repeated, then its head as tail."""
    if run.get("first_k_dense", 0):
        raise NotImplementedError("leading dense layers")
    pat = list(run["pattern"])
    units, tail = divmod(run["n_layers"], len(pat))
    return pat * units + pat[:tail]


def weight_spec(run: dict) -> List[Tuple[str, Tuple[int, ...], tuple]]:
    """``(name, shape, fill)`` of every weight, in drawing order. A fill
    is ``("normal", std)``, ``("const", value)`` or ``("blocks",
    ((count, value), ...))`` along the only axis. A matrix ``x @ w`` is
    drawn at 1 / sqrt(its input width) (the sLSTM's ``r``: of a head's),
    the table at 1 / sqrt(d), so that at any width the embedded tokens,
    each projection's output and each layer's addition to the residual
    stream are of the order of one, and every layer moves the logits."""
    if not run.get("tie_embeddings", True):
        raise NotImplementedError("an untied head")
    d = run["d_model"]
    H, K, hd = run["n_heads"], run["n_kv_heads"], run["head_dim"]

    def matrix(name, rows, cols):
        return (name, (rows, cols), ("normal", rows ** -0.5))

    spec = [("embed", (run["padded_vocab"], d), ("normal", d ** -0.5))]
    for i, kind in enumerate(kinds(run)):
        p = f"layers.{i}."
        spec.append((p + "norm1.scale", (d,), ("const", 1.0)))
        if kind == "full":
            spec += [matrix(p + "mixer.wq", d, H * hd), matrix(p + "mixer.wk", d, K * hd),
                     matrix(p + "mixer.wv", d, K * hd), matrix(p + "mixer.wo", H * hd, d)]
            if run.get("qkv_bias"):
                spec += [(p + f"mixer.b{c}", (n * hd,), ("const", 0.0))
                         for c, n in (("q", H), ("k", K), ("v", K))]
        elif kind == "mlstm":
            di = 2 * d
            spec += [matrix(p + "mixer.w_up", d, 2 * di), matrix(p + "mixer.wq", di, di),
                     matrix(p + "mixer.wk", di, di), matrix(p + "mixer.wv", di, di),
                     matrix(p + "mixer.w_if", d, 2 * H),
                     (p + "mixer.b_if", (2 * H,), ("blocks", ((H, 0.0), (H, 3.0)))),
                     matrix(p + "mixer.w_down", di, d),
                     (p + "mixer.norm", (di,), ("const", 1.0))]
        elif kind == "slstm":
            shd = d // H
            spec += [matrix(p + "mixer.w_x", d, 4 * d),
                     (p + "mixer.r", (H, shd, 4 * shd), ("normal", shd ** -0.5)),
                     (p + "mixer.b", (4 * d,), ("blocks", ((d, 0.0), (d, 3.0), (2 * d, 0.0)))),
                     matrix(p + "mixer.w_down", d, d)]
        else:
            raise NotImplementedError(f"layer kind {kind!r}")
        if run["d_ff"]:
            spec += [(p + "norm2.scale", (d,), ("const", 1.0)),
                     matrix(p + "ffn.w_in", d, 2 * run["d_ff"]),
                     matrix(p + "ffn.w_out", run["d_ff"], d)]
    spec.append(("final_norm.scale", (d,), ("const", 1.0)))
    return spec


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    at 448), back in x's dtype; the gradient passes straight through."""
    s = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    y = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (y - x.detach())


def held(x: torch.Tensor, prec: str) -> torch.Tensor:
    """A tensor the configuration holds in bfloat16: in the control, in
    float8."""
    return q8(x) if prec == "fp8" else x


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """A product the configuration computes in bfloat16 (its operands and
    its result held so)."""
    if prec == "fp8":
        return q8(q8(a) @ q8(b))
    return a @ b


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd) rotated by position, halves paired, over the
    whole head."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=x.dtype, device=x.device) / half)
    ang = torch.arange(S, dtype=x.dtype, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(P: Params, p: str, x: torch.Tensor, run: dict, prec: str) -> torch.Tensor:
    B, S, _ = x.shape
    H, K, hd = run["n_heads"], run["n_kv_heads"], run["head_dim"]
    q, k, v = (mm(x, P[p + w], prec) for w in ("wq", "wk", "wv"))
    if run.get("qkv_bias"):
        q, k, v = q + P[p + "bq"], k + P[p + "bk"], v + P[p + "bv"]
    q = rope(q.view(B, S, H, hd), run["rope_theta"])
    k = rope(k.view(B, S, K, hd), run["rope_theta"])
    v = v.view(B, S, K, hd)
    qg = q.view(B, S, K, H // K, hd).permute(0, 2, 3, 1, 4)  # B K G S hd
    kt = k.permute(0, 2, 3, 1)[:, :, None]  # B K 1 hd S
    scores = mm(qg, kt, prec) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, NEG), dim=-1)
    out = mm(probs, v.permute(0, 2, 1, 3)[:, :, None], prec)  # B K G S hd
    return mm(out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd), P[p + "wo"], prec)


def swiglu(P: Params, p: str, x: torch.Tensor, prec: str) -> torch.Tensor:
    gate, up = mm(x, P[p + "w_in"], prec).chunk(2, dim=-1)
    return mm(F.silu(gate) * up, P[p + "w_out"], prec)


def mlstm(P: Params, p: str, x: torch.Tensor, run: dict, prec: str) -> torch.Tensor:
    """h_t = sum_{s<=t} D_ts (q_t . k_s) v_s / max(|sum_s D_ts (q_t . k_s)|, 1)
    with D_ts = exp(F_t - F_s) i_s, F the running sum of log forget gates,
    i = exp(min(input pre-activation, 0)); k scaled by 1/sqrt(hd)."""
    B, S, d = x.shape
    H = run["n_heads"]
    u, z = mm(x, P[p + "w_up"], prec).chunk(2, dim=-1)
    di = u.shape[-1]
    hd = di // H
    q, k, v = (mm(u, P[p + w], prec).view(B, S, H, hd).transpose(1, 2)
               for w in ("wq", "wk", "wv"))
    k = k / math.sqrt(hd)
    i_pre, f_pre = (x @ P[p + "w_if"] + P[p + "b_if"]).chunk(2, dim=-1)  # float32 gates
    log_i = torch.clamp_max(i_pre, 0.0).transpose(1, 2)  # B H S
    Fc = torch.cumsum(F.logsigmoid(f_pre).transpose(1, 2), dim=-1)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    logD = (Fc[..., :, None] - Fc[..., None, :] + log_i[..., None, :]).masked_fill(
        ~causal, float("-inf"))
    w = (q @ k.transpose(-1, -2)) * torch.exp(logD)  # B H S S
    den = torch.clamp_min(torch.abs(w.sum(-1, keepdim=True)), 1.0)
    h = ((w @ v) / den).transpose(1, 2).reshape(B, S, di)
    h = rms(h, P[p + "norm"], run["norm_eps"]) * F.silu(z)
    return mm(h, P[p + "w_down"], prec)


def slstm_step(pre: torch.Tensor, c, n, m):
    """The stabilised exponential gating of one position: pre (B, 4d) is
    [i | f | z | o]."""
    i_pre, f_pre, z_pre, o_pre = pre.chunk(4, dim=-1)
    lfm = F.logsigmoid(f_pre) + m
    m_new = torch.maximum(lfm, i_pre)
    c_new = torch.exp(lfm - m_new) * c + torch.exp(i_pre - m_new) * torch.tanh(z_pre)
    n_new = torch.exp(lfm - m_new) * n + torch.exp(i_pre - m_new)
    return torch.sigmoid(o_pre) * c_new / torch.clamp_min(n_new, 1.0), c_new, n_new, m_new


def _recurrent(h: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Head j's slice of h (B, d) times r[j] (hd, 4 hd), the H results laid
    end to end along 4d."""
    B = h.shape[0]
    H, hd = r.shape[0], r.shape[1]
    return torch.einsum("bhk,hkj->bhj", h.view(B, H, hd), r).reshape(B, 4 * H * hd)


def _scan_forward(xwb: torch.Tensor, r: torch.Tensor):
    """Every position in turn from h = c = n = 0, m = -1e9: every h (B, S,
    d), the pre-activations (B, S, 4d) and every c, n, m (B, S, d)."""
    B, S, d4 = xwb.shape
    d = d4 // 4
    h = c = n = xwb.new_zeros(B, d)
    m = xwb.new_full((B, d), NEG)
    hs, cs, ns, ms, pres = [], [], [], [], []
    for t in range(S):
        pre = xwb[:, t] + _recurrent(h, r)
        h, c, n, m = slstm_step(pre, c, n, m)
        hs.append(h), cs.append(c), ns.append(n), ms.append(m), pres.append(pre)
    return tuple(torch.stack(v, dim=1) for v in (hs, pres, cs, ns, ms))


def _scan_backward(r, pres, hs, cs, ns, ms, dhs):
    """The adjoint of :func:`_scan_forward`, position by position in
    reverse: the gradients of ``xwb`` and of ``r``."""
    B, S, d = hs.shape
    H, hd = r.shape[0], r.shape[1]
    rT = r.transpose(1, 2)
    zero = hs.new_zeros(B, d)
    dh_next, dc, dn, dm = zero, zero, zero, zero
    dpres = []
    for t in range(S - 1, -1, -1):
        i_pre, f_pre, z_pre, o_pre = pres[:, t].chunk(4, dim=-1)
        c_prev, n_prev, m_prev = ((cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]) if t
                                  else (zero, zero, hs.new_full((B, d), NEG)))
        c, n, m = cs[:, t], ns[:, t], ms[:, t]
        lfm = F.logsigmoid(f_pre) + m_prev
        a, b = torch.exp(lfm - m), torch.exp(i_pre - m)
        zt, og = torch.tanh(z_pre), torch.sigmoid(o_pre)
        den = torch.clamp_min(n, 1.0)
        gh = dhs[:, t] + dh_next
        d_og = gh * c / den
        gc = dc + gh * og / den
        gn = dn + torch.where(n >= 1.0, -gh * og * c / (den * den), 0.0)
        d_a = gc * c_prev + gn * n_prev
        d_b = gc * zt + gn
        gm = dm - d_a * a - d_b * b
        w = torch.where(lfm > i_pre, 1.0, torch.where(lfm < i_pre, 0.0, 0.5))
        d_lfm = d_a * a + gm * w
        dpre = torch.cat([d_b * b + gm * (1 - w), d_lfm * torch.sigmoid(-f_pre),
                          gc * b * (1 - zt * zt), d_og * og * (1 - og)], dim=-1)
        dpres.append(dpre)
        dc, dn, dm = gc * a, gn * a, d_lfm
        dh_next = torch.einsum("bhj,hjk->bhk", dpre.view(B, H, 4 * hd), rT).reshape(B, d)
    dxwb = torch.stack(dpres[::-1], dim=1)
    h_prev = torch.cat([zero[:, None], hs[:, :-1]], dim=1)
    dr = torch.einsum("bshk,bshj->hkj", h_prev.view(B, S, H, hd), dxwb.view(B, S, H, 4 * hd))
    return dxwb, dr


#: CUDA graphs of the two loops, captured once a process for each shape
_GRAPHS: dict = {}


def _run(fn, *inputs):
    """``fn(*inputs)``; on the card replayed from a CUDA graph of it,
    captured at the first call with the shape (the loops launch some 10^5
    small kernels, which the host would otherwise pace): the inputs copied
    into the graph's own, its outputs copied out."""
    if not inputs[0].is_cuda:
        return fn(*inputs)
    key = (fn.__name__,) + tuple((tuple(t.shape), t.dtype, t.device) for t in inputs)
    if key not in _GRAPHS:
        static = [t.clone() for t in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static)  # warm-up, outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*static)
        _GRAPHS[key] = (graph, static, out)
    graph, static, out = _GRAPHS[key]
    for s, t in zip(static, inputs):
        s.copy_(t)
    graph.replay()
    return tuple(o.clone() for o in out)


class SLSTMScan(torch.autograd.Function):
    """The scalar memory over positions from h = c = n = 0, m = -1e9, with
    its backward written out step by step (the adjoint of
    :func:`slstm_step` and of the recurrent product, in reverse order), so
    that a training step's reference builds no autograd graph of every
    position. The derivatives are those of the plain formulas:
    ``clamp_min(n, 1)`` passes the gradient where n >= 1, ``maximum``
    splits it on a tie."""

    @staticmethod
    def forward(ctx, xwb, r):
        hs, pres, cs, ns, ms = _run(_scan_forward, xwb.contiguous(), r.contiguous())
        ctx.save_for_backward(r, pres, hs, cs, ns, ms)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        r, pres, hs, cs, ns, ms = ctx.saved_tensors
        return _run(_scan_backward, r, pres, hs, cs, ns, ms, dhs.contiguous())


def slstm(P: Params, p: str, x: torch.Tensor, run: dict, prec: str) -> torch.Tensor:
    """The scalar memory (:class:`SLSTMScan`): the pre-activations of a
    position are ``x @ w_x + b`` plus the recurrent product of the h
    before, head j's slice of h times r[j] (its 4 hd results laid end to
    end along 4d), then split into the gates, as the configuration's
    equations lay them."""
    xwb = mm(x, P[p + "w_x"], prec) + P[p + "b"]
    return mm(SLSTMScan.apply(xwb, P[p + "r"]), P[p + "w_down"], prec)


_MIXERS = {"full": attention, "mlstm": mlstm, "slstm": slstm}


def layer(P: Params, i: int, kind: str, x: torch.Tensor, run: dict, prec: str) -> torch.Tensor:
    p = f"layers.{i}."
    mix = _MIXERS[kind]
    h = rms(x, P[p + "norm1.scale"], run["norm_eps"])
    x = held(x + mix(P, p + "mixer.", h, run, prec), prec)
    if run["d_ff"]:
        h = rms(x, P[p + "norm2.scale"], run["norm_eps"])
        x = held(x + swiglu(P, p + "ffn.", h, prec), prec)
    return x


def hidden(P: Params, run: dict, tokens: torch.Tensor, prec: str = "fp32",
           checkpoint: bool = False) -> torch.Tensor:
    """The final-normed hidden state (B, S, d) of ``tokens`` (B, S); with
    ``checkpoint`` each layer is recomputed in the backward, but an sLSTM
    layer, whose scan keeps its compact states instead."""
    x = held(P["embed"][tokens] * math.sqrt(run["d_model"]), prec)
    for i, kind in enumerate(kinds(run)):
        if checkpoint and kind != "slstm":
            x = torch.utils.checkpoint.checkpoint(layer, P, i, kind, x, run, prec,
                                                  use_reentrant=False)
        else:
            x = layer(P, i, kind, x, run, prec)
    return rms(x, P["final_norm.scale"], run["norm_eps"])


def logits_of(P: Params, run: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    """(..., vocab) logits of final-normed ``h``: the tied table's rows."""
    return mm(h, P["embed"][: run["vocab"]].t(), prec)


def last_logits(P: Params, run: dict, tokens: torch.Tensor, prec: str = "fp32"
                ) -> torch.Tensor:
    """(B, vocab) logits at each row's last position."""
    return logits_of(P, run, hidden(P, run, tokens, prec)[:, -1], prec)


def _xent_sum(P: Params, run: dict, h: torch.Tensor, targets: torch.Tensor,
              prec: str) -> torch.Tensor:
    logits = logits_of(P, run, h, prec)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def loss(P: Params, run: dict, tokens: torch.Tensor, targets: torch.Tensor,
         prec: str = "fp32", chunk: int = 256) -> torch.Tensor:
    """Mean next-token cross-entropy over every position, each layer and
    each ``chunk`` of positions' logits recomputed in the backward."""
    h = hidden(P, run, tokens, prec, checkpoint=True)
    total = h.new_zeros(())
    for s in range(0, h.shape[1], chunk):
        total = total + torch.utils.checkpoint.checkpoint(
            _xent_sum, P, run, h[:, s:s + chunk], targets[:, s:s + chunk], prec,
            use_reentrant=False)
    return total / targets.numel()
