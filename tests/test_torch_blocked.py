"""The port's blocked attention path vs the JAX package's, on the CPU.

``repro_torch.models.layers.blocked_attention_plain`` is the twin of the
JAX ``_blocked_attention`` (a Python loop over query and KV tiles with an
online softmax, skipping the tile pairs above the causal diagonal or
outside the window); ``blocked_attention`` runs it on CPU tensors and on
tensors that require grad, and the flash kernel on CUDA tensors that do
not. Here the twin is held to the JAX function on the same numpy inputs,
and the smoke yi-9b (full attention, GQA 4, untied head) and gemma3-4b
(sliding and full) models with ``attention_impl="blocked"`` to the JAX
model with the same config, weights carried by
``repro_torch.interop.model_from_jax`` with the norm scales perturbed
first (JAX initialises them to ones). The kernel branch is rehearsed with
the routing rule widened to CPU tensors, its launches counted in
``flash_attention_gqa``'s plain version.

Tolerances, as max |port - jax| / max |jax|: the twin 1e-5 (float32) and
2e-2 (bf16), the tolerances of the JAX package's flash tests; the models
as ``tests/test_torch_dense.py``: logits 1e-4, the loss 1e-5 relative,
every gradient leaf 1e-4 of its max |g| (float32).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jax_smoke
from repro.data import make_batch as jax_make_batch
from repro.distributed.sharding import make_plan
from repro.models import decode_step as jax_decode, init_params as jax_init
from repro.models import layers as JL, loss_fn as jax_loss, prefill as jax_prefill
from repro_torch.configs import get_smoke
from repro_torch.interop import leaves_to_jax, model_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import decode_step, loss_fn, param_leaves, prefill
from repro_torch.models import layers as TL
from torch_threads import one_thread

one_thread()

TWIN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
#: the smoke models' blocks: several tiles a sequence, pairs skipped
BLOCKS = {"attention_block_q": 16, "attention_block_kv": 32}


def rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def qkv(B, S, Hq, Hkv, D, dtype, seed=0):
    """q (B, S, Hq, D), k, v (B, S, Hkv, D) from numpy, rounded to
    ``dtype``, on both sides."""
    rng = np.random.default_rng(seed)
    ts = [torch.tensor(rng.standard_normal((B, S, h, D)), dtype=torch.float32)
          .to(getattr(torch, dtype)) for h in (Hq, Hkv, Hkv)]
    js = [jnp.asarray(t.float().numpy()).astype(dtype) for t in ts]
    return ts, js


# ---------------------------------------------------------------------------
# the twin against the JAX function
# ---------------------------------------------------------------------------

#: (S, Hq, Hkv, D, block_q, block_kv, window): GQA 1, 2 and 4, tiles of
#: unequal sizes that skip pairs above the diagonal, windows that skip whole
#: pairs and cut others, bq = S (a block_q past S), a window past S
TWIN_CASES = (
    (64, 4, 4, 16, 16, 32, None),
    (64, 4, 2, 16, 32, 16, None),
    (96, 8, 2, 32, 32, 32, 40),
    (128, 4, 1, 16, 16, 16, 24),
    (64, 2, 1, 8, 512, 16, None),
    (48, 4, 2, 16, 16, 48, 100),
)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("S,Hq,Hkv,D,bq,bkv,window", TWIN_CASES)
def test_twin_matches_jax_blocked_attention(S, Hq, Hkv, D, bq, bkv, window, dtype):
    (q, k, v), (jq, jk, jv) = qkv(2, S, Hq, Hkv, D, dtype, seed=S + Hq)
    jcfg = jax_smoke("yi-9b", dtype=dtype, attention_block_q=bq, attention_block_kv=bkv)
    want = JL._blocked_attention(jcfg, jq, jk, jv, window=window)
    tiles = TL._blocked_tiles(S, S, bq, bkv)  # min(block, S), as JAX takes them
    got = TL.blocked_attention_plain(q, k, v, window=window, bq=tiles[0], bkv=tiles[1])
    assert got.dtype == q.dtype and got.shape == (2, S, Hq, D)
    assert rel(got.float(), want) <= TWIN_TOL[dtype]
    # on CPU tensors the routed path is the twin itself
    routed = TL.blocked_attention(q, k, v, window=window, block_q=bq, block_kv=bkv)
    assert torch.equal(routed, got)


@pytest.mark.parametrize("S,bq,bkv", ((48, 32, 16), (64, 16, 24)))
def test_tiles_that_do_not_divide_raise_as_in_jax(S, bq, bkv):
    (q, k, v), (jq, jk, jv) = qkv(1, S, 2, 1, 8, "float32")
    jcfg = jax_smoke("yi-9b", attention_block_q=bq, attention_block_kv=bkv)
    with pytest.raises(ValueError) as want:
        JL._blocked_attention(jcfg, jq, jk, jv, window=None)
    # the routed path checks the tiles once, with the JAX message
    for call in (lambda: TL._blocked_tiles(S, S, bq, bkv),
                 lambda: TL.blocked_attention(q, k, v, window=None, block_q=bq,
                                              block_kv=bkv)):
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == str(want.value)


def test_routing_rule_reads_device_and_grad_only():
    """The kernel for CUDA operands none of which requires grad; the twin
    when any requires grad, and for CPU operands."""
    def t(device, grad=False):
        return types.SimpleNamespace(device=torch.device(device), requires_grad=grad)

    assert TL._on_kernel(t("cuda"), t("cuda"), t("cuda"))
    for grads in ((True, False, False), (False, True, False), (False, False, True)):
        assert not TL._on_kernel(*(t("cuda", g) for g in grads))
    assert not TL._on_kernel(t("cpu"), t("cpu"), t("cpu"))


def test_twin_gradients_match_jax():
    """The training path: autograd through the twin against ``jax.vjp`` of
    the JAX function, on a window that skips pairs."""
    (q, k, v), (jq, jk, jv) = qkv(2, 64, 4, 2, 16, "float32", seed=3)
    jcfg = jax_smoke("gemma3-4b", dtype="float32", attention_block_q=16,
                     attention_block_kv=16)
    g = np.random.default_rng(4).standard_normal((2, 64, 4, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: JL._blocked_attention(jcfg, a, b, c, window=24),
                     jq, jk, jv)
    want = vjp(jnp.asarray(g))
    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = TL.blocked_attention(*ts, window=24, block_q=16, block_kv=16)
    out.backward(torch.from_numpy(g))
    for x, w in zip(ts, want):
        assert rel(x.grad, w) <= 1e-5


# ---------------------------------------------------------------------------
# the smoke models with attention_impl="blocked"
# ---------------------------------------------------------------------------


def perturbed_scales(params, seed: int):
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key == "scale":
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, params)


class Blocked:
    """A smoke config with ``attention_impl="blocked"``: the JAX params and
    the port's model holding them."""

    def __init__(self, arch: str, trainable: bool = False, **over):
        over = dict(BLOCKS, attention_impl="blocked", dtype="float32", **over)
        self.jcfg = jax_smoke(arch, **over)
        self.cfg = get_smoke(arch, **over)
        self.plan = make_plan(None, n_heads=self.jcfg.n_heads,
                              n_kv_heads=self.jcfg.n_kv_heads)
        self.params = perturbed_scales(jax_init(self.jcfg, jax.random.PRNGKey(1)), 2)
        self.model = model_from_jax(self.cfg, jax.tree.map(np.asarray, self.params),
                                    device="cpu", trainable=trainable)


ARCHS = ("yi-9b", "gemma3-4b")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill 96 positions (past gemma3's smoke window of 64; six query
    tiles, three KV tiles) and 4 greedy decode steps, each side decoding
    its own argmax."""
    P = Blocked(arch)
    B, S, cache_len = 2, 96, 104
    toks = np.random.default_rng(5).integers(0, P.cfg.vocab, (B, S)).astype(np.int32)
    jc, jl = jax.jit(lambda p, b: jax_prefill(P.jcfg, P.plan, p, b, cache_len))(
        P.params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tc, tl = prefill(P.model, {"tokens": torch.from_numpy(toks).long()}, cache_len)
    assert rel(tl, jl) <= LOGITS_TOL
    step = jax.jit(lambda p, c, x: jax_decode(P.jcfg, P.plan, p, c, x))
    V = P.cfg.vocab
    for s in range(4):
        jt = np.argmax(np.asarray(jl)[:, -1, :V], -1)[:, None].astype(np.int32)
        tt = torch.argmax(tl[:, -1, :V], -1)[:, None]
        assert (tt.numpy() == jt).all(), s
        jc, jl = step(P.params, jc, jnp.asarray(jt))
        with torch.no_grad():
            tc, tl = decode_step(P.model, tc, tt)
        assert rel(tl, jl) <= LOGITS_TOL, s


@pytest.mark.parametrize("remat", ("none", "full"))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, remat):
    """``loss_fn`` and every gradient (yi-9b's ``head`` included) against
    ``jax.value_and_grad`` of the JAX loss on the blocked path, S 96 in
    chunks of 32; with ``remat="full"`` each unit is recomputed under
    ``torch.utils.checkpoint`` and takes the twin both times."""
    c = Blocked(arch, trainable=True, logits_chunk=32, remat=remat)
    batch = jax_make_batch(c.jcfg, 96, 2, seed=6)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_loss(
        c.jcfg, c.plan, p, {k: jnp.asarray(v) for k, v in batch.items()})))(c.params)
    got = loss_fn(c.model, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(loss)) <= LOSS_TOL * abs(float(loss))
    port = leaves_to_jax({k: [p.grad for p in ps] for k, ps in param_leaves(c.model).items()})
    jl = jax.tree_util.tree_flatten_with_path(grads)[0]
    pl = jax.tree_util.tree_flatten_with_path(port)[0]
    assert [p for p, _ in jl] == [p for p, _ in pl]
    assert ("head" in port) == (arch == "yi-9b")
    for (path, want), (_, g) in zip(jl, pl):
        assert rel(g, want) <= GRAD_TOL, jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# the kernel branch, rehearsed on the CPU
# ---------------------------------------------------------------------------


def count_flash_calls(monkeypatch):
    """Widen the routing rule to CPU tensors (grad still takes the twin)
    and record each ``flash_attention_gqa`` call: its operands' shapes,
    contiguity and keywords. The wrapper then runs its plain version."""
    calls = []
    real = ops.flash_attention_gqa

    def recording(q, k, v, **kw):
        calls.append({"shapes": (tuple(q.shape), tuple(k.shape)), "kw": kw,
                      "contiguous": all(t.is_contiguous() for t in (q, k, v))})
        return real(q, k, v, **kw)

    monkeypatch.setattr(TL, "_on_kernel", lambda q, k, v: not (
        q.requires_grad or k.requires_grad or v.requires_grad))
    monkeypatch.setattr(TL.kops, "flash_attention_gqa", recording)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_branch_once_per_layer_a_prefill(arch, monkeypatch):
    """With the kernel branch taken, a prefill calls ``flash_attention_gqa``
    once per attention layer on heads-first contiguous copies, with the
    layer's window and the JAX tiles, and a decode step not at all; its
    logits agree with the twin's (the kernel's plain version materialises
    the scores: float32 within 1e-5)."""
    P = Blocked(arch)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, P.cfg.vocab, (2, 64)).astype(np.int64))
    with torch.inference_mode():
        _, twin = serve.generate(P.model, toks, 2)
        calls = count_flash_calls(monkeypatch)
        out, rec = serve.generate(P.model, toks, 2)
    n = P.cfg.n_layers
    assert len(calls) == n
    cfg = P.cfg
    hd = cfg.resolved_head_dim
    assert all(c["contiguous"] for c in calls)
    assert {c["shapes"] for c in calls} == {((2, cfg.n_heads, 64, hd),
                                             (2, cfg.n_kv_heads, 64, hd))}
    windows = [c["kw"]["window"] for c in calls]
    assert windows == [layer.mixer.window for layer in P.model.layers]
    assert {(c["kw"]["block_q"], c["kw"]["block_k"]) for c in calls} == {(16, 32)}
    assert all(c["kw"]["causal"] for c in calls)
    # on the CPU the wrapper counts no launch: its plain version ran
    assert rec["prefill_kernel_launches"]["flash_attention"] == 0
    assert rel(rec["logits"], twin["logits"]) <= 1e-5


def test_training_takes_the_twin_even_where_the_kernel_would_run(monkeypatch):
    """Parameters that require grad make q, k, v require grad: the twin
    runs (forward and the checkpoint's recompute), never the kernel."""
    c = Blocked("yi-9b", trainable=True, logits_chunk=32, remat="full")
    calls = count_flash_calls(monkeypatch)
    batch = jax_make_batch(c.jcfg, 64, 2, seed=8)
    loss = loss_fn(c.model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert calls == [] and torch.isfinite(loss)
    with torch.no_grad():  # the same trainable model, evaluated: the kernel
        loss_fn(c.model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(calls) == c.cfg.n_layers

