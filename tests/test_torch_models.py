"""Port's recurrentgemma-2b serving path vs the JAX model, on the CPU.

Weights come from the JAX package's ``init_params`` on the smoke config
(one (rglru, rglru, sliding) unit) and on ``n_layers=5`` (the unit plus a
two-layer rglru tail, as the full config has), carried across by
``repro_torch.interop.model_from_jax``; token inputs are made with numpy.
The reference is the JAX model under its default ``attention_impl="xla"``
(its RG-LRU runs the associative-scan ``rglru_scan_ref``; the Pallas path
does not run under the installed jax). The port's RG-LRU runs
``kernels.ops.rglru_scan``, whose plain version runs on CPU tensors.

Tolerances, as max |port - jax| / max |jax|: in float32, 1e-5 per layer
and 1e-4 for the whole model (the summation orders of the two frameworks'
matrix products and scans differ in the last bits), with greedy tokens
identical; in bfloat16, 5e-2 (the bound ``tests/test_models.py`` holds
prefill to against the full forward).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config, get_smoke as jax_smoke
from repro.distributed.sharding import make_plan
from repro.models import decode_step as jax_decode, init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import layers as JL, prefill as jax_prefill
from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import cache_to_jax, model_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import Model, decode_step, init_cache, init_params, prefill
from repro_torch.models.model import backbone
from repro_torch.models import layers as TL
from torch_threads import one_thread

one_thread()

ARCH = "recurrentgemma-2b"
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LAYER_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DTYPES = ("float32", "bfloat16")


def rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


class Pair:
    """One config's JAX params and the port model holding the same weights."""

    def __init__(self, n_layers: int, dtype: str, seed: int = 0):
        self.jcfg = jax_smoke(ARCH, n_layers=n_layers, dtype=dtype)
        self.cfg = get_smoke(ARCH, n_layers=n_layers, dtype=dtype)
        self.plan = make_plan(None, n_heads=self.jcfg.n_heads,
                              n_kv_heads=self.jcfg.n_kv_heads)
        self.params = jax_init(self.jcfg, jax.random.PRNGKey(seed))
        self.model = model_from_jax(self.cfg, jax.tree.map(np.asarray, self.params),
                                    device="cpu")
        self.dt = getattr(torch, dtype)

    def layer_params(self, p: int):
        """Pattern position p's params of the first unit (JAX)."""
        return jax.tree.map(lambda a: a[0], self.params["units"][f"p{p}"])

    def x(self, B, S, seed=0):
        """A residual-stream input in the compute dtype, on both sides."""
        x = np.random.default_rng(seed).standard_normal((B, S, self.cfg.d_model))
        xt = torch.tensor(x, dtype=torch.float32).to(self.dt)
        return jnp.asarray(xt.float().numpy()).astype(self.jcfg.dtype), xt


_PAIRS = {}


def pair(n_layers: int, dtype: str) -> Pair:
    key = (n_layers, dtype)
    if key not in _PAIRS:
        _PAIRS[key] = Pair(n_layers, dtype)
    return _PAIRS[key]


def tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# per layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    P = pair(3, dtype)
    jx, tx = P.x(2, 16)
    scale = np.random.default_rng(1).uniform(0.5, 1.5, P.cfg.d_model).astype(np.float32)
    norm = TL.RMSNorm(P.cfg.d_model, P.cfg.norm_eps)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        got = norm(tx)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jx, P.cfg.norm_eps)
    assert got.dtype == P.dt
    assert rel(got.float(), want) <= LAYER_TOL[dtype]


def test_rope_table_and_apply():
    cfg = get_smoke(ARCH, dtype="float32")
    hd = cfg.resolved_head_dim
    pos = np.arange(40) * 3
    jc, js = JL.rope_table(jnp.asarray(pos), hd, cfg.rope_theta)
    tc, ts = TL.rope_table(torch.from_numpy(pos), hd, cfg.rope_theta)
    assert rel(tc, jc) <= 1e-5 and rel(ts, js) <= 1e-5
    x = np.random.default_rng(2).standard_normal((2, 40, 3, hd)).astype(np.float32)
    want = JL.apply_rope(jnp.asarray(x), jc, js)
    got = TL.apply_rope(torch.from_numpy(x), tc, ts)
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cache_len", (80, 32))
def test_attention_apply_past_the_window(dtype, cache_len):
    """S = 64 > window 32: the sliding mask, and the decode cache as prefill
    builds it (padded to cache_len 80; a 32-slot ring buffer)."""
    P = pair(3, dtype)
    jx, tx = P.x(2, 64, seed=3)
    window = P.cfg.window
    assert 64 > window
    jy, jst = JL.attention_apply(P.layer_params(2)["mixer"], P.jcfg, P.plan, jx,
                                 window=window, return_state=True, cache_len=cache_len)
    with torch.no_grad():
        ty, tst = P.model.layers[2].mixer(tx, return_state=True, cache_len=cache_len)
    tol = LAYER_TOL[dtype]
    assert rel(ty.float(), jy) <= tol
    for k in ("k", "v"):
        assert tst[k].shape == (2, cache_len, 1, P.cfg.resolved_head_dim)
        assert rel(tst[k].float(), jst[k]) <= tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cache_len", (80, 32))
def test_attention_decode_on_the_ring_buffer(dtype, cache_len):
    """Four decode steps after a 64-token prefill: a padded cache, and a
    32-slot ring that wraps (slot = pos mod L, the valid mask by age)."""
    P = pair(3, dtype)
    jx, tx = P.x(2, 64, seed=4)
    jp = P.layer_params(2)["mixer"]
    attn = P.model.layers[2].mixer
    window = P.cfg.window
    _, jc = JL.attention_apply(jp, P.jcfg, P.plan, jx, window=window,
                               return_state=True, cache_len=cache_len)
    with torch.no_grad():
        _, tc = attn(tx, return_state=True, cache_len=cache_len)
    for step in range(4):
        jxs, txs = P.x(2, 1, seed=10 + step)
        pos = 64 + step
        jy, jc = JL.attention_decode(jp, P.jcfg, P.plan, jxs, jc, jnp.asarray(pos, jnp.int32),
                                     window=window)
        with torch.no_grad():
            ty, tc = attn.decode(txs, tc, pos)
        tol = LAYER_TOL[dtype]
        assert rel(ty.float(), jy) <= tol, step
        for k in ("k", "v"):
            assert rel(tc[k].float(), jc[k]) <= tol, (step, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu(dtype):
    P = pair(3, dtype)
    jx, tx = P.x(2, 16, seed=5)
    want = JL.swiglu_apply(P.layer_params(0)["ffn"], P.jcfg, P.plan, jx)
    with torch.no_grad():
        got = P.model.layers[0].ffn(tx)
    assert rel(got.float(), want) <= LAYER_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_apply_and_decode(dtype):
    P = pair(3, dtype)
    jx, tx = P.x(2, 48, seed=6)
    jp = P.layer_params(1)["mixer"]
    rglru = P.model.layers[1].mixer
    jy, jst = JL.rglru_apply(jp, P.jcfg, P.plan, jx, return_state=True)
    with torch.no_grad():
        ty, tst = rglru(tx, return_state=True)
    tol = LAYER_TOL[dtype]
    assert rel(ty.float(), jy) <= tol
    assert tst["h"].dtype == torch.float32 and rel(tst["h"], jst["h"]) <= tol
    for step in range(3):
        jxs, txs = P.x(2, 1, seed=20 + step)
        jy, jst = JL.rglru_decode(jp, P.jcfg, P.plan, jxs, jst)
        with torch.no_grad():
            ty, tst = rglru.decode(txs, tst, 48 + step)
        assert rel(ty.float(), jy) <= tol, step
        assert rel(tst["h"], jst["h"]) <= tol, step


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_layers", (3, 5))
def test_prefill_and_greedy_decode_match_jax(n_layers, dtype):
    """Prefill logits and the cache leaf by leaf, then 8 greedy decode steps:
    in float32 each side decodes its own argmax and the tokens must be
    identical; in bf16 both are fed the JAX tokens and their logits held."""
    P = pair(n_layers, dtype)
    tol = MODEL_TOL[dtype]
    B, S, cache_len = 2, 64, 80
    toks = tokens(B, S, P.cfg.vocab, seed=n_layers)
    jc, jl = jax.jit(lambda p, b: jax_prefill(P.jcfg, P.plan, p, b, cache_len))(
        P.params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tc, tl = prefill(P.model, {"tokens": torch.from_numpy(toks).long()}, cache_len)
    assert tl.shape == (B, 1, P.cfg.padded_vocab)
    assert rel(tl.float(), jl) <= tol
    jleaves = leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), jc))
    tleaves = leaves(cache_to_jax(P.model, tc))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        assert a.shape == b.shape, path
        assert rel(b, a) <= tol, jax.tree_util.keystr(path)

    step = jax.jit(lambda p, c, x: jax_decode(P.jcfg, P.plan, p, c, x))
    V = P.cfg.vocab
    jt = np.argmax(np.asarray(jl, np.float32)[:, -1, :V], -1)[:, None].astype(np.int32)
    tt = torch.argmax(tl[:, -1, :V], -1)[:, None]
    for s in range(8):
        if dtype == "float32":
            assert (tt.numpy() == jt).all(), s
        else:
            tt = torch.from_numpy(jt).long()
        jc, jl = step(P.params, jc, jnp.asarray(jt))
        with torch.no_grad():
            tc, tl = decode_step(P.model, tc, tt)
        assert rel(tl.float(), jl) <= tol, s
        jt = np.argmax(np.asarray(jl, np.float32)[:, -1, :V], -1)[:, None].astype(np.int32)
        tt = torch.argmax(tl[:, -1, :V], -1)[:, None]
    assert tc["pos"] == S + 8 == int(jc["pos"])


@pytest.mark.parametrize("dtype,tol", (("bfloat16", 0.05), ("float32", 1e-4)))
def test_prefill_and_decode_match_own_full_forward(dtype, tol):
    """As ``tests/test_models.py`` checks the JAX model: prefill on S - 1
    tokens and one decode step give the full forward's last two logits."""
    P = pair(5, dtype)
    B, S = 2, 33
    toks = torch.from_numpy(tokens(B, S, P.cfg.vocab, seed=9)).long()
    with torch.no_grad():
        full = P.model(toks).float()
        cache, lg_pre = prefill(P.model, {"tokens": toks[:, :-1]}, cache_len=S + 8)
        _, lg_dec = decode_step(P.model, cache, toks[:, -1:])
    assert rel(lg_pre[:, 0].float(), full[:, -2]) < tol
    assert rel(lg_dec[:, 0].float(), full[:, -1]) < tol


@pytest.mark.parametrize("impl", ("xla", "pallas"))
def test_every_rglru_prefill_goes_through_the_kernel_wrapper(monkeypatch, impl):
    """``attention_impl`` selects no scan: every RG-LRU layer calls
    ``kernels.ops.rglru_scan``, and the decode steps call it never."""
    cfg = get_smoke(ARCH, n_layers=5, attention_impl=impl)
    model = model_from_jax(cfg, jax.tree.map(np.asarray, pair(5, "bfloat16").params),
                           device="cpu")
    calls = []
    real = ops.rglru_scan

    def counting(a, b, h0):
        calls.append(a.shape)
        return real(a, b, h0)

    monkeypatch.setattr(ops, "rglru_scan", counting)
    toks = torch.from_numpy(tokens(1, 16, cfg.vocab, seed=2)).long()
    with torch.no_grad():
        cache, _ = prefill(model, {"tokens": toks}, cache_len=24)
        assert len(calls) == model.kinds.count("rglru") == 4
        decode_step(model, cache, toks[:, -1:])
    assert len(calls) == 4


def test_init_cache_matches_jax_shapes():
    P = pair(5, "bfloat16")
    want = leaves(jax_init_cache(P.jcfg, P.plan, 3, 40))
    got = leaves(cache_to_jax(P.model, init_cache(P.model, 3, 40)))
    assert [(p, np.shape(a)) for p, a in want] == [(p, a.shape) for p, a in got]
    assert all(not np.any(a) for _, a in got)


def test_full_config_has_the_jax_shapes():
    """At full width (built on the meta device, nothing allocated): 18 RG-LRU
    and 8 sliding layers, every weight of the JAX model's shape."""
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config(ARCH))
    model = Model(cfg, device="meta")
    assert model.kinds.count("rglru") == 18 and model.kinds.count("sliding") == 8
    shapes = jax.eval_shape(lambda: jax_init(jax_config(ARCH), jax.random.PRNGKey(0)))
    P = len(cfg.pattern)
    for i, layer in enumerate(model.layers):
        unit, p = divmod(i, P)
        sub = (shapes["units"][f"p{p}"] if unit < cfg.n_units
               else shapes["tail"][i - cfg.n_units * P])
        for name, prm in layer.named_parameters():
            leaf = sub
            for k in name.split("."):
                leaf = leaf[k]
            want = leaf.shape[1:] if unit < cfg.n_units else leaf.shape
            assert tuple(prm.shape) == tuple(want), (i, name)
    assert tuple(model.embed.shape) == shapes["embed"].shape
    n = sum(p.numel() for p in model.parameters())
    assert 2.6e9 < n < 3.0e9
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[0].mixer.w_a.dtype == torch.float32


# ---------------------------------------------------------------------------
# what the port refuses, and the launcher
# ---------------------------------------------------------------------------


def test_blocked_attention_and_unported_archs_raise():
    """Nothing here is refused any more (the name is kept): the blocked
    path, the encoder and sinusoidal positions build, and since the
    checkpoint policies were ported the ``dots`` backbone runs."""
    Model(get_smoke(ARCH, attention_impl="blocked"))
    Model(get_smoke("whisper-tiny"))
    Model(get_smoke("qwen2-1.5b", encoder_layers=2, rope_theta=0.0))
    cfg = get_smoke("yi-9b", remat="dots")
    model = init_params(cfg, torch.Generator().manual_seed(0))
    h, aux = backbone(model, torch.zeros((1, 8, cfg.d_model), dtype=getattr(torch, cfg.dtype)))
    assert h.shape == (1, 8, cfg.d_model) and aux == 0


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "40",
         "--decode-steps", "6"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "prefill 2x40" in out and "decode 6 steps" in out
    # CPU tensors run the plain version: no kernel launch
    assert "rglru_scan kernel launches: prefill 0, decode 0" in out
    assert out.count("  seq") == 2


def test_serve_cli_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--smoke"])


def test_model_from_jax_without_a_gpu_raises(monkeypatch):
    """Carried weights land on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = jax.tree.map(np.asarray, pair(3, "bfloat16").params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_from_jax(get_smoke(ARCH), params)


def test_generate_matches_prefill_and_decode():
    """The launcher's loop is prefill, then argmax-fed decode steps."""
    P = pair(3, "float32")
    toks = torch.from_numpy(tokens(2, 20, P.cfg.vocab, seed=4)).long()
    with torch.inference_mode():
        out, rec = serve.generate(P.model, toks, 3)
        cache, lg = prefill(P.model, {"tokens": toks}, cache_len=20 + 3 + 8)
        want = [torch.argmax(lg[:, -1, :P.cfg.vocab], -1)[:, None]]
        for _ in range(3):
            cache, lg = decode_step(P.model, cache, want[-1])
            want.append(torch.argmax(lg[:, -1, :P.cfg.vocab], -1)[:, None])
    assert out.shape == (2, 4)
    assert torch.equal(out, torch.cat(want, 1))
    assert rec["prefill_launches"] == rec["decode_launches"] == 0


def test_chip_smoke_serve_phases_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phases 11-12 on the CPU at the smoke widths with
    ``n_layers=5``: the plain scan stands in for the kernel and counts as
    its launch on the route ``_route`` names, the card's memory counters
    and the profiler are stubbed. Their checks must pass: 4 RG-LRU launches
    a prefill (one per RG-LRU layer), all on the TMA route, none in decode
    and no other kernel, a second run identical, card (here the CPU)
    against the CPU."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import rglru_scan as rg

    plain = rg.rglru_scan_plain

    def counted(a, b, h0):
        rg.rglru_scan.launches += 1
        rg.rglru_scan.launches_tma += rg._route(
            a.dtype, a.shape[-1], [a.data_ptr(), b.data_ptr()]) == rg.TMA
        return plain(a, b, h0)

    monkeypatch.setattr(rg, "rglru_scan_plain", counted)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "device_kernels", lambda torch, fn: (fn(), [])[1])
    monkeypatch.setattr(cs, "SERVE_SHAPE", (2, 40, 4))
    detail = {}
    launches = cs.serve_phase(torch, rg, detail, {"kernel_ms": 1.0}, dev="cpu",
                              cfg=get_smoke(ARCH, n_layers=5))
    out = detail[f"serve_{ARCH}"]
    assert launches == out["launches_tma"] == out["prefill_launches"] == 4
    assert out["decode_launches"] == 0 and out["kernel_launches"]["rglru_scan"] == 4
    cs.devices_phase(torch, rg, detail, dev="cpu",
                     cfg_of=lambda dtype: get_smoke(ARCH, n_layers=5, dtype=dtype))
    rec = detail[f"card_vs_cpu_{ARCH}"]
    assert rec["float32"]["tokens_equal"] and rec["float32"]["rel_err"] == 0.0
    assert rec["bfloat16"]["launches"] == 4
