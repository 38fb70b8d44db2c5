"""The port's dense-attention tenants, qwen2-1.5b and gemma3-4b, vs the JAX
model on the CPU.

qwen2-1.5b is full attention with the QKV bias and a padded vocabulary;
gemma3-4b is the 5:1 sliding / full pattern with a ``head_dim`` of its own
and ``microbatches=2``. Weights come from the JAX package's ``init_params``
on the smoke configs and are carried across by
``repro_torch.interop.model_from_jax``; inputs are made with numpy. Before
they are carried, the QKV biases and the norm scales are set to seeded
random values, since JAX initialises them to zeros and ones, which would
hide a bias or a scale applied in the wrong place. The reference is the
JAX model under ``attention_impl="xla"``, which runs no Pallas kernel on
these paths (its attention is the grouped einsum, its loss the jnp
``_chunked_xent``).

Besides the smoke configs, two overrides expose what they would hide:
``head_dim`` such that ``n_heads * head_dim != d_model``, and a ``vocab``
that is not a multiple of the padding, so that ``padded_vocab != vocab``.
gemma3-4b's sequences are longer than its smoke window (64), so the
sliding and the full masks differ.

Tolerances are those of the recurrentgemma-2b tests
(``tests/test_torch_models.py``, ``tests/test_torch_train.py``), as
max |port - jax| / max |jax|: layers 1e-5 (float32) / 5e-2 (bf16), the
model 1e-4 / 5e-2 with float32 greedy tokens identical; the loss 1e-6 /
1e-4 relative and every gradient leaf 1e-5 / 5e-2; the train step as
there; costs exactly equal (pure Python); checkpoints bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.manager import _flatten as jax_flatten
from repro.configs import get_config as jax_config, get_smoke as jax_smoke
from repro.data import make_batch as jax_make_batch
from repro.distributed.sharding import make_plan
from repro.models import costs as jax_costs
from repro.models import decode_step as jax_decode, init_cache as jax_init_cache
from repro.models import init_params as jax_init, loss_fn as jax_loss
from repro.models import layers as JL, prefill as jax_prefill
from repro.models.config import SHAPE_CELLS as JAX_CELLS, ShapeCell as JaxCell
from repro.optim import make_optimizer as jax_make_optimizer
from repro.runtime import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro.runtime import TrainState as JaxTrainState, make_train_step as jax_train_step
from repro_torch.checkpoint import flatten, load_arrays
from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import cache_to_jax, leaves_to_jax, model_from_jax
from repro_torch.launch import serve, train as train_cli
from repro_torch.models import (Model, costs, decode_step, init_cache, init_params,
                                loss_fn, param_leaves, prefill)
from repro_torch.models.config import SHAPE_CELLS, ShapeCell
from repro_torch.optim import make_optimizer
from repro_torch.runtime import Trainer, TrainerConfig, TrainState, make_train_step
from torch_threads import one_thread

one_thread()

ARCHS = ("qwen2-1.5b", "gemma3-4b")
LAYER_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
LR = 1e-3
#: the overrides of the smoke configs: n_heads * head_dim != d_model, and
#: a vocab that is not a multiple of 256 (padded_vocab != vocab)
OVERRIDES = {"none": {}, "head_dim": {"head_dim": 24}, "vocab": {"vocab": 500}}


def rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def perturbed(params, seed: int):
    """The JAX params with the QKV biases and the norm scales drawn at
    random (JAX initialises them to zeros and ones)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = path[-1].key
        if key in ("bq", "bk", "bv"):
            return jnp.asarray(rng.standard_normal(a.shape) * 0.2, a.dtype)
        if key == "scale":
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, params)


class Dense:
    """One smoke config's JAX params (biases and scales perturbed) and the
    port's model holding the same weights."""

    def __init__(self, arch: str, dtype: str = "float32", seed: int = 0,
                 trainable: bool = False, **over):
        self.jcfg = jax_smoke(arch, dtype=dtype, **over)
        self.cfg = get_smoke(arch, dtype=dtype, **over)
        self.plan = make_plan(None, n_heads=self.jcfg.n_heads,
                              n_kv_heads=self.jcfg.n_kv_heads)
        self.params = perturbed(jax_init(self.jcfg, jax.random.PRNGKey(seed)), seed + 1)
        self.model = model_from_jax(self.cfg, jax.tree.map(np.asarray, self.params),
                                    device="cpu", trainable=trainable)
        self.dt = getattr(torch, dtype)

    def layer(self, kind: str):
        """The first unit's layer of ``kind``: its JAX params and the port's
        ``Block``."""
        p = self.cfg.pattern.index(kind)
        return (jax.tree.map(lambda a: a[0], self.params["units"][f"p{p}"]),
                self.model.layers[p])

    def x(self, B, S, seed=0):
        """A residual-stream input in the compute dtype, on both sides."""
        x = np.random.default_rng(seed).standard_normal((B, S, self.cfg.d_model))
        xt = torch.tensor(x, dtype=torch.float32).to(self.dt)
        return jnp.asarray(xt.float().numpy()).astype(self.jcfg.dtype), xt


_DENSE = {}


def dense(arch: str, dtype: str = "float32", over: str = "none") -> Dense:
    key = (arch, dtype, over)
    if key not in _DENSE:
        _DENSE[key] = Dense(arch, dtype, **OVERRIDES[over])
    return _DENSE[key]


def tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def leaf_errors(port_tree, jax_tree):
    jl = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    pl = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in pl]
    return {jax.tree_util.keystr(p): rel(b, a) for (p, a), (_, b) in zip(jl, pl)}


# ---------------------------------------------------------------------------
# configs and shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_configs(arch):
    for port, ref in ((get_config(arch), jax_config(arch)), (get_smoke(arch), jax_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_has_the_jax_shapes(arch):
    """At full width on the meta device (nothing allocated): every weight of
    the JAX model at its shape, the layer kinds and windows of the JAX
    pattern, and ``param_count`` (which leaves out the final norm)."""
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    shapes = jax.eval_shape(lambda: jax_init(jax_config(arch), jax.random.PRNGKey(0)))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {k: tuple(ps[0].shape) if "units" not in k else (len(ps),) + tuple(ps[0].shape)
           for k, ps in param_leaves(model).items()}
    assert got == want
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() + cfg.d_model
    windows = [layer.mixer.window for layer in model.layers]
    if arch == "qwen2-1.5b":
        assert model.kinds == ["full"] * 28 and windows == [None] * 28
        assert cfg.padded_vocab == 152064 != cfg.vocab
        assert model.layers[0].mixer.bq.shape == (12 * 128,)
    else:
        unit = ["sliding"] * 5 + ["full"]
        assert model.kinds == unit * 5 + ["sliding"] * 4
        assert windows == ([1024] * 5 + [None]) * 5 + [1024] * 4
        assert cfg.n_heads * cfg.resolved_head_dim == 2048 != cfg.d_model
        assert model.layers[0].mixer.bq is None
    assert model.embed.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax_shapes(arch):
    P = dense(arch, "bfloat16")
    want = jax.tree_util.tree_leaves_with_path(jax_init_cache(P.jcfg, P.plan, 3, 40))
    got = jax.tree_util.tree_leaves_with_path(cache_to_jax(P.model, init_cache(P.model, 3, 40)))
    assert [(p, np.shape(a)) for p, a in want] == [(p, a.shape) for p, a in got]
    assert all(not np.any(a) for _, a in got)


def test_bias_init_is_zero_and_draws_nothing():
    """``init_params`` sets the QKV biases to zero and draws nothing for
    them: a seed gives the same other weights with and without the bias."""
    cfg = get_smoke("qwen2-1.5b")
    a = init_params(cfg, torch.Generator().manual_seed(5), trainable=True)
    b = init_params(dataclasses.replace(cfg, qkv_bias=False),
                    torch.Generator().manual_seed(5), trainable=True)
    named = dict(b.named_parameters())
    for name, p in a.named_parameters():
        if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
            assert p.dtype == torch.float32 and not p.any(), name
        else:
            assert torch.equal(p, named.pop(name)), name
    assert not named


# ---------------------------------------------------------------------------
# attention, per layer
# ---------------------------------------------------------------------------

#: (arch, layer kind, prompt length, cache length): a full layer's cache
#: padded past the prompt, exactly the prompt, and shorter than the prompt
#: (decode writes past its end); a sliding layer's padded cache and its
#: ring of ``window`` slots
ATTN_CASES = (("qwen2-1.5b", "full", 64, 80), ("qwen2-1.5b", "full", 64, 64),
              ("qwen2-1.5b", "full", 64, 48), ("gemma3-4b", "full", 128, 140),
              ("gemma3-4b", "full", 128, 100), ("gemma3-4b", "sliding", 128, 140),
              ("gemma3-4b", "sliding", 128, 64))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch,kind,S,cache_len", ATTN_CASES)
def test_attention_apply_and_decode_match_jax(arch, kind, S, cache_len, dtype):
    """``attention_apply`` with its decode cache, then four
    ``attention_decode`` steps, with nonzero QKV biases (qwen2)."""
    P = dense(arch, dtype)
    jp, block = P.layer(kind)
    attn = block.mixer
    window = P.cfg.window if kind == "sliding" else None
    assert attn.window == window and (attn.bq is not None) == P.cfg.qkv_bias
    jx, tx = P.x(2, S, seed=3)
    jy, jc = JL.attention_apply(jp["mixer"], P.jcfg, P.plan, jx, window=window,
                                return_state=True, cache_len=cache_len)
    with torch.no_grad():
        ty, tc = attn(tx, return_state=True, cache_len=cache_len)
    tol = LAYER_TOL[dtype]
    assert rel(ty.float(), jy) <= tol
    for k in ("k", "v"):
        assert tc[k].shape == (2, cache_len, P.cfg.n_kv_heads, P.cfg.resolved_head_dim)
        assert rel(tc[k].float(), jc[k]) <= tol, k
    for step in range(4):
        jxs, txs = P.x(2, 1, seed=10 + step)
        pos = S + step
        jy, jc = JL.attention_decode(jp["mixer"], P.jcfg, P.plan, jxs, jc,
                                     jnp.asarray(pos, jnp.int32), window=window)
        with torch.no_grad():
            ty, tc = attn.decode(txs, tc, pos)
        assert rel(ty.float(), jy) <= tol, step
        for k in ("k", "v"):
            assert rel(tc[k].float(), jc[k]) <= tol, (step, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_init_lengths(arch):
    """A full layer's cache holds ``max_len`` slots, a sliding layer's
    ``min(window, max_len)``, as ``attention_cache_init``."""
    P = dense(arch)
    for max_len in (40, 100):
        for kind in set(P.cfg.pattern):
            jp, block = P.layer(kind)
            window = P.cfg.window if kind == "sliding" else None
            want = JL.attention_cache_init(P.jcfg, P.plan, 2, max_len, window=window)
            got = block.mixer.cache_init(2, max_len)
            assert {k: v.shape for k, v in want.items()} == {
                k: tuple(v.shape) for k, v in got.items()}, (kind, max_len)


# ---------------------------------------------------------------------------
# the whole model: serving
# ---------------------------------------------------------------------------

MODEL_CASES = [(a, d, "none") for a in ARCHS for d in ("float32", "bfloat16")] + [
    (a, "float32", o) for a in ARCHS for o in ("head_dim", "vocab")]


@pytest.mark.parametrize("arch,dtype,over", MODEL_CASES)
def test_prefill_and_greedy_decode_match_jax(arch, dtype, over):
    """Prefill logits and the cache leaf by leaf on S = 80 (past gemma3's
    smoke window), then 8 greedy decode steps with a cache of 84 slots, so
    that the full layers' caches run past their end: in float32 each side
    decodes its own argmax and the tokens must be identical; in bf16 both
    are fed the JAX tokens and their logits held."""
    P = dense(arch, dtype, over)
    tol = MODEL_TOL[dtype]
    B, S, cache_len = 2, 80, 84
    toks = tokens(B, S, P.cfg.vocab, seed=7)
    jc, jl = jax.jit(lambda p, b: jax_prefill(P.jcfg, P.plan, p, b, cache_len))(
        P.params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tc, tl = prefill(P.model, {"tokens": torch.from_numpy(toks).long()}, cache_len)
    assert tl.shape == (B, 1, P.cfg.padded_vocab)
    assert rel(tl.float(), jl) <= tol
    jleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jc))
    tleaves = jax.tree_util.tree_leaves_with_path(cache_to_jax(P.model, tc))
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
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_own_full_forward(arch, dtype, tol):
    """As ``tests/test_models.py`` checks the JAX model: prefill on S - 1
    tokens and one decode step give the full forward's last two logits."""
    P = dense(arch, dtype)
    B, S = 2, 81
    toks = torch.from_numpy(tokens(B, S, P.cfg.vocab, seed=9)).long()
    with torch.no_grad():
        full = P.model(toks).float()
        cache, lg_pre = prefill(P.model, {"tokens": toks[:, :-1]}, cache_len=S + 8)
        _, lg_dec = decode_step(P.model, cache, toks[:, -1:])
    assert rel(lg_pre[:, 0].float(), full[:, -2]) < tol
    assert rel(lg_dec[:, 0].float(), full[:, -1]) < tol


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_launches_no_kernel(arch):
    """The launcher's record counts every kernel wrapper; these models
    launch none (on the CPU no wrapper launches, so this holds the record's
    keys and the loop)."""
    P = dense(arch)
    toks = torch.from_numpy(tokens(2, 20, P.cfg.vocab, seed=4)).long()
    with torch.inference_mode():
        out, rec = serve.generate(P.model, toks, 3)
    assert out.shape == (2, 4) and bool(((out >= 0) & (out < P.cfg.vocab)).all())
    for phase in ("prefill", "decode"):
        counts = rec[f"{phase}_kernel_launches"]
        assert "rglru_scan" in counts and "flash_attention" in counts
        assert not any(counts.values())
    assert rec["prefill_launches"] == rec["decode_launches"] == 0


# ---------------------------------------------------------------------------
# the loss, every gradient, the train step
# ---------------------------------------------------------------------------

LOSS_CASES = [(a, d, c, "none") for a in ARCHS for d in ("float32", "bfloat16")
              for c in (0, 16)] + [(a, "float32", 16, o) for a in ARCHS
                                   for o in ("head_dim", "vocab")]


@pytest.mark.parametrize("arch,dtype,chunk,over", LOSS_CASES)
def test_loss_and_every_gradient_match_jax(arch, dtype, chunk, over):
    """``loss_fn`` and the gradient of every parameter (the QKV biases and
    norm scales included) against ``jax.value_and_grad(loss_fn)``: dense
    logits and chunks of 16 over S = 72 (past gemma3's window; not a
    multiple of the chunk: the zero-padded tail is weighted out)."""
    c = Dense(arch, dtype, trainable=True, logits_chunk=chunk, **OVERRIDES[over])
    batch = jax_make_batch(c.jcfg, 72, 2, seed=3)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(c.jcfg, c.plan, p, to_jax(batch))))(c.params)
    got = loss_fn(c.model, to_torch(batch))
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(loss)) <= LOSS_TOL[dtype] * abs(float(loss))
    port = leaves_to_jax({k: [p.grad for p in ps]
                          for k, ps in param_leaves(c.model).items()})
    errs = leaf_errors(port, grads)
    assert len(errs) == {"qwen2-1.5b": 13, "gemma3-4b": 26}[arch]
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL[dtype], (worst, errs[worst])


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, mb):
    """One ``make_train_step`` update against the JAX step: float32, AdamW,
    batch 4 x 72, chunked logits; with microbatches 2 the batch is split in
    two and the gradients accumulated. Held as in
    ``tests/test_torch_train.py``: loss and grad_norm 1e-6 relative, m and
    v 1e-5, every parameter within 2 * lr of JAX's and at most 1% of a
    leaf's elements apart by more than 1e-6."""
    c = Dense(arch, "float32", trainable=True, logits_chunk=16, microbatches=mb)
    jo = jax_make_optimizer("adamw", peak_lr=LR, warmup=0, total=100)
    to = make_optimizer("adamw", peak_lr=LR, warmup=0, total=100)
    batch = jax_make_batch(c.jcfg, 72, 4, seed=1)
    s0 = JaxTrainState(c.params, jo.init(c.params), jnp.zeros((), jnp.int32))
    s1, m1 = jax.jit(jax_train_step(c.jcfg, c.plan, jo))(s0, to_jax(batch))
    state = TrainState(c.model, {}, 0)
    state.opt_state = to.init(state.params)
    state, mt = make_train_step(c.cfg, to)(state, to_torch(batch))
    assert rel(float(mt["loss"]), float(m1["loss"])) <= LOSS_TOL["float32"]
    assert rel(float(mt["grad_norm"]), float(m1["grad_norm"])) <= LOSS_TOL["float32"]
    opt = leaves_to_jax(state.opt_state)
    for key in ("m", "v"):
        errs = leaf_errors(opt[key], s1.opt_state[key])
        assert max(errs.values()) <= GRAD_TOL["float32"], (key, errs)
    port = jax.tree.leaves(leaves_to_jax(state.params))
    for got, want in zip(port, jax.tree.leaves(s1.params)):
        d = np.abs(got - np.asarray(want))
        assert d.max() <= 2 * LR and (d > 1e-6).mean() <= 0.01


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------

#: gemma3-4b's smoke config reshaped to the full config's structure: one
#: (5 sliding + 1 full) unit and a four-layer sliding tail
CKPT_OVER = {"qwen2-1.5b": {},
             "gemma3-4b": {"pattern": ("sliding",) * 5 + ("full",), "n_layers": 10}}
TCFG = dict(seq_len=32, global_batch=2, total_steps=40, ckpt_every=2, warmup=2)


def _assert_same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_across_packages(arch, direction, tmp_path):
    """Two steps, a checkpoint, and a restore into the other package's
    trainer, bit for bit: the bias leaves and gemma3's four-layer tail list
    go through ``leaves_to_jax`` / ``load_leaves``."""
    d = str(tmp_path)
    over = CKPT_OVER[arch]
    port_cfg, jcfg = get_smoke(arch, **over), jax_smoke(arch, **over)
    if over:
        assert len(port_cfg.tail_kinds) == 4
    if direction == "port_to_jax":
        t = Trainer(port_cfg, TrainerConfig(ckpt_dir=d, **TCFG), device="cpu")
        t.run(2)
        saved = load_arrays(d)
        _assert_same_arrays(saved, flatten(t.state_tree()))
        jt = JaxTrainer(jcfg, JaxTrainerConfig(ckpt_dir=d, **TCFG))
        assert jt.restore_latest() == 2
        _assert_same_arrays(jax_flatten(jt.state), saved)
    else:
        jt = JaxTrainer(jcfg, JaxTrainerConfig(ckpt_dir=d, **TCFG))
        jt.run(2)
        t = Trainer(port_cfg, TrainerConfig(ckpt_dir=d, **TCFG), device="cpu")
        assert t.restore_latest() == 2 and t.state.step == 2
        _assert_same_arrays(flatten(t.state_tree()), jax_flatten(jt.state))
    keys = flatten(t.state_tree())
    assert any(k.endswith("mixer::bq") for k in keys) == port_cfg.qkv_bias
    assert any(k.startswith("0::tail::3::") for k in keys) == bool(over)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + ("recurrentgemma-2b", "xlstm-350m"))
def test_costs_match_jax(arch):
    """``models.costs`` is the JAX package's, number for number: the
    assigned shape cells and the train / prefill / decode cells of
    ``chip_smoke.py``."""
    extra = (("train_8x2048", "train", 2048, 8), ("train_2x2048", "train", 2048, 2),
             ("prefill_8x2048", "prefill", 2048, 8), ("decode_8", "decode", 2080, 8))
    cells = [(ShapeCell(c.name, c.kind, c.seq_len, c.global_batch),
              JaxCell(c.name, c.kind, c.seq_len, c.global_batch)) for c in JAX_CELLS]
    assert [c for c, _ in cells] == list(SHAPE_CELLS)
    cells += [(ShapeCell(*e), JaxCell(*e)) for e in extra]
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert costs.param_bytes(cfg) == jax_costs.param_bytes(jcfg)
    for cell, jcell in cells:
        for fn in ("model_flops", "attention_flops", "kv_cache_bytes",
                   "decode_hbm_bytes", "summarize"):
            assert getattr(costs, fn)(cfg, cell) == getattr(jax_costs, fn)(jcfg, jcell), (
                fn, cell.name)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "72", "--decode-steps", "4"])
    out = capsys.readouterr().out
    assert f"{get_smoke(arch).name} on cpu" in out
    assert "prefill 2x72" in out and "decode 4 steps" in out and out.count("  seq") == 2
    assert "kernel launches in prefill: waterfill_masses 0," in out
    assert "kernel launches in decode: " in out and "softmax_xent 0" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_on_the_cpu(arch, capsys, tmp_path):
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                    "--seq-len", "32", "--batch", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"training {get_smoke(arch).name} on cpu" in out
    assert "done: step 3, loss" in out and "tokens/s" in out
    assert "kernel launches: waterfill_masses 0," in out and "rglru_scan_backward 0" in out


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 18-21, rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_dense_phases_rehearse_on_the_cpu(arch, monkeypatch):
    """``chip_smoke.py``'s phases 18-21 for one architecture on the CPU at
    the smoke widths, the shapes cut and the card's memory counters and
    profiler stubbed. Their checks must pass: no kernel wrapper launched,
    finite logits of the padded vocabulary's width, a second run identical,
    card (here the CPU) against the CPU, and gemma3's two microbatches."""
    monkeypatch.syspath_prepend(os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke as cs
    from repro_torch.kernels import rglru_scan as rg

    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "device_kernels", lambda torch, fn: (fn(), [])[1])
    monkeypatch.setattr(cs, "SERVE_SHAPE", (2, 80, 4))
    monkeypatch.setitem(cs.TRAIN_CELLS, arch, (4, 72))
    mb = 2 if arch == "gemma3-4b" else 1
    n_layers = {"qwen2-1.5b": 3, "gemma3-4b": 8}[arch]
    cut = dict(CKPT_OVER[arch], n_layers=n_layers)
    detail = {}
    rg_launches = cs.serve_phase(torch, rg, detail, {"kernel_ms": 1.0}, 18, arch, dev="cpu",
                                 cfg=get_smoke(arch, vocab=500))
    serve_out = detail[f"serve_{arch}"]
    assert rg_launches == 0 and not any(serve_out["kernel_launches"].values())
    assert max(map(max, serve_out["first_tokens"])) < 500
    cs.devices_phase(torch, rg, detail, 19, arch, n_layers, 80, dev="cpu",
                     cfg_of=lambda dt: get_smoke(arch, dtype=dt, **cut))
    assert detail[f"card_vs_cpu_{arch}"]["float32"]["tokens_equal"]
    train_out = cs.train_phase(torch, rg, detail, 20, arch, dev="cpu",
                               cfg=get_smoke(arch, logits_chunk=16, microbatches=mb))
    assert train_out["microbatches"] == mb and len(train_out["losses"]) == 3
    assert train_out["launches_per_step"] == [(0, 0)] * 3
    assert train_out["second_run_first_loss"] == train_out["losses"][0]
    assert train_out["model_flops_per_step"] == 6.0 * get_smoke(arch).param_count() * 4 * 72
    cs.train_devices_phase(torch, rg, detail, 21, arch, n_layers, 80, dev="cpu",
                           cfg=get_smoke(arch, dtype="float32", **cut))
    rec = detail[f"train_card_vs_cpu_{arch}"]
    assert rec["grad_err"] == 0.0 and rec["adamw_err"] == 0.0 and rec["launches"] == [0, 0]
    assert len(rec["bias_leaves"]) == (3 if arch == "qwen2-1.5b" else 0)
