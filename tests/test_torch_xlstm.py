"""The port's xlstm-350m (the mLSTM and sLSTM mixers, layers without an FFN)
vs the JAX model on the CPU.

Weights come from the JAX package's ``init_params`` on the smoke config and
are carried across by ``repro_torch.interop.model_from_jax``; inputs are
made with numpy. Before they are carried, the mixers' constant biases
(``b_if``, ``b``), the mLSTM's ``norm`` and the RMSNorm scales are set to
seeded random values, since JAX initialises them to constants that would
hide a bias or a scale applied in the wrong place. The JAX model calls no
Pallas kernel on this path: ``mlstm_apply`` is a ``lax.scan`` over chunks
and ``slstm_apply`` one over time.

Tolerances are those of ``tests/test_torch_dense.py``, as max |port - jax|
/ max |jax|: layers 1e-5 (float32) / 5e-2 (bf16), the model 1e-4 / 5e-2
with float32 greedy tokens identical; the loss 1e-6 / 1e-4 relative and
every gradient leaf 1e-5 / 5e-2; the train step as there; checkpoints bit
for bit. ``models.costs`` is held to the JAX copy by
``tests/test_torch_dense.py::test_costs_match_jax``.
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
from repro.models import decode_step as jax_decode, init_cache as jax_init_cache
from repro.models import init_params as jax_init, loss_fn as jax_loss
from repro.models import layers as JL, prefill as jax_prefill
from repro.optim import make_optimizer as jax_make_optimizer
from repro.runtime import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro.runtime import TrainState as JaxTrainState, make_train_step as jax_train_step
from repro_torch.checkpoint import flatten, load_arrays
from repro_torch.configs import ALIASES, get_config, get_smoke
from repro_torch.interop import cache_to_jax, leaves_to_jax, model_from_jax
from repro_torch.kernels import ref
from repro_torch.launch import serve, train as train_cli
from repro_torch.models import (Model, decode_step, init_cache, init_params, loss_fn,
                                param_leaves, prefill)
from repro_torch.models.layers import SLSTM
from repro_torch.optim import make_optimizer
from repro_torch.runtime import Trainer, TrainerConfig, TrainState, make_train_step
from torch_threads import one_thread

one_thread()

ARCH = "xlstm-350m"
DTYPES = ("float32", "bfloat16")
LAYER_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
LR = 1e-3


def rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def perturbed(params, seed: int):
    """The JAX params with the mixers' biases and every norm scale drawn at
    random (JAX initialises them to constants)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = path[-1].key
        if key in ("b_if", "b"):
            return jnp.asarray(a + rng.standard_normal(a.shape) * 0.5, a.dtype)
        if key in ("scale", "norm"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, params)


class XLSTM:
    """The smoke config's JAX params (biases and scales perturbed) and the
    port's model holding the same weights."""

    def __init__(self, dtype: str = "float32", seed: int = 0, trainable: bool = False,
                 **over):
        self.jcfg = jax_smoke(ARCH, dtype=dtype, **over)
        self.cfg = get_smoke(ARCH, dtype=dtype, **over)
        self.plan = make_plan(None, n_heads=self.jcfg.n_heads,
                              n_kv_heads=self.jcfg.n_kv_heads)
        self.params = perturbed(jax_init(self.jcfg, jax.random.PRNGKey(seed)), seed + 1)
        self.model = model_from_jax(self.cfg, jax.tree.map(np.asarray, self.params),
                                    device="cpu", trainable=trainable)
        self.dt = getattr(torch, dtype)

    def mixer(self, kind: str):
        """The first unit's ``kind`` mixer: its JAX params and the port's
        module."""
        p = self.cfg.pattern.index(kind)
        return (jax.tree.map(lambda a: a[0], self.params["units"][f"p{p}"])["mixer"],
                self.model.layers[p].mixer)

    def x(self, B, S, seed=0):
        """A mixer input in the compute dtype, on both sides."""
        x = np.random.default_rng(seed).standard_normal((B, S, self.cfg.d_model))
        xt = torch.tensor(x, dtype=torch.float32).to(self.dt)
        return jnp.asarray(xt.float().numpy()).astype(self.jcfg.dtype), xt


_MODELS = {}


def xlstm(dtype: str = "float32") -> XLSTM:
    if dtype not in _MODELS:
        _MODELS[dtype] = XLSTM(dtype)
    return _MODELS[dtype]


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


def state_errors(port: dict, want: dict) -> dict:
    assert sorted(port) == sorted(want)
    return {k: rel(port[k].float().numpy(), want[k]) for k in want}


# ---------------------------------------------------------------------------
# config, shapes, init
# ---------------------------------------------------------------------------


def test_configs_are_the_jax_configs():
    assert ALIASES[ARCH] == "xlstm_350m"
    for port, jref in ((get_config(ARCH), jax_config(ARCH)), (get_smoke(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(jref)
        assert port.param_count() == jref.param_count()


def test_full_config_has_the_jax_shapes():
    """At full width on the meta device (nothing allocated): every leaf of
    the JAX params at its shape, the real parameter count equal to the JAX
    pytree's total size, no ``norm2`` or ``ffn`` in any layer, and
    ``param_count`` (JAX's approximation, copied as it is) above it."""
    cfg = get_config(ARCH)
    model = Model(cfg, device="meta")
    shapes = jax.eval_shape(lambda: jax_init(jax_config(ARCH), jax.random.PRNGKey(0)))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {k: tuple(ps[0].shape) if "units" not in k else (len(ps),) + tuple(ps[0].shape)
           for k, ps in param_leaves(model).items()}
    assert got == want
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert n == 353_829_984
    assert cfg.param_count() == 404_013_056
    assert model.kinds == ["mlstm", "slstm"] * 12 and cfg.remat == "full"
    assert cfg.padded_vocab == 50432 != cfg.vocab
    for layer in model.layers:
        assert layer.norm2 is None and layer.ffn is None
    mixer = model.layers[0].mixer
    assert mixer.wq.shape == (2048, 2048) and mixer.norm.dtype == torch.float32
    assert mixer.w_if.dtype == mixer.b_if.dtype == torch.float32
    slstm = model.layers[1].mixer
    assert slstm.r.shape == (4, 256, 1024) and slstm.r.dtype == torch.float32
    assert slstm.w_x.dtype == torch.bfloat16 and slstm.b.dtype == torch.float32


def test_init_params_sets_the_jax_constants():
    """``init_params`` gives the JAX init's constants (``b_if``, ``b``, the
    norms) exactly, and draws the matrices at JAX's scales."""
    cfg = get_smoke(ARCH)
    model = init_params(cfg, torch.Generator().manual_seed(3), trainable=True)
    jp = jax.tree.map(np.asarray, jax_init(jax_smoke(ARCH), jax.random.PRNGKey(3)))
    port = leaves_to_jax(param_leaves(model))
    for path in ("units/p0/mixer/b_if", "units/p0/mixer/norm", "units/p1/mixer/b",
                 "units/p0/norm1/scale", "final_norm/scale"):
        a, b = port, jp
        for k in path.split("/"):
            a, b = a[k], b[k]
        assert a.dtype == np.float32 and np.array_equal(a, b), path
    for path, scale in (("units/p0/mixer/wq", 0.02), ("units/p1/mixer/r", 0.02),
                        ("units/p0/mixer/w_down", 0.02 / np.sqrt(2 * cfg.n_layers))):
        a, b = port, jp
        for k in path.split("/"):
            a, b = a[k], b[k]
        assert a.shape == b.shape and abs(a.std() / scale - 1) < 0.1, path


def test_init_cache_matches_jax_shapes():
    P = xlstm("bfloat16")
    want = jax.tree_util.tree_leaves_with_path(jax_init_cache(P.jcfg, P.plan, 3, 40))
    got = jax.tree_util.tree_leaves_with_path(cache_to_jax(P.model, init_cache(P.model, 3, 40)))
    assert [(p, np.shape(a)) for p, a in want] == [(p, a.shape) for p, a in got]
    for (p, a), (_, b) in zip(want, got):
        assert np.array_equal(np.asarray(a), b), p  # zeros, m at -1e9


@pytest.mark.parametrize("missing", [True, False])
def test_model_from_jax_raises_on_a_missing_or_left_over_leaf(missing):
    params = jax.tree.map(np.asarray, jax_init(jax_smoke(ARCH), jax.random.PRNGKey(0)))
    if missing:
        del params["units"]["p1"]["mixer"]["r"]
        with pytest.raises(KeyError, match="'r'"):
            model_from_jax(get_smoke(ARCH), params, device="cpu")
    else:
        params["units"]["p0"]["norm2"] = {"scale": np.ones((2, 64), np.float32)}
        with pytest.raises(ValueError, match="norm2"):
            model_from_jax(get_smoke(ARCH), params, device="cpu")


# ---------------------------------------------------------------------------
# the mLSTM
# ---------------------------------------------------------------------------

#: (S, chunk): one chunk shorter than the default, S equal to the chunk,
#: S not a multiple of the chunk (the last one padded), and the default
#: chunk over two chunks, the last padded
MLSTM_CASES = ((40, 256), (64, 64), (100, 32), (300, 256))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,chunk", MLSTM_CASES)
def test_mlstm_apply_matches_jax(S, chunk, dtype):
    P = xlstm(dtype)
    jp, mixer = P.mixer("mlstm")
    jx, tx = P.x(2, S, seed=S)
    jy, js = JL.mlstm_apply(jp, P.jcfg, P.plan, jx, chunk=chunk, return_state=True)
    with torch.no_grad():
        ty, ts = mixer(tx, return_state=True, chunk=chunk)
    tol = LAYER_TOL[dtype]
    assert ty.dtype == P.dt and rel(ty.float(), jy) <= tol
    errs = state_errors(ts, js)
    assert max(errs.values()) <= tol, errs


def test_mlstm_chunk_sizes_agree_with_the_recurrent_oracle():
    """float32: chunks of 16 against one chunk of S, and both against
    ``kernels.ref.mlstm_recurrent_ref`` stepped over time, on the same
    q, k, v and gates (the oracle's h normalised and projected as the
    layer does)."""
    P = xlstm("float32")
    _, mixer = P.mixer("mlstm")
    S = 50
    _, tx = P.x(2, S, seed=5)
    H = P.cfg.n_heads
    with torch.no_grad():
        y16, s16 = mixer(tx, return_state=True, chunk=16)
        yS, sS = mixer(tx, return_state=True, chunk=S)
        z, q, k, v = mixer._up(tx)
        hd = q.shape[-1] // H
        i_gate, log_f = mixer._gates(tx)
        h = ref.mlstm_recurrent_ref(q.reshape(2, S, H, hd), k.reshape(2, S, H, hd) / hd ** 0.5,
                                    v.reshape(2, S, H, hd), i_gate, log_f)
        y_ref = mixer._out(h.reshape(2, S, H * hd), z)
    assert rel(y16, yS) <= LAYER_TOL["float32"]
    assert rel(y16, y_ref) <= LAYER_TOL["float32"]
    assert rel(yS, y_ref) <= LAYER_TOL["float32"]
    assert max(state_errors(s16, {k: v.numpy() for k, v in sS.items()}).values()) <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_decode_stepped_over_a_prompt_matches_jax(dtype):
    """``mlstm_decode`` from the zero state over 12 positions, output and
    state each step against JAX; the state at the end against the port's
    own chunked apply of the same 12 positions."""
    P = xlstm(dtype)
    jp, mixer = P.mixer("mlstm")
    jx, tx = P.x(2, 12, seed=8)
    tol = LAYER_TOL[dtype]
    js = JL.mlstm_state_init(P.jcfg, 2)
    ts = mixer.cache_init(2, 12)
    for t in range(12):
        jy, js = JL.mlstm_decode(jp, P.jcfg, P.plan, jx[:, t:t + 1], js)
        with torch.no_grad():
            ty, ts = mixer.decode(tx[:, t:t + 1], ts, t)
        assert ty.shape == (2, 1, P.cfg.d_model) and rel(ty.float(), jy) <= tol, t
        errs = state_errors(ts, js)
        assert max(errs.values()) <= tol, (t, errs)
    with torch.no_grad():
        _, applied = mixer(tx, return_state=True)
    assert max(state_errors(ts, {k: v.numpy() for k, v in applied.items()}).values()) <= tol


# ---------------------------------------------------------------------------
# the sLSTM
# ---------------------------------------------------------------------------


class WideSLSTM:
    """xlstm-350m's config at another width (``dataclasses.replace``, H 4
    as the config has it): JAX's sLSTM params (the bias drawn at random:
    JAX initialises it to constants) and the port's ``SLSTM`` holding them,
    with :meth:`XLSTM.x`'s inputs. The xLSTM paper's 760M, 1.3B and 2.7B
    widths have heads of 384, 512 and 640: the kernels' wide route on the
    card, the plain loop here."""

    def __init__(self, dtype: str, d: int):
        self.jcfg = dataclasses.replace(jax_config(ARCH), d_model=d, dtype=dtype)
        self.cfg = dataclasses.replace(get_config(ARCH), d_model=d, dtype=dtype)
        self.plan = make_plan(None, n_heads=self.jcfg.n_heads, n_kv_heads=self.jcfg.n_kv_heads)
        self.params = JL.slstm_init(self.jcfg, jax.random.PRNGKey(d))
        rng = np.random.default_rng(d)
        self.params["b"] = self.params["b"] + jnp.asarray(
            rng.standard_normal(self.params["b"].shape) * 0.5, jnp.float32)
        self.module = SLSTM(self.cfg, device="cpu")
        with torch.no_grad():
            for k in ("w_x", "r", "b", "w_down"):
                getattr(self.module, k).copy_(torch.from_numpy(
                    np.array(self.params[k].astype(jnp.float32))))
        self.dt = getattr(torch, dtype)

    def mixer(self, kind: str):
        assert kind == "slstm"
        return self.params, self.module

    x = XLSTM.x


#: (d_model, positions, decode steps): the smoke width, then the xLSTM
#: paper's 760M, 1.3B and 2.7B widths at B 2
SLSTM_WIDTHS = [(None, 40, 4), (1536, 6, 2), (2048, 6, 2), (2560, 6, 2)]


@pytest.mark.parametrize("width,S,steps", SLSTM_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_apply_and_decode_match_jax(dtype, width, S, steps):
    """``slstm_apply`` over S positions with its state, then ``steps``
    ``slstm_decode`` steps from that state: the smoke model's mixer, and
    the mixer alone at the wide widths."""
    P = xlstm(dtype) if width is None else WideSLSTM(dtype, width)
    jp, mixer = P.mixer("slstm")
    jx, tx = P.x(2, S, seed=11)
    tol = LAYER_TOL[dtype]
    jy, js = JL.slstm_apply(jp, P.jcfg, P.plan, jx, return_state=True)
    with torch.no_grad():
        ty, ts = mixer(tx, return_state=True)
    assert ty.dtype == P.dt and rel(ty.float(), jy) <= tol
    assert all(v.dtype == torch.float32 for v in ts.values())
    assert max(state_errors(ts, js).values()) <= tol
    for step in range(steps):
        jxs, txs = P.x(2, 1, seed=20 + step)
        jy, js = JL.slstm_decode(jp, P.jcfg, P.plan, jxs, js)
        with torch.no_grad():
            ty, ts = mixer.decode(txs, ts, S + step)
        assert rel(ty.float(), jy) <= tol, step
        assert max(state_errors(ts, js).values()) <= tol, step


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cache_init_matches_the_jax_state_init(kind):
    P = xlstm()
    _, mixer = P.mixer(kind)
    init = JL.mlstm_state_init if kind == "mlstm" else JL.slstm_state_init
    want = init(P.jcfg, 3)
    got = mixer.cache_init(3, 50)
    assert {k: v.shape for k, v in want.items()} == {k: tuple(v.shape) for k, v in got.items()}
    for k in want:
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


# ---------------------------------------------------------------------------
# the whole model: serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_greedy_decode_match_jax(dtype):
    """Prefill logits and the states leaf by leaf on S = 300 (two mLSTM
    chunks, the last padded), then 8 greedy decode steps past the prompt:
    in float32 each side decodes its own argmax and the tokens must be
    identical; in bf16 both are fed the JAX tokens and their logits held."""
    P = xlstm(dtype)
    tol = MODEL_TOL[dtype]
    B, S, cache_len = 2, 300, 308
    toks = tokens(B, S, P.cfg.vocab, seed=7)
    jc, jl = jax.jit(lambda p, b: jax_prefill(P.jcfg, P.plan, p, b, cache_len))(
        P.params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tc, tl = prefill(P.model, {"tokens": torch.from_numpy(toks).long()}, cache_len)
    assert tl.shape == (B, 1, P.cfg.padded_vocab)
    assert rel(tl.float(), jl) <= tol

    def check_cache():
        jleaves = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jc))
        tleaves = jax.tree_util.tree_leaves_with_path(cache_to_jax(P.model, tc))
        assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
        for (path, a), (_, b) in zip(jleaves, tleaves):
            assert rel(b, a) <= tol, jax.tree_util.keystr(path)

    check_cache()
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
    check_cache()
    assert tc["pos"] == S + 8 == int(jc["pos"])


@pytest.mark.parametrize("dtype,tol", (("bfloat16", 0.05), ("float32", 1e-4)))
def test_prefill_and_decode_match_own_full_forward(dtype, tol):
    """Prefill on S - 1 tokens and one decode step give the full forward's
    last two logits (the chunked mLSTM and its one-step decode agree)."""
    P = xlstm(dtype)
    B, S = 2, 81
    toks = torch.from_numpy(tokens(B, S, P.cfg.vocab, seed=9)).long()
    with torch.no_grad():
        full = P.model(toks).float()
        cache, lg_pre = prefill(P.model, {"tokens": toks[:, :-1]}, cache_len=S + 8)
        _, lg_dec = decode_step(P.model, cache, toks[:, -1:])
    assert rel(lg_pre[:, 0].float(), full[:, -2]) < tol
    assert rel(lg_dec[:, 0].float(), full[:, -1]) < tol


def test_generate_launches_no_kernel():
    P = xlstm()
    toks = torch.from_numpy(tokens(2, 20, P.cfg.vocab, seed=4)).long()
    with torch.inference_mode():
        out, rec = serve.generate(P.model, toks, 3)
    assert out.shape == (2, 4) and bool(((out >= 0) & (out < P.cfg.vocab)).all())
    for phase in ("prefill", "decode"):
        counts = rec[f"{phase}_kernel_launches"]
        assert "rglru_scan" in counts and "softmax_xent" in counts
        assert not any(counts.values())


# ---------------------------------------------------------------------------
# the loss, every gradient, the train step
# ---------------------------------------------------------------------------

#: (dtype, logits_chunk, remat, S): dense and chunked logits in both
#: dtypes at S 72 (one mLSTM chunk), and float32 under ``remat="full"``
#: at S 300 (two mLSTM chunks, the last padded)
LOSS_CASES = [(d, c, "none", 72) for d in DTYPES for c in (0, 16)] + [
    ("float32", 16, "full", 300)]


@pytest.mark.parametrize("dtype,chunk,remat,S", LOSS_CASES)
def test_loss_and_every_gradient_match_jax(dtype, chunk, remat, S):
    """``loss_fn`` and the gradient of every parameter (biases, ``norm``
    and the sLSTM's ``r`` included) against ``jax.value_and_grad``."""
    c = XLSTM(dtype, trainable=True, logits_chunk=chunk, remat=remat)
    batch = jax_make_batch(c.jcfg, S, 2, seed=3)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(c.jcfg, c.plan, p, to_jax(batch))))(c.params)
    got = loss_fn(c.model, to_torch(batch))
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(loss)) <= LOSS_TOL[dtype] * abs(float(loss))
    port = leaves_to_jax({k: [p.grad for p in ps]
                          for k, ps in param_leaves(c.model).items()})
    errs = leaf_errors(port, grads)
    assert len(errs) == 16
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL[dtype], (worst, errs[worst])


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_jax(mb):
    """One ``make_train_step`` update against the JAX step, held as in
    ``tests/test_torch_dense.py``: float32, AdamW, batch 4 x 72, chunked
    logits, microbatches 1 and 2."""
    c = XLSTM("float32", trainable=True, logits_chunk=16, microbatches=mb)
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

TCFG = dict(seq_len=32, global_batch=2, total_steps=40, ckpt_every=2, warmup=2)


def _assert_same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_restores_across_packages(direction, tmp_path):
    """Two steps, a checkpoint, and a restore into the other package's
    trainer, bit for bit, with the mixers' leaves and no FFN leaf."""
    d = str(tmp_path)
    port_cfg, jcfg = get_smoke(ARCH), jax_smoke(ARCH)
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
    assert any(k.endswith("mixer::b_if") for k in keys)
    assert any(k.endswith("mixer::r") for k in keys)
    assert not any("ffn" in k or "norm2" in k for k in keys)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "40", "--decode-steps", "4"])
    out = capsys.readouterr().out
    assert f"{get_smoke(ARCH).name} on cpu" in out
    assert "prefill 2x40" in out and "decode 4 steps" in out and out.count("  seq") == 2
    assert "kernel launches in prefill: waterfill_masses 0," in out


def test_train_cli_runs_on_the_cpu(capsys, tmp_path):
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                    "--seq-len", "32", "--batch", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"training {get_smoke(ARCH).name} on cpu" in out
    assert "done: step 3, loss" in out and "tokens/s" in out
    assert "kernel launches: waterfill_masses 0," in out and "rglru_scan_backward 0" in out


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 22-25, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_xlstm_phases_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phases 22-25 on the CPU at the smoke widths, the
    shapes cut and the card's memory counters and profiler stubbed, the
    sLSTM's plain versions counted as its kernels' launches. Their checks
    must pass: one sLSTM launch a layer a prefill and a decode step (the
    smoke config's 2 sLSTM layers), a train step's 2 forward and 2 backward
    (4 and 2 under ``remat="full"``), no other wrapper, finite logits, a
    second run identical, card (here the CPU) against the CPU."""
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import slstm as sl

    fwd, bwd = sl.slstm_scan_plain, sl.slstm_scan_backward_plain

    def counted(*args):
        sl.slstm_scan.launches += 1
        return fwd(*args)

    def counted_backward(*args):
        sl.slstm_scan_backward.launches += 1
        return bwd(*args)

    monkeypatch.setattr(sl, "slstm_scan_plain", counted)
    monkeypatch.setattr(sl, "slstm_scan_backward_plain", counted_backward)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "device_kernels", lambda torch, fn: (fn(), [])[1])
    monkeypatch.setattr(cs, "SERVE_SHAPE", (2, 80, 4))
    monkeypatch.setitem(cs.TRAIN_CELLS, ARCH, (2, 40))
    arch, n_layers, _ = cs.XLSTM
    assert (arch, n_layers) == (ARCH, 4)
    detail = {}
    launches = cs.serve_phase(torch, rg, detail, {"kernel_ms": 1.0}, 22, ARCH, dev="cpu",
                              cfg=get_smoke(ARCH))
    out = detail[f"serve_{ARCH}"]
    assert launches == 0 and out["profiled_prefill"]["layers"] == 4
    assert {k: n for k, n in out["kernel_launches"].items() if n} == {"slstm_scan": 2}
    assert {k: n for k, n in out["decode_kernel_launches"].items() if n} == {"slstm_scan": 8}
    cs.devices_phase(torch, rg, detail, 23, ARCH, 2, 90, dev="cpu",
                     cfg_of=lambda dt: get_smoke(ARCH, dtype=dt, n_layers=2))
    assert detail[f"card_vs_cpu_{ARCH}"]["float32"]["tokens_equal"]
    train_out = cs.train_phase(torch, rg, detail, 24, ARCH, dev="cpu",
                               cfg=get_smoke(ARCH, logits_chunk=16))
    assert train_out["steps"] == 3 and len(train_out["losses"]) == 3
    assert train_out["launches_per_step"] == [(0, 0)] * 3
    assert train_out["slstm_launches_per_step"] == [(2, 2)] * 3
    assert train_out["second_run_first_loss"] == train_out["losses"][0]
    n = sum(p.numel() for p in init_params(get_smoke(ARCH), torch.Generator()).parameters())
    assert train_out["numel"] == n != get_smoke(ARCH).param_count()
    assert train_out["numel_flops_per_step"] == 6.0 * n * 2 * 40
    assert train_out["profiled_step"]["layers"] == 4
    cs.train_devices_phase(torch, rg, detail, 25, ARCH, 2, 90, dev="cpu",
                           cfg=get_smoke(ARCH, dtype="float32", remat="full"))
    rec = detail[f"train_card_vs_cpu_{ARCH}"]
    assert rec["grad_err"] == 0.0 and rec["adamw_err"] == 0.0 and rec["launches"] == [0, 0]
    assert rec["slstm_launches"] == [4, 2]
    assert rec["leaves"] == 16 and not rec["bias_leaves"]
