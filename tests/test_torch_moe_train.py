"""Training the port's MoE models, arctic-480b and kimi-k2-1t-a32b, vs the JAX package on the CPU.

The JAX package stores these configs' masters in ``param_dtype`` bfloat16
and trains them with Adafactor; the smoke configs keep float32, so every
case runs with ``param_dtype`` float32 (and float32 compute) and with
bfloat16 (masters and compute). Weights come from the JAX ``init_params``
and are carried by ``interop.model_from_jax(..., trainable=True)``; batches
from the data pipeline and gradients from numpy, seeded.

Tolerances, as max |port - jax| / max |jax| per leaf unless said otherwise:

  - the loss 1e-6 relative in float32, 1e-4 in bf16; every gradient leaf
    1e-5 in float32 (products and reductions summed in other orders:
    measured <= 1e-6) and 3e-2 in bf16, 4 to 8 bf16 ulps at the leaf's max
    (each side rounds the products, activations and the gradient to bf16
    in its own order: measured 1.1e-2);
  - Adafactor on identical gradients: float32 parameters 1e-6 (a few
    float32 ulps); a bf16 master within one bf16 ulp of JAX's, at the
    larger of the master before and after the update (the update rounds to
    a neighbour either side of a near-tie, and where it cancels a weight
    to near zero a float32 difference spans more than the small result's
    own ulp); the float32 statistics 4e-6: they square the clipped
    gradients, and XLA's float32 sum of the global norm is ~9e-7 off the
    float64 norm on these gradients (the port's ~5e-8);
  - the optimizers worked span by span against their whole-leaf forms:
    the global norm 1e-6 relative, each leaf's update 1e-5 of its max
    (float32 sums in another order), a bf16 master within one ulp;
  - two ``Trainer`` steps against the JAX ``Trainer``: the losses 1e-6 /
    1e-4 relative; the float32 parameters 5e-5 of each leaf's max
    (Adafactor divides each gradient by its row's and column's scale, so
    a gradient 1e-6 of the leaf's max apart moves a small row's update by
    up to ~1e-5 of the leaf's: measured 1.3e-5), bf16 masters within 4
    bf16 ulps of JAX's each (u reaches several times its RMS, so gradients
    one bf16 ulp apart move lr u by up to ~2 ulps of a weight, and each
    side rounds the result: measured 3); the statistics 3x the gradient
    tolerance (squares of the gradients); see the test for bf16 compute;
  - ``remat`` ``dots`` and ``names`` against ``none``: bit for bit; against
    JAX's same policy: the gradient tolerances above.
"""
import contextlib
import dataclasses
import functools
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.manager import _flatten as jax_flatten
from repro.configs import get_config as jax_config, get_smoke as jax_smoke
from repro.data import make_batch as jax_make_batch
from repro.distributed.sharding import make_plan
from repro.models import init_params as jax_init, loss_fn as jax_loss
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim.optimizers import global_norm as jax_global_norm
from repro.runtime import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro_torch.checkpoint import flatten, load_arrays
from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import leaves_to_jax, load_leaves, model_from_jax
from repro_torch.kernels import wrappers
from repro_torch.models import Model, loss_fn, param_leaves
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import make_optimizer
from repro_torch.optim import optimizers as TO
from repro_torch.runtime import Trainer, TrainerConfig, TrainState, make_train_step
from torch_threads import one_thread

one_thread()

ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
DTYPES = ("float32", "bfloat16")
DENSE = ("recurrentgemma-2b", "qwen2-1.5b", "gemma3-4b", "xlstm-350m", "yi-9b",
         "phi4-mini-3.8b", "phi-3-vision-4.2b", "whisper-tiny")
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
OPT_TOL = 1e-6
OPT_STATE_TOL = 4e-6
SPAN_TOL = 1e-5
TRAINER_F32_TOL = 5e-5


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def bf16_ulps(got, want, before=None) -> float:
    """max |got - want| in bf16 ulps of ``want`` element by element, or with
    ``before`` (the master an update started from) of the larger of the
    two: where an update cancels a weight to near zero, float32 sums in
    another order move the small result by more than its own ulp."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.abs(want) if before is None else np.maximum(
        np.abs(want), np.abs(np.asarray(before, np.float32)))
    e = np.frexp(mag)[1]
    ulp = np.where(mag == 0, 2.0 ** -133, np.ldexp(1.0, e - 8))
    return float((np.abs(got - want) / ulp).max())


def flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def leaf_errors(port_tree, jax_tree, measure=rel) -> dict:
    a, b = flat(port_tree), flat(jax_tree)
    assert sorted(a) == sorted(b)
    return {k: measure(a[k], b[k]) for k in b}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def over(dtype: str, **kw) -> dict:
    return {"dtype": dtype, "param_dtype": dtype, **kw}


class Case:
    """A smoke config with bf16 or float32 masters: the JAX params and the
    port's trainable model holding them."""

    def __init__(self, arch: str, dtype: str, seed: int = 0, **kw):
        self.jcfg = jax_smoke(arch, **over(dtype, **kw))
        self.cfg = get_smoke(arch, **over(dtype, **kw))
        self.plan = make_plan(None, n_heads=self.jcfg.n_heads, n_kv_heads=self.jcfg.n_kv_heads)
        self.params = jax_init(self.jcfg, jax.random.PRNGKey(seed))

    def model(self, cfg=None) -> Model:
        return model_from_jax(cfg or self.cfg, jax.tree.map(np.asarray, self.params),
                              device="cpu", trainable=True)

    def jax_grads(self, batch, cfg=None):
        jcfg = cfg or self.jcfg
        return jax.jit(jax.value_and_grad(
            lambda p: jax_loss(jcfg, self.plan, p, to_jax(batch))))(self.params)


def port_grads(model, batch):
    loss = loss_fn(model, to_torch(batch))
    loss.backward()
    return loss.detach(), leaves_to_jax({k: [p.grad for p in ps]
                                         for k, ps in param_leaves(model).items()})


def dropped(model, batch) -> int:
    """Assignments the model's MoE layers drop in a forward of ``batch``."""
    count = []

    def hook(moe, args):
        _, _, _, idx = moe.route(args[0])
        count.append(int((~moe.dispatch(idx, args[0].shape[1])[1]).sum()))

    hs = [m.register_forward_pre_hook(hook) for m in model.modules()
          if isinstance(m, TL.MoE)]
    with torch.no_grad():
        loss_fn(model, to_torch(batch))
    for h in hs:
        h.remove()
    return sum(count)


# ---------------------------------------------------------------------------
# masters, the loss and every gradient
# ---------------------------------------------------------------------------


def jax_dtypes(tree) -> dict:
    """Each leaf's dtype by its path, ``units/p0/mixer/wq``."""
    return {"/".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in path):
            str(a.dtype) for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS + DENSE)
def test_master_dtypes_are_the_jax_leaves(arch):
    """A trainable master has the dtype of the JAX leaf: on the full config
    (``jax.eval_shape``, nothing drawn) ``param_dtype`` bfloat16 for the MoE
    configs with their routers float32, float32 everywhere for the eight
    dense configs, which keep ``param_dtype`` float32; on the smoke config
    with ``param_dtype`` bfloat16, bfloat16 wherever JAX uses ``_pdtype``
    (the norm scales, the embedding and head too) and float32 where JAX
    names it (routers, RG-LRU gates, mLSTM and sLSTM gates). Serving keeps
    its dtypes: float32 norm scales, no grad."""
    for jcfg, cfg in ((jax_config(arch), get_config(arch)),
                      (jax_smoke(arch, param_dtype="bfloat16"),
                       get_smoke(arch, param_dtype="bfloat16"))):
        want = jax_dtypes(jax.eval_shape(lambda: jax_init(jcfg, jax.random.PRNGKey(0))))
        got = {k: str(ps[0].dtype).replace("torch.", "") for k, ps in
               param_leaves(Model(cfg, device="meta", trainable=True)).items()}
        assert got == want
        f32 = {k for k, v in got.items() if v == "float32"}
        if cfg.param_dtype == "float32":
            assert arch in DENSE and f32 == set(got)
        elif arch in ARCHS:
            assert f32 == {k for k in got if k.endswith("/router")}
    serving = Model(get_smoke(arch, param_dtype="bfloat16"), device="meta")
    assert not any(p.requires_grad for p in serving.parameters())
    assert serving.final_norm.scale.dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, dtype):
    """``loss_fn`` and the gradient of every leaf against
    ``jax.value_and_grad``: the router through the aux term and the top-k
    gates, the experts with assignments dropped (``capacity_factor`` 0.5),
    kimi's shared expert and dense prefix layer, arctic's dense residual.
    The gradients come out in the masters' dtype, as JAX's (the router's
    float32). Left out of the loss, the aux term moves the router's
    gradient past the tolerance."""
    c = Case(arch, dtype, capacity_factor=0.5)
    batch = jax_make_batch(c.jcfg, 32, 2, seed=3)
    loss, grads = c.jax_grads(batch)
    model = c.model()
    assert dropped(model, batch) > 0
    got, port = port_grads(model, batch)
    assert abs(float(got) - float(loss)) <= LOSS_TOL[dtype] * abs(float(loss))
    errs = leaf_errors(port, grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL[dtype], (worst, errs[worst])
    got_dt = {k: str(ps[0].grad.dtype).replace("torch.", "")
              for k, ps in param_leaves(model).items()}
    assert got_dt == jax_dtypes(grads)
    assert {k for k, v in got_dt.items() if v != dtype} <= {
        k for k in got_dt if k.endswith("/router")}
    names = " ".join(errs)
    assert "'router'" in names and ("'shared'" in names if arch.startswith("kimi")
                                    else "'dense'" in names)
    assert ("['prefix']" in names) == arch.startswith("kimi")
    model.zero_grad(set_to_none=True)
    with _no_aux():
        _, planted = port_grads(model, batch)
    router = [k for k in errs if k.endswith("['router']")]
    assert max(leaf_errors(planted, grads)[k] for k in router) > GRAD_TOL[dtype]


@contextlib.contextmanager
def _no_aux():
    real = TM.MOE_AUX_WEIGHT
    TM.MOE_AUX_WEIGHT = 0.0
    try:
        yield
    finally:
        TM.MOE_AUX_WEIGHT = real


@pytest.mark.parametrize("remat", ["dots", "names"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_match_none_and_jax(arch, remat):
    """``dots`` and ``names`` give ``none``'s loss and gradients bit for
    bit, and JAX's under the same policy within the float32 tolerances."""
    c = Case(arch, "float32")
    batch = jax_make_batch(c.jcfg, 32, 2, seed=5)
    out = {}
    for policy in ("none", remat):
        out[policy] = port_grads(c.model(dataclasses.replace(c.cfg, remat=policy)), batch)
    assert torch.equal(out["none"][0], out[remat][0])
    a, b = flat(out["none"][1]), flat(out[remat][1])
    assert all(np.array_equal(a[k], b[k]) for k in a)
    loss, grads = c.jax_grads(batch, dataclasses.replace(c.jcfg, remat=remat))
    assert abs(float(out[remat][0]) - float(loss)) <= LOSS_TOL["float32"] * abs(float(loss))
    errs = leaf_errors(out[remat][1], grads)
    assert max(errs.values()) <= GRAD_TOL["float32"], max(errs, key=errs.get)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_keeps_only_matrix_product_outputs(arch, monkeypatch):
    """What a ``dots`` unit keeps: autograd's saved tensors (counted with
    ``saved_tensors_hooks``) are those of ``full`` (the unit's input and
    what lies outside the unit), and the checkpoint keeps the outputs of
    the ops its policy marks, which are exactly the ``mm`` / ``addmm``
    products (the unit's ``x @ w``: attention's four, the router, the
    dense residual's or shared expert's two) and no ``bmm`` (the scores,
    the expert products). ``none`` saves many more."""
    c = Case(arch, "float32")
    batch = to_torch(jax_make_batch(c.jcfg, 16, 1, seed=1))
    ops = []
    real = TM._saves_products

    def spy(ctx, op, *args, **kwargs):
        decision = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            ops.append((str(op), decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE))
        return decision

    monkeypatch.setattr(TM, "_saves_products", spy)
    saved = {}
    for policy in ("none", "full", "dots"):
        model = c.model(dataclasses.replace(c.cfg, remat=policy))
        kept = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: kept.append(t) or t,
                                                      lambda t: t):
            loss = loss_fn(model, batch)
        saved[policy] = kept
        loss.backward()
    assert len(saved["dots"]) == len(saved["full"]) < len(saved["none"])
    assert [tuple(t.shape) for t in saved["dots"]] == [tuple(t.shape) for t in saved["full"]]
    kept_ops = [op for op, keep in ops if keep]
    assert set(kept_ops) == {"aten.mm.default"}
    assert len(kept_ops) == 7 * c.cfg.n_units
    assert any(op == "aten.bmm.default" for op, keep in ops if not keep)


# ---------------------------------------------------------------------------
# the optimizers, span by span
# ---------------------------------------------------------------------------


def _grads_like(leaves, rng, scale, heavy=False):
    """Gradients in each leaf's dtype, drawn with numpy: normal, or for the
    expert leaves Student-t of another heaviness per expert (so each
    expert's Adafactor RMS differs)."""
    out = {}
    for k, ps in leaves.items():
        gs = []
        for p in ps:
            if heavy and p.dim() == 3:
                g = np.stack([rng.standard_t(2.5 + 3 * e, p.shape[1:]) for e in range(p.shape[0])])
            else:
                g = rng.standard_normal(tuple(p.shape))
            gs.append(torch.from_numpy((g * scale).astype(np.float32)).to(p.dtype))
        out[k] = gs
    return out


def _whole_leaf_adafactor(grads, state, params, step, lr, eps=1e-30, clip_norm=1.0,
                          decay=0.8):
    """Adafactor on whole leaves, the JAX formulas as the port wrote them
    before it worked span by span."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for gs in grads.values()
                          for g in gs))
    scale = torch.minimum(torch.ones_like(norm), clip_norm / torch.clamp_min(norm, 1e-9))
    t = torch.tensor(float(step) + 1.0)
    beta = 1.0 - torch.pow(t, -decay)
    with torch.no_grad():
        for k, ps in params.items():
            us = []
            for i, g in enumerate(grads[k]):
                g = (g.float() * scale).to(g.dtype).float()
                g2 = g * g + eps
                if f"{k}/vr" in state:
                    vr, vc = state[f"{k}/vr"][i], state[f"{k}/vc"][i]
                    vr.copy_(beta * vr + (1 - beta) * g2.mean(dim=-1))
                    vc.copy_(beta * vc + (1 - beta) * g2.mean(dim=-2))
                    denom = (vr[..., None] * vc[..., None, :]) / torch.clamp_min(
                        vr.mean(dim=-1, keepdim=True)[..., None], eps)
                    us.append(g * torch.rsqrt(denom + eps))
                else:
                    v = state[f"{k}/v"][i]
                    v.copy_(beta * v + (1 - beta) * g2)
                    us.append(g * torch.rsqrt(v + eps))
            n = sum(u.numel() for u in us)
            rms = torch.sqrt(sum(torch.sum(u * u) for u in us) / n + eps)
            for p, u in zip(ps, us):
                p.copy_(p.float() - lr * (u / torch.clamp_min(rms, 1.0)))


def _per_expert_rms(opt, grads, state, params, step):
    """A planted fault: Adafactor judging each expert by its own RMS (each
    expert slice of a 3-D leaf taken as a leaf of its own)."""
    g2, s2, p2 = {}, {}, {}
    for k, ps in params.items():
        if ps[0].dim() != 3:
            g2[k], p2[k] = grads[k], ps
            s2.update({f"{k}/{n}": state[f"{k}/{n}"] for n in ("vr", "vc", "v")
                       if f"{k}/{n}" in state})
            continue
        for e in range(ps[0].shape[0]):
            key = f"{k}#{e}"
            g2[key], p2[key] = [g[e:e + 1] for g in grads[k]], [p[e:e + 1] for p in ps]
            for n in ("vr", "vc", "v"):
                if f"{k}/{n}" in state:
                    s2[f"{key}/{n}"] = [s[e:e + 1] for s in state[f"{k}/{n}"]]
    opt.update(g2, s2, p2, step)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_spans_match_the_whole_leaf_forms(arch, dtype, monkeypatch):
    """With spans of 256 elements (every matrix in row spans, every expert
    leaf expert by expert) the global norm and two Adafactor updates equal
    the whole-leaf forms within float32 summation order; the same update
    with each expert's RMS of its own (a planted fault) does not."""
    c = Case(arch, dtype)
    lr = 1e-2
    models = {name: c.model() for name in ("spans", "whole", "planted")}
    leaves = {name: param_leaves(m) for name, m in models.items()}
    opt = make_optimizer("adafactor", peak_lr=lr, warmup=0, total=10_000)
    monkeypatch.setattr(TO, "CHUNK", 256)
    assert len(TO._spans(models["spans"].embed)) > 1
    states = {name: opt.init(lv) for name, lv in leaves.items()}
    rng = np.random.default_rng(11)
    for step in range(2):
        grads = _grads_like(leaves["spans"], rng, 1e-2, heavy=True)
        whole = torch.sqrt(sum(torch.sum(torch.square(g.float())) for gs in grads.values()
                               for g in gs))
        assert rel(float(TO.global_norm(grads)), float(whole)) <= OPT_TOL
        before = {k: [p.detach().float().clone() for p in ps]
                  for k, ps in leaves["whole"].items()}
        opt.update(grads, states["spans"], leaves["spans"], step)
        _whole_leaf_adafactor(grads, states["whole"], leaves["whole"], step,
                              torch.tensor(lr))
        _per_expert_rms(opt, grads, states["planted"], leaves["planted"], step)
        worst = {}
        for name in ("spans", "planted"):
            worst[name] = 0.0
            for k, ps in leaves["whole"].items():
                for p0, p, q in zip(before[k], ps, leaves[name][k]):
                    if p.dtype == torch.float32:
                        e = rel(q.detach() - p0, p.detach() - p0) / SPAN_TOL
                    else:
                        e = bf16_ulps(q.detach().float(), p.detach().float(), p0)
                    worst[name] = max(worst[name], e)
        # within SPAN_TOL of each float32 update, one ulp of a bf16 master
        assert worst["spans"] <= 1.0, (step, worst)
        if dtype == "float32":  # a planted per-expert RMS moves the update
            assert worst["planted"] > 1.0, (step, worst)
        assert max(rel(a, b) for a, b in zip(
            jax.tree.leaves(leaves_to_jax(states["spans"])),
            jax.tree.leaves(leaves_to_jax(states["whole"])))) <= SPAN_TOL


@pytest.mark.parametrize("scale", [1e-5, 1e-2])
@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_on_bf16_masters_matches_jax(arch, scale):
    """Two updates of JAX's Adafactor and the port's on the same bf16
    masters and gradients (bf16, the router's float32; clipped at 1e-2):
    every bf16 master within one bf16 ulp of JAX's, the float32 router
    1e-6, the float32 statistics 4e-6."""
    c = Case(arch, "bfloat16")
    lr = 1e-2
    jo = jax_make_optimizer("adafactor", peak_lr=lr, warmup=0, total=10_000)
    to = make_optimizer("adafactor", peak_lr=lr, warmup=0, total=10_000)
    leaves = param_leaves(c.model())
    jp, js, ts = c.params, jo.init(c.params), to.init(leaves)
    rng = np.random.default_rng(3)
    update = jax.jit(jo.update)
    for step in range(2):
        tg = _grads_like(leaves, rng, scale)
        jg = jax.tree.map(lambda a, p: jnp.asarray(a).astype(p.dtype),
                          leaves_to_jax(tg), jp)
        before = flat(jp)
        jp, js = update(jg, js, jp, jnp.asarray(step, jnp.int32))
        to.update(tg, ts, leaves, step)
        port, want = flat(leaves_to_jax(leaves)), flat(jp)
        ulps = {k: bf16_ulps(port[k], want[k], before[k]) for k in want}
        errs = leaf_errors(leaves_to_jax(leaves), jp)
        router = {k for k in errs if k.endswith("['router']")}
        assert max(v for k, v in ulps.items() if k not in router) <= 1.0, step
        assert max(errs[k] for k in router) <= OPT_TOL, step
        errs = leaf_errors(leaves_to_jax(ts), js)
        assert max(errs.values()) <= OPT_STATE_TOL, (step, max(errs, key=errs.get))


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_with_bf16_masters_sum_in_float32(arch):
    """``microbatches=2`` on bf16 masters: the optimizer gets float32
    gradients, the two microbatches' bf16 gradients summed in float32 and
    halved (bit for bit), as JAX sums them; they are JAX's float32 sum
    within the bf16 gradient tolerance, and the step's grad_norm JAX's
    step's. The compute is float32, so the two sides route alike (in bf16
    compute a near-tie routed the other way moves an expert's gradient by
    O(1)) and their bf16 gradients differ by their own rounding only."""
    c = Case(arch, "float32", param_dtype="bfloat16", microbatches=2)
    batch = jax_make_batch(c.jcfg, 24, 4, seed=2)
    halves = []
    for i in range(2):
        model = c.model()
        _, g = port_grads(model, {k: v[2 * i:2 * i + 2] for k, v in batch.items()})
        halves.append(g)
    to = make_optimizer("sgdm", peak_lr=0.0, warmup=0, total=10)
    seen = {}

    def spy(grads, state, params, step):
        seen.update({k: [g.clone() for g in gs] for k, gs in grads.items()})
        return orig(grads, state, params, step)

    orig = to.update
    to = dataclasses.replace(to, update=spy)
    model = c.model()
    state = TrainState(model, to.init(param_leaves(model)), 0)
    _, metrics = make_train_step(c.cfg, to)(state, to_torch(batch))
    got = leaves_to_jax(seen)
    assert {str(g.dtype) for gs in seen.values() for g in gs} == {"torch.float32"}
    a, b, s = flat(halves[0]), flat(halves[1]), flat(got)
    for k in s:
        want = ((torch.from_numpy(a[k]) + torch.from_numpy(b[k]))
                / torch.tensor(2.0)).numpy()
        assert np.array_equal(s[k], want), k
    jg = None
    for i in range(2):
        half = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        _, g = c.jax_grads(half)
        g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
        jg = g if jg is None else jax.tree.map(lambda x, y: x + y, jg, g)
    jg = jax.tree.map(lambda x: x / 2, jg)
    errs = leaf_errors(got, jg)
    assert max(errs.values()) <= GRAD_TOL["bfloat16"], max(errs, key=errs.get)
    assert rel(float(metrics["grad_norm"]), float(jax_global_norm(jg))) <= 1e-2


TCFG = dict(seq_len=32, global_batch=2, total_steps=40, optimizer="adafactor",
            peak_lr=1e-2, warmup=1)


def _trainer_pair(arch, dtype, masters=None, **kw):
    o = over(dtype, param_dtype=masters or dtype)
    jt = JaxTrainer(jax_smoke(arch, **o), JaxTrainerConfig(**TCFG, **kw))
    t = Trainer(get_smoke(arch, **o), TrainerConfig(**TCFG, **kw), device="cpu")
    return jt, t


@pytest.mark.parametrize("dtype,masters", [("float32", "float32"), ("float32", "bfloat16"),
                                           ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_trainer_steps_match_the_jax_trainer(arch, dtype, masters):
    """Two steps of ``Trainer(optimizer="adafactor")`` against the JAX
    ``Trainer`` from the same weights (JAX's init carried into the port's
    trainer) and the pipeline's batches, lr 0 then 1e-2: the losses, every
    master and the Adafactor statistics. In float32 compute, float32 masters
    within 5e-5 of each leaf's max and bf16 masters within 4 bf16 ulps. In
    the configs' own dtypes (bf16 compute and masters) the gradients agree
    to bf16 noise only, and Adafactor normalises a gradient at noise level
    into an update of full size (5-18% of a leaf's masters then differ by
    more than 2 ulps): the losses are held as above, and each leaf's
    update (the masters' move) within cosine 0.99 of JAX's (measured
    >= 0.996)."""
    jt, t = _trainer_pair(arch, dtype, masters)
    params = jax.tree.map(np.array, jt.state.params)  # a copy: the step donates
    load_leaves(t.state.params, lambda path: functools.reduce(
        lambda n, k: n[int(k)] if isinstance(n, list) else n[k], path.split("/"), params))
    jl, tl = jt.run(2)["losses"], t.run(2)["losses"]
    for a, b in zip(tl, jl):
        assert abs(a - b) <= LOSS_TOL[dtype] * abs(b), (tl, jl)
    port = leaves_to_jax(t.state.params)
    got, want, before = flat(port), flat(jt.state.params), flat(params)
    if masters == "float32":
        errs = leaf_errors(port, jt.state.params)
        assert max(errs.values()) <= TRAINER_F32_TOL, max(errs, key=errs.get)
    elif dtype == "float32":
        errs = {k: bf16_ulps(got[k], want[k], before[k]) for k in want}
        assert max(errs.values()) <= 4.0, max(errs, key=errs.get)
    else:
        for k in want:
            a, b = (got[k] - before[k]).ravel(), (want[k] - before[k]).ravel()
            assert a @ b >= 0.99 * np.sqrt((a @ a) * (b @ b)), k
    changed = [not np.array_equal(got[k], before[k]) for k in want]
    assert sum(changed) >= len(changed) // 2
    if dtype == "float32":
        state = leaf_errors(leaves_to_jax(t.state.opt_state), jt.state.opt_state)
        assert max(state.values()) <= 3 * GRAD_TOL[masters], max(state, key=state.get)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_of_bf16_masters_restore_both_ways(arch, tmp_path):
    """A port checkpoint of bf16 masters (uint16 bits) and Adafactor's
    ``vr`` / ``vc`` / ``v`` restores into the JAX trainer and the reverse,
    every array identical to the writer's, in the JAX keys."""
    kw = dict(ckpt_every=2)
    jt, t = _trainer_pair(arch, "bfloat16", ckpt_dir=str(tmp_path / "port"), **kw)
    t.run(2)
    saved = load_arrays(str(tmp_path / "port"))
    assert sorted(saved) == sorted(flatten(t.state_tree()))
    embed = [k for k in saved if k.startswith("0::") and k.endswith("embed")]
    assert embed and saved[embed[0]].dtype == np.uint16
    assert any(k.endswith("::vr") for k in saved) and any(k.startswith("1::") and
                                                          k.endswith("::v") for k in saved)
    jr = JaxTrainer(jax_smoke(arch, param_dtype="bfloat16", dtype="bfloat16"),
                    JaxTrainerConfig(ckpt_dir=str(tmp_path / "port"), **TCFG, **kw))
    assert jr.restore_latest() == 2
    got = jax_flatten(jr.state)
    for k, a in saved.items():
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k
    jt2 = JaxTrainer(jax_smoke(arch, **over("bfloat16")),
                     JaxTrainerConfig(ckpt_dir=str(tmp_path / "jax"), **TCFG, **kw))
    jt2.run(2)
    t2 = Trainer(get_smoke(arch, **over("bfloat16")),
                 TrainerConfig(ckpt_dir=str(tmp_path / "jax"), **TCFG, **kw), device="cpu")
    assert t2.restore_latest() == 2
    want, back = jax_flatten(jt2.state), flatten(t2.state_tree())
    assert sorted(want) == sorted(back)
    for k in want:
        assert back[k].dtype == want[k].dtype and np.array_equal(back[k], want[k]), k


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 42-45, rehearsed on the CPU
# ---------------------------------------------------------------------------


def _chip_smoke():
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_phases_42_45_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s ``moe_train_phases`` on the CPU with the smoke
    configs (bf16 masters, ``remat="full"``) in place of the full ones, the
    shapes cut, the card's memory counters and profiler stubbed: the first
    candidate's step reports a peak that leaves less than ``FREE_GB`` free
    and is passed over. Every gate must pass: no launch, finite losses, a
    second run's first loss, card (here the CPU) against the CPU with the
    routing rule, the recompute's routes, a second step bit-equal, the
    planted faults (gated in float32 only here: at smoke width a bf16
    gradient is a few ulps wide), Adafactor card against CPU, ``MoE``
    against ``moe_plain`` gradients."""
    cs = _chip_smoke()
    import repro_torch.configs as port_configs

    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    peaks = iter([79.0e9])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: next(peaks, 1.0e9))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(total_memory=80.0e9))
    monkeypatch.setattr(cs, "device_kernels", lambda torch, fn: (fn(), [])[1])
    monkeypatch.setattr(cs, "MOE_TRAIN", {cs.ARCTIC: (1, (4,), (4, 2)),
                                          cs.KIMI: (2, (8,), (2,))})
    monkeypatch.setattr(cs, "MOE_TRAIN_SEQ", 64)
    monkeypatch.setattr(cs, "MOE_CUT", {cs.ARCTIC: (1, 16, 64), cs.KIMI: (2, 32, 64)})
    monkeypatch.setattr(cs, "MOE_FULL", (1, 64))
    monkeypatch.setattr(cs, "MOE_TRAIN_CONTROLS", {arch: tuple(
        (name, plant, lambda dt, f, g=gate: dt == "float32" and (
            g(dt, f) if callable(g) else dt in g))
        for name, plant, gate in controls) for arch, controls in cs.MOE_TRAIN_CONTROLS.items()})
    monkeypatch.setattr(port_configs, "get_config", lambda arch, **kw: get_smoke(
        arch, **{"param_dtype": "bfloat16", "remat": "full", **kw}))
    detail = {}
    out = cs.moe_train_phases(torch, detail, dev="cpu")
    assert set(out["phase_s"]) == {42, 43, 44, 45}
    assert out["launches"] == dict.fromkeys(wrappers(), 0)
    arctic = detail[f"train_{cs.ARCTIC}"]
    assert [(c["batch"], c["free_gb"] >= cs.FREE_GB) for c in arctic["candidates"]] == [
        (4, False), (2, True)]
    assert arctic["batch"] == 2 and arctic["second_run_first_loss"] == arctic["losses"][0]
    for arch in ARCHS:
        rec = detail[f"train_{arch}"]
        assert len(rec["losses"]) == 3 and all(np.isfinite(rec["losses"]))
        assert 0.0 < rec["optimizer_share"] < 1.0
        for dtype in DTYPES:
            d = detail[f"train_card_vs_cpu_{arch}"][dtype]
            assert d["bit_equal_repeat"] and d["routing"]["unjustified"] == 0
            assert d["routing"]["dropped"] > 0
            for ctl in d["planted"].values():
                assert ctl["gated"] == (dtype == "float32")
        grad = detail[f"moe_grad_vs_plain_{arch}"]
        assert grad["dropped"] > 0 and max(grad["grad_rel_err"].values()) <= 1e-5
    assert "no_renorm" in detail[f"train_card_vs_cpu_{cs.KIMI}"]["float32"]["planted"]
