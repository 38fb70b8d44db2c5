"""The port's MoE models, arctic-480b and kimi-k2-1t-a32b, vs the JAX package on the CPU.

A MoE layer (``layers.MoE``, the JAX ``moe_init`` / ``moe_apply``) routes
each token to its top ``k`` experts by router probability (ties to the
lower index, as ``lax.top_k``), renormalises the gates, drops the
assignments past each expert's per-row capacity, and adds kimi's shared
expert or arctic's dense residual; kimi's first layer is a dense prefix
layer. Weights come from the JAX package's ``init_params`` / ``moe_init``
on the smoke configs (arctic-smoke: 4 experts, top-2, a dense residual;
kimi-k2-smoke: 8 experts, top-2, a shared expert, one prefix layer), the
norm scales drawn at random before they are carried
(``interop.model_from_jax``); inputs are made with numpy.

Tolerances, as max |port - jax| / max |jax|: the MoE layer's output 1e-5
in float32 and 2e-2 in bf16 (each side rounds the expert products and the
gate sums to bf16 in its own order), its aux loss 1e-6 relative; the
model 1e-4 / 5e-2 as ``tests/test_torch_dense.py`` (float32 greedy tokens
identical); the loss 1e-6 relative in float32. The expert ids are equal to
JAX's exactly, ties included. ``MoE`` against its plain twin
``moe_plain`` (no sort; a loop over experts) 1e-6 / 2e-2.
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config, get_smoke as jax_smoke
from repro.distributed.sharding import make_plan
from repro.models import decode_step as jax_decode, init_params as jax_init
from repro.models import layers as JL, loss_fn as jax_loss, prefill as jax_prefill
from repro.models.model import MOE_AUX_WEIGHT as JAX_AUX_WEIGHT
from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import cache_to_jax, leaves_to_jax, load_leaves, model_from_jax
from repro_torch.kernels import wrappers
from repro_torch.launch import serve, train as train_cli
from repro_torch.models import Model, decode_step, init_params, loss_fn, param_leaves, prefill
from repro_torch.models import layers as TL
from repro_torch.models.model import (MOE_AUX_WEIGHT, _embed_inputs, backbone, cross_entropy,
                                     logits_of)
from repro_torch.runtime import Trainer, TrainerConfig
from torch_threads import one_thread

one_thread()

ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PLAIN_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LOSS_TOL = 1e-6


def rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def perturbed_scales(params, seed: int):
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key == "scale":
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, params)


class Pair:
    """A smoke config's JAX params (scales perturbed) and the port's model
    holding the same weights."""

    def __init__(self, arch: str, dtype: str = "float32", **over):
        self.jcfg = jax_smoke(arch, dtype=dtype, **over)
        self.cfg = get_smoke(arch, dtype=dtype, **over)
        self.plan = make_plan(None, n_heads=self.jcfg.n_heads, n_kv_heads=self.jcfg.n_kv_heads)
        self.params = perturbed_scales(jax_init(self.jcfg, jax.random.PRNGKey(5)), 6)
        self.model = model_from_jax(self.cfg, jax.tree.map(np.asarray, self.params),
                                    device="cpu")


class Layer:
    """One MoE layer: the JAX ``moe_init`` params of ``cfg`` (router columns
    ``dup`` copied from column 0, so those experts' probabilities tie
    exactly) and the port's ``MoE`` holding them."""

    def __init__(self, arch: str, dtype: str = "float32", dup=(), **over):
        self.jcfg = jax_smoke(arch, dtype=dtype, **over)
        self.cfg = get_smoke(arch, dtype=dtype, **over)
        self.plan = make_plan(None, n_heads=self.jcfg.n_heads, n_kv_heads=self.jcfg.n_kv_heads)
        params = JL.moe_init(self.jcfg, jax.random.PRNGKey(7))
        for e in dup:
            params["router"] = params["router"].at[:, e].set(params["router"][:, 0])
        self.params = params
        self.moe = TL.MoE(self.cfg, device="cpu")
        leaves = {n.replace(".", "/"): [p] for n, p in self.moe.named_parameters()}
        load_leaves(leaves, lambda path: functools.reduce(
            lambda t, k: t[k], path.split("/"), jax.tree.map(np.asarray, params)))

    def jax_route(self, x):
        """Expert ids and gates as ``moe_apply`` computes them."""
        dt = jnp.dtype(self.jcfg.dtype)
        logits = (jnp.asarray(x).astype(dt) @ self.params["router"].astype(dt)).astype(jnp.float32)
        vals, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), self.jcfg.top_k)
        return np.asarray(idx), np.asarray(vals / jnp.maximum(vals.sum(-1, keepdims=True), 1e-9))

    def run(self, x):
        jo, ja = JL.moe_apply(self.params, self.jcfg, self.plan,
                              jnp.asarray(x).astype(jnp.dtype(self.jcfg.dtype)))
        with torch.no_grad():
            xt = torch.from_numpy(x).to(getattr(torch, self.cfg.dtype))
            to, ta = self.moe(xt)
            po, pa = TL.moe_plain(self.moe, xt)
            _, _, gates, idx = self.moe.route(xt)
            _, keep, _, cap = self.moe.dispatch(idx, x.shape[1])
        return {"jax": (np.asarray(jo, np.float32), float(ja)),
                "port": (to.float().numpy(), float(ta)),
                "plain": (po.float().numpy(), float(pa)),
                "idx": idx.numpy(), "gates": gates.numpy(), "dropped": int((~keep).sum()),
                "cap": cap}


def inputs(cfg, B: int, S: int, seed: int):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def boundary_ties(probs: np.ndarray, k: int) -> int:
    top = -np.sort(-probs, axis=-1)
    return int((top[..., k - 1] == top[..., k]).sum())


# ---------------------------------------------------------------------------
# configs, shapes, parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_configs(arch):
    for port, ref in ((get_config(arch), jax_config(arch)), (get_smoke(arch), jax_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_builds_with_the_jax_leaves(arch):
    """At full width and depth on the meta device: every weight of the JAX
    model at its shape and in the JAX flatten order (kimi's ``prefix``
    list, the MoE leaves ``router``, ``w_in``, ``w_out``, ``shared`` /
    ``dense``), the router float32 in a bf16 serving model, and the
    port's count as ``param_count`` gives it plus ``final_norm``."""
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    shapes = jax.eval_shape(lambda: jax_init(jax_config(arch), jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf.shape)
            for path, leaf in flat]
    got = [(k, tuple(ps[0].shape) if "units" not in k else (len(ps),) + tuple(ps[0].shape))
           for k, ps in param_leaves(model).items()]
    assert got == want
    assert model.n_prefix == cfg.first_k_dense and len(model.layers) == cfg.n_layers
    assert [layer.ffn_kind for layer in model.layers] == (
        ["swiglu"] * cfg.first_k_dense + ["moe"] * (cfg.n_layers - cfg.first_k_dense))
    moe = model.layers[-1].ffn
    assert moe.router.dtype == torch.float32 and moe.w_in.dtype == torch.bfloat16
    assert (moe.shared is not None) == (arch == "kimi-k2-1t-a32b")
    assert (moe.dense is not None) == (arch == "arctic-480b")
    n = sum(p.numel() for p in model.parameters())
    assert cfg.param_count() == jax_config(arch).param_count()
    assert n == cfg.param_count() + cfg.d_model  # it leaves out final_norm


def test_moe_and_prefix_layers_build_and_a_dense_backbone_sums_no_aux():
    """The arctic and kimi configs, and a MoE FFN or dense prefix layers
    (``first_k_dense``) on another config, build a ``Model``; a layer kind
    the port does not know raises ``ValueError``, as the JAX
    ``_layer_init`` does. A model without a MoE layer sums no aux: its
    backbone gives 0, not a tensor, and ``loss_fn`` is the cross-entropy
    alone."""
    for arch in ARCHS:
        Model(get_smoke(arch))
    for over in ({"first_k_dense": 1}, {"ffn_kind": "moe", "n_experts": 4, "top_k": 2}):
        Model(get_smoke("qwen2-1.5b", **over))
    with pytest.raises(ValueError, match="conv"):
        Model(get_smoke("qwen2-1.5b", pattern=("conv",)))
    cfg = get_smoke("qwen2-1.5b", first_k_dense=1, dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    toks, tgts = (torch.from_numpy(rng.integers(2, cfg.vocab, (2, 12))).long()
                  for _ in range(2))
    with torch.no_grad():
        h, aux = backbone(model, _embed_inputs(model, {"tokens": toks}))
        xent = cross_entropy(cfg, logits_of(model, h), tgts)
        loss = loss_fn(model, {"tokens": toks, "targets": tgts})
    assert not torch.is_tensor(aux) and aux == 0
    assert torch.equal(loss, xent)


def test_init_draws_one_expert_at_a_time(monkeypatch):
    """``init_params`` of a MoE model never draws a float32 temporary larger
    than one expert's slice of ``w_in``, and every expert is drawn (no
    slice left at zero)."""
    cfg = get_smoke("arctic-480b", n_experts=16)
    largest = []
    real = torch.randn

    def randn(*a, **k):
        out = real(*a, **k)
        largest.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", randn)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    moe = model.layers[0].ffn
    assert max(largest) == max(cfg.padded_vocab * cfg.d_model, cfg.d_model * 2 * cfg.d_ff)
    assert largest.count(cfg.d_model * 2 * cfg.moe_dff) >= cfg.n_experts
    for w in (moe.w_in, moe.w_out):
        assert bool((w.float().abs().amax(dim=(1, 2)) > 0).all())


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ("prefill", "ties", "capacity", "decode"))
def test_moe_layer_matches_moe_apply(case, arch, dtype):
    """The layer against ``moe_apply``: the output and the aux loss, the
    expert ids equal to ``lax.top_k``'s of the same probabilities, and
    ``moe_plain`` the same function. ``ties``: router columns 1 and 2
    copied from column 0, so the three experts' probabilities tie exactly
    and the tie order decides the route (asserted to happen at the top-k
    boundary); ``capacity``: ``capacity_factor`` 0.5, so assignments are
    dropped (asserted); ``decode``: S = 1, a capacity of one."""
    over = {"capacity_factor": 0.5} if case == "capacity" else {}
    L = Layer(arch, dtype, dup=(1, 2) if case == "ties" else (), **over)
    B, S = (3, 1) if case == "decode" else (2, 24)
    x = inputs(L.cfg, B, S, seed=11)
    out = L.run(x)
    jidx, jgates = L.jax_route(x)
    assert np.array_equal(out["idx"], jidx)
    assert rel(out["gates"], jgates) <= 1e-6
    assert rel(out["port"][0], out["jax"][0]) <= MOE_TOL[dtype]
    assert abs(out["port"][1] - out["jax"][1]) <= 1e-6 * abs(out["jax"][1])
    assert rel(out["port"][0], out["plain"][0]) <= PLAIN_TOL[dtype]
    assert abs(out["port"][1] - out["plain"][1]) <= 1e-6 * abs(out["plain"][1])
    if case == "ties":
        with torch.no_grad():
            _, probs, _, _ = L.moe.route(torch.from_numpy(x).to(getattr(torch, dtype)))
        assert boundary_ties(probs.numpy(), L.cfg.top_k) > 0
        # torch.topk need not order ties as lax.top_k does; the port's
        # route is a stable sort, so a tied pair keeps the lower index first
        assert (np.diff(np.sort(out["idx"], -1), axis=-1) > 0).all()
    if case == "capacity":
        assert out["cap"] < S * L.cfg.top_k / L.cfg.n_experts and out["dropped"] > 0
    if case == "decode":
        assert out["cap"] == 1 and out["dropped"] == 0


def test_moe_plain_is_independent_of_the_dispatch():
    """``moe_plain`` holds the layer's route and capacity on its own: a
    planted dispatch that ignores the capacity, or gates left
    unnormalised, moves the layer away from it."""
    L = Layer("kimi-k2-1t-a32b", capacity_factor=0.5)
    x = torch.from_numpy(inputs(L.cfg, 2, 24, seed=3))
    with torch.no_grad():
        want = TL.moe_plain(L.moe, x)[0]
        assert rel(L.moe(x)[0], want) <= PLAIN_TOL["float32"]
        L.moe.cfg = dataclasses.replace(L.cfg, capacity_factor=float(L.cfg.n_experts))
        assert rel(L.moe(x)[0], want) > 1e-3
        L.moe.cfg = L.cfg
        real_route = L.moe.route

        def raw(xx):
            logits, probs, _, idx = real_route(xx)
            return logits, probs, torch.gather(probs, -1, idx), idx

        L.moe.route = raw
        assert rel(L.moe(x)[0], want) > 1e-3


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch, dtype):
    """Prefill: the logits and the whole cache through ``cache_to_jax``
    (kimi's ``prefix`` list beside ``units``), then 4 greedy decode steps
    (the MoE layers at S = 1); in float32 each side decodes its own argmax
    and the tokens must agree, in bf16 both are fed the JAX tokens."""
    P = Pair(arch, dtype)
    tol = MODEL_TOL[dtype]
    B, S, cache_len = 2, 24, 32
    toks = np.random.default_rng(8).integers(2, P.cfg.vocab, (B, S)).astype(np.int32)
    jc, jl = jax.jit(lambda p, t: jax_prefill(P.jcfg, P.plan, p, {"tokens": t}, cache_len))(
        P.params, jnp.asarray(toks))
    with torch.no_grad():
        tc, tl = prefill(P.model, {"tokens": torch.from_numpy(toks).long()}, cache_len)
    assert rel(tl.float(), jl) <= tol
    jleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jc))
    tleaves = jax.tree_util.tree_leaves_with_path(cache_to_jax(P.model, tc))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        assert rel(b, a) <= tol, jax.tree_util.keystr(path)
    assert ("prefix" in jc) == (P.cfg.first_k_dense > 0)
    step = jax.jit(lambda p, c, x: jax_decode(P.jcfg, P.plan, p, c, x))
    V = P.cfg.vocab
    jt = np.argmax(np.asarray(jl, np.float32)[:, -1, :V], -1)[:, None].astype(np.int32)
    tt = torch.argmax(tl[:, -1, :V], -1)[:, None]
    for s in range(4):
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
    assert tc["pos"] == S + 4


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_includes_the_aux_term_as_jax(arch):
    """``loss_fn`` against the JAX loss in float32: the cross-entropy plus
    0.01 x the MoE layers' aux losses (prefix layers add none), with the
    aux term itself held to JAX's sum of ``moe_apply`` aux losses."""
    P = Pair(arch)
    rng = np.random.default_rng(9)
    toks, tgts = (rng.integers(2, P.cfg.vocab, (2, 24)).astype(np.int32) for _ in range(2))
    want = float(jax_loss(P.jcfg, P.plan, P.params,
                          {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}))
    batch = {"tokens": torch.from_numpy(toks).long(), "targets": torch.from_numpy(tgts).long()}
    with torch.no_grad():
        got = float(loss_fn(P.model, batch))
        h, aux = backbone(P.model, P.model.embed[batch["tokens"]] * P.cfg.d_model ** 0.5)
        xent = float(cross_entropy(P.cfg, logits_of(P.model, h), batch["targets"]))
    assert MOE_AUX_WEIGHT == JAX_AUX_WEIGHT == 0.01
    assert abs(got - want) <= LOSS_TOL * abs(want)
    n_moe = P.cfg.n_layers - P.cfg.first_k_dense
    assert 0.5 * n_moe < float(aux) < 2.0 * n_moe  # about 1 a balanced layer
    assert abs(got - (xent + 0.01 * float(aux))) <= 1e-6 * abs(got)


# ---------------------------------------------------------------------------
# interop, refusals, the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_round_trip_in_the_jax_layout(arch):
    """``leaves_to_jax`` over ``param_leaves`` gives the JAX params back
    bit for bit in float32 (kimi's ``prefix`` a list, the MoE leaves under
    ``ffn``); in a bf16 serving model the router stays float32 (exactly
    JAX's) and ``load_leaves`` copies a JAX tree back in place."""
    P = Pair(arch)
    want = jax.tree.map(np.asarray, P.params)
    got = leaves_to_jax(param_leaves(P.model))
    jl = jax.tree_util.tree_leaves_with_path(want)
    pl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in jl] == [p for p, _ in pl]
    for (path, a), (_, b) in zip(jl, pl):
        assert b.dtype == np.float32 and np.array_equal(a, b), jax.tree_util.keystr(path)
    ffn = got["units"]["p0"]["ffn"]
    assert set(ffn) == {"router", "w_in", "w_out", "shared" if arch.startswith("kimi")
                        else "dense"}
    if arch.startswith("kimi"):
        assert isinstance(got["prefix"], list) and set(got["prefix"][0]["ffn"]) == {
            "w_in", "w_out"}
    served = model_from_jax(get_smoke(arch), want, device="cpu")
    moe = served.layers[-1].ffn
    assert moe.router.dtype == torch.float32 and moe.w_in.dtype == torch.bfloat16
    assert np.array_equal(moe.router.numpy(), want["units"]["p0"]["ffn"]["router"][-1])
    blank = Model(get_smoke(arch), device="cpu", trainable=True)
    load_leaves(param_leaves(blank), lambda path: functools.reduce(
        lambda t, k: t[int(k)] if isinstance(t, list) else t[k], path.split("/"), want))
    for a, b in zip(blank.parameters(), P.model.parameters()):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_a_moe_model_is_refused(arch, tmp_path, capsys):
    """Once refused (the name is kept), training a MoE model now runs: the
    trainer with ``optimizer="adafactor"`` and bf16 masters (the full
    configs' ``param_dtype``) takes two steps with finite losses, and the
    train launcher trains the smoke config on the CPU, launching no kernel
    (``tests/test_torch_moe_train.py`` holds both to the JAX package)."""
    t = Trainer(get_smoke(arch, param_dtype="bfloat16"),
                TrainerConfig(seq_len=16, global_batch=2, optimizer="adafactor",
                              ckpt_dir=str(tmp_path)), device="cpu")
    assert t.state.model.layers[-1].ffn.w_in.dtype == torch.bfloat16
    out = t.run(2)
    assert out["final_step"] == 2 and all(np.isfinite(out["losses"]))
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                    "--seq-len", "16", "--batch", "2", "--ckpt-dir", str(tmp_path / "cli")])
    printed = capsys.readouterr().out
    assert f"training {get_smoke(arch).name} on cpu" in printed and "done: step 2" in printed
    assert "flash_attention 0" in printed


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_without_a_gpu_raise(arch, monkeypatch):
    """Without ``device="cpu"`` the serve launcher and ``model_from_jax``
    ask for the card and raise on a box without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--smoke"])
    params = jax.tree.map(np.asarray, jax_init(jax_smoke(arch), jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_from_jax(get_smoke(arch), params)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_and_generate_on_the_cpu(arch, capsys):
    """The serve launcher on the smoke config: no kernel wrapper launches
    (the MoE path has no kernel), and ``generate``'s prefill logits are
    the JAX prefill's on the same weights."""
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "24", "--decode-steps", "3"])
    out = capsys.readouterr().out
    assert f"{get_smoke(arch).name} on cpu" in out and out.count("  seq") == 2
    assert "flash_attention 0" in out
    P = Pair(arch)
    toks = np.random.default_rng(2).integers(2, P.cfg.vocab, (2, 20)).astype(np.int32)
    _, jl = jax_prefill(P.jcfg, P.plan, P.params, {"tokens": jnp.asarray(toks)}, 31)
    with torch.inference_mode():
        got, rec = serve.generate(P.model, torch.from_numpy(toks).long(), 3)
    assert rel(rec["logits"], jl) <= MODEL_TOL["float32"] and got.shape == (2, 4)
    assert not any(rec["prefill_kernel_launches"].values())
    assert not any(rec["decode_kernel_launches"].values())


# ---------------------------------------------------------------------------
# chip_smoke.py's routing rule and phases 38-41, rehearsed on the CPU
# ---------------------------------------------------------------------------


def _chip_smoke():
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke

    return chip_smoke


def _call(idx, kept, logits):
    return {"idx": torch.tensor(idx)[None], "kept": torch.tensor(kept)[None],
            "logits": torch.tensor(logits, dtype=torch.float32)[None]}


def test_route_check_judges_flips_by_the_near_tie_margin():
    """``chip_smoke.route_check`` compares each token's set of experts: a
    token whose swapped experts lie within 2 bf16 ulps of the reference
    logits passes, a wider swap does not (nor a near one in float32, 1e-5
    relative), and a token with the same set in another order is no flip;
    a kept flag that moves behind an earlier token's flip into its expert
    is explained, one with no such flip is not; every layer is judged."""
    cs = _chip_smoke()
    logits = [[1.0, 2.0, 1.0078125, -1.0], [0.25, 0.5, 2.0, 2.0],
              [0.0, 3.0, 3.5, 0.0]]  # the bf16 ulp at 1.0 is 2**-7
    kept = [[True, True]] * 3
    ref = _call([[1, 2], [2, 3], [2, 1]], kept, logits)
    near = _call([[1, 0], [3, 2], [2, 1]], kept, logits)
    out = cs.route_check([ref], [near], "bfloat16")
    assert (out["tokens"], out["pairs"], out["unjustified"], out["reordered"],
            out["n_rows"]) == (1, 1, 0, 1, 1)
    assert cs.route_check([ref], [near], "float32")["unjustified"] == 1
    wide = _call([[1, 2], [2, 3], [2, 0]], kept, logits)
    assert cs.route_check([ref], [wide], "bfloat16")["unjustified"] == 1
    # token 0's flip puts expert 0 ahead of token 1's assignment to it,
    # which falls past the capacity
    ref2 = _call([[1, 2], [0, 3], [2, 1]], kept, logits)
    got2 = _call([[1, 0], [0, 3], [2, 1]], [[True, True], [False, True], [True, True]],
                 logits)
    out = cs.route_check([ref2], [got2], "bfloat16")
    assert (out["tokens"], out["unjustified"], out["kept_diff"],
            out["kept_unexplained"]) == (1, 0, 1, 0)
    lone = _call([[1, 2], [0, 3], [2, 1]], [[True, True], [True, False], [True, True]],
                 logits)
    assert cs.route_check([ref2], [lone], "bfloat16")["kept_unexplained"] == 1
    # two layers: row 0 flips near at the first and far at the second
    far = _call([[3, 0], [2, 3], [2, 1]], kept, logits)
    out = cs.route_check([ref, ref], [near, far], "bfloat16")
    assert (out["tokens"], out["unjustified"], out["n_rows"]) == (2, 1, 1)


def test_chip_smoke_phases_38_41_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s ``moe_phases`` on the CPU with the smoke configs
    in place of the full ones (phase 39's whole layer at 16 experts, so its
    capacity drops), the shapes cut, the card's memory counters and
    profiler stubbed, and the blocked path's kernel branch taken for
    tensors that do not require grad, each ``flash_attention_gqa`` call
    counted as a launch. Every gate must pass: no launch on the xla path,
    one flash launch per layer in each of the two blocked prefills, the
    blocked prefill within 5e-2 of the xla run, card (here the CPU) against
    the CPU with the routing rule, ``MoE`` against ``moe_plain``. At smoke
    width a MoE layer's output is small against bf16 rounding, so the
    planted faults are gated in float32 only here (the card's run gates
    them in both dtypes)."""
    cs = _chip_smoke()
    import repro_torch.configs as port_configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg

    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "device_kernels", lambda torch, fn: (fn(), [])[1])
    monkeypatch.setattr(cs, "MOE_SERVE", (2, 64, 3))
    monkeypatch.setattr(cs, "MOE_CUT", {cs.ARCTIC: (1, 16, 64), cs.KIMI: (2, 32, 64)})
    monkeypatch.setattr(cs, "MOE_FULL", (1, 64))
    monkeypatch.setattr(cs, "MOE_CONTROLS", {arch: tuple(
        (name, plant, lambda dt, f, g=gate: dt == "float32" and (
            g(dt, f) if callable(g) else dt in g))
        for name, plant, gate in controls) for arch, controls in cs.MOE_CONTROLS.items()})
    monkeypatch.setattr(cs, "moe_layer_phase", functools.partial(
        cs.moe_layer_phase, cfg=get_smoke(cs.ARCTIC, n_layers=1, n_experts=16,
                                          dtype="float32")))
    monkeypatch.setattr(port_configs, "get_config", get_smoke)
    real = TL.kops.flash_attention_gqa

    def counted(q, k, v, **kw):
        fa.flash_attention.launches += 1
        fa.flash_attention.launches_tc += 1
        return real(q, k, v, **kw)

    monkeypatch.setattr(TL, "_on_kernel", lambda q, k, v: not (
        q.requires_grad or k.requires_grad or v.requires_grad))
    monkeypatch.setattr(TL.kops, "flash_attention_gqa", counted)
    detail = {}
    out = cs.moe_phases(torch, rg, detail, {"kernel_ms": 1.0}, dev="cpu")
    assert set(out["phase_s"]) == {38, 39, 40, 41}
    n_attn = get_smoke(cs.ARCTIC).n_layers
    assert out["flash"] == out["flash_tc"] == n_attn
    assert out["launches"] == dict(dict.fromkeys(wrappers(), 0), flash_attention=3 * n_attn)
    for arch in ARCHS:
        serve_rec = detail[f"serve_{arch}"]
        assert not any(serve_rec["kernel_launches"].values())
        assert serve_rec["after"]["assignments"] == 2 * 64 * get_smoke(arch).top_k * (
            cs.MOE_SERVE_LAYERS - get_smoke(arch).first_k_dense)
        for dtype in ("float32", "bfloat16"):
            rec = detail[f"card_vs_cpu_{arch}"][dtype]
            assert rec["rel_err_all_positions"] <= MODEL_TOL[dtype]
            assert set(rec["routing"]) == {"prefill", "last_decode"}
            assert rec["routing"]["prefill"]["unjustified"] == 0
            for name, ctl in rec["planted"].items():
                assert not ctl["gated"] or ctl["rel_err_all_positions"] > MODEL_TOL[dtype]
        assert detail[f"card_vs_cpu_{arch}"]["float32"]["planted"]["no_renorm"]["gated"]
    blocked = detail[f"serve_{cs.ARCTIC}"]["after"]["blocked"]
    assert blocked["rel_err_all_positions"] <= 5e-2
    assert blocked["launches"] == 3 * [dict(dict.fromkeys(wrappers(), 0),
                                            flash_attention=n_attn)]
    assert blocked["twin_launches"] == dict.fromkeys(wrappers(), 0)
    assert blocked["twin_rel_err_all_positions"] <= 5e-2
    assert blocked["twin_routing"]["rows_of"] == 2 * 64
    layer = detail["moe_layer_vs_plain"]
    assert layer["dropped"] > 0 and layer["rel_err"] <= 1e-5 and layer["tied_tokens"] >= 32
    assert min(layer["planted"].values()) > 1e-5
