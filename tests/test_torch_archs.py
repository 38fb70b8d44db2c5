"""The port's yi-9b, phi4-mini-3.8b and phi-3-vision-4.2b vs the JAX model,
on the CPU.

yi-9b is full attention with GQA 4 and an untied output ``head``;
phi4-mini-3.8b is full attention with GQA 3 and a tied table of 200,064
rows; phi-3-vision-4.2b is a multi-head (GQA 1) decoder whose prefill and
loss take precomputed embeddings (``input_kind="embeddings"``) and whose
decode takes tokens. Weights come from the JAX package's ``init_params``
on the smoke configs, with the norm scales drawn at random before they are
carried (JAX initialises them to ones), through
``repro_torch.interop.model_from_jax``; inputs are made with numpy. The
reference is the JAX model under ``attention_impl="xla"``.

Tolerances are those of ``tests/test_torch_dense.py``, as
max |port - jax| / max |jax|: the model 1e-4 (float32) / 5e-2 (bf16) with
float32 greedy tokens identical; the loss 1e-6 / 1e-4 relative and every
gradient leaf (``head`` included) 1e-5 / 5e-2; the AdamW step as there;
parameter counts and costs exactly equal; checkpoints bit for bit.
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
from repro.models import decode_step as jax_decode, init_params as jax_init
from repro.models import loss_fn as jax_loss, prefill as jax_prefill
from repro.models.config import ShapeCell as JaxCell
from repro.optim import make_optimizer as jax_make_optimizer
from repro.runtime import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro.runtime import TrainState as JaxTrainState, make_train_step as jax_train_step
from repro_torch.checkpoint import flatten, load_arrays
from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import cache_to_jax, leaves_to_jax, model_from_jax
from repro_torch.launch import serve
from repro_torch.models import (Model, costs, decode_step, init_params, loss_fn,
                                param_leaves, prefill)
from repro_torch.models.config import ShapeCell
from repro_torch.optim import make_optimizer
from repro_torch.runtime import Trainer, TrainerConfig, TrainState, make_train_step
from torch_threads import one_thread

one_thread()

ARCHS = ("yi-9b", "phi4-mini-3.8b", "phi-3-vision-4.2b")
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
LR = 1e-3


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


class Arch:
    """A smoke config's JAX params (scales perturbed) and the port's model
    holding the same weights."""

    def __init__(self, arch: str, dtype: str = "float32", trainable: bool = False, **over):
        self.jcfg = jax_smoke(arch, dtype=dtype, **over)
        self.cfg = get_smoke(arch, dtype=dtype, **over)
        self.plan = make_plan(None, n_heads=self.jcfg.n_heads,
                              n_kv_heads=self.jcfg.n_kv_heads)
        self.params = perturbed_scales(jax_init(self.jcfg, jax.random.PRNGKey(3)), 4)
        self.model = model_from_jax(self.cfg, jax.tree.map(np.asarray, self.params),
                                    device="cpu", trainable=trainable)


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def prompt(cfg, B, S, seed):
    """A prefill batch: tokens, or float32 embeddings for phi-3-vision."""
    batch = jax_make_batch(cfg, S, B, seed=seed, kind="prefill")
    return {k: v for k, v in batch.items() if k != "targets"}


# ---------------------------------------------------------------------------
# configs, shapes, counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_configs(arch):
    for port, ref in ((get_config(arch), jax_config(arch)), (get_smoke(arch), jax_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_has_the_jax_shapes_and_count(arch):
    """At full width on the meta device: every weight of the JAX model at
    its shape, in the JAX flatten order (``head`` after ``final_norm``),
    and the parameters ``param_count`` counts (it leaves out the final
    norm)."""
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    shapes = jax.eval_shape(lambda: jax_init(jax_config(arch), jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf.shape)
            for path, leaf in flat]
    got = [(k, tuple(ps[0].shape) if "units" not in k else (len(ps),) + tuple(ps[0].shape))
           for k, ps in param_leaves(model).items()]
    assert got == want
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() + cfg.d_model == jax_config(arch).param_count() + cfg.d_model
    assert (model.head is None) == cfg.tie_embeddings == (arch != "yi-9b")
    assert model.kinds == ["full"] * cfg.n_layers
    assert {"yi-9b": 8.83e9, "phi4-mini-3.8b": 3.84e9,
            "phi-3-vision-4.2b": 3.723e9}[arch] == pytest.approx(n, rel=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_costs_match_jax(arch):
    """``models.costs`` is the JAX package's at ``chip_smoke.py``'s cells;
    yi-9b's model FLOPs count its head."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for cell in (("train_2x2048", "train", 2048, 2), ("prefill_8x2048", "prefill", 2048, 8),
                 ("decode_8", "decode", 2080, 8)):
        for fn in ("model_flops", "attention_flops", "kv_cache_bytes", "summarize"):
            assert getattr(costs, fn)(cfg, ShapeCell(*cell)) == getattr(jax_costs, fn)(
                jcfg, JaxCell(*cell)), (fn, cell)
    head = cfg.padded_vocab * cfg.d_model
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    cell = ShapeCell("train_2x2048", "train", 2048, 2)
    assert costs.model_flops(cfg, cell) - costs.model_flops(tied, cell) == (
        6.0 * head * 2 * 2048 if arch == "yi-9b" else 0.0)


def test_head_is_drawn_after_the_table():
    """``init_params`` draws the untied head at 0.02 right after the table:
    the tied model of the same seed has the same table."""
    cfg = get_smoke("yi-9b")
    m = init_params(cfg, torch.Generator().manual_seed(0), trainable=True)
    assert m.head.shape == (cfg.d_model, cfg.padded_vocab)
    assert 0.015 < float(m.head.detach().std()) < 0.025
    t = init_params(dataclasses.replace(cfg, tie_embeddings=True),
                    torch.Generator().manual_seed(0), trainable=True)
    assert t.head is None and torch.equal(t.embed, m.embed)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch, dtype):
    """Prefill logits and the cache leaf by leaf on S = 48, then 6 greedy
    decode steps (tokens through the table, also for phi-3-vision); in
    float32 each side decodes its own argmax and the tokens must agree, in
    bf16 both are fed the JAX tokens."""
    P = Arch(arch, dtype)
    tol = MODEL_TOL[dtype]
    B, S, cache_len = 2, 48, 56
    batch = prompt(P.jcfg, B, S, seed=5)
    assert set(batch) == ({"embeds"} if arch == "phi-3-vision-4.2b" else {"tokens"})
    jc, jl = jax.jit(lambda p, b: jax_prefill(P.jcfg, P.plan, p, b, cache_len))(
        P.params, to_jax(batch))
    with torch.no_grad():
        tc, tl = prefill(P.model, {k: torch.from_numpy(v).long() if k == "tokens"
                                   else torch.from_numpy(v) for k, v in batch.items()},
                         cache_len)
    assert tl.shape == (B, 1, P.cfg.padded_vocab) and tc["pos"] == S == int(jc["pos"])
    assert rel(tl.float(), jl) <= tol
    jleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jc))
    tleaves = jax.tree_util.tree_leaves_with_path(cache_to_jax(P.model, tc))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        assert rel(b, a) <= tol, jax.tree_util.keystr(path)
    step = jax.jit(lambda p, c, x: jax_decode(P.jcfg, P.plan, p, c, x))
    V = P.cfg.vocab
    jt = np.argmax(np.asarray(jl, np.float32)[:, -1, :V], -1)[:, None].astype(np.int32)
    tt = torch.argmax(tl[:, -1, :V], -1)[:, None]
    for s in range(6):
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


def test_serve_embeds_prompts_as_the_jax_launcher():
    """phi-3-vision's ``generate`` prefills on the prompts' table rows in
    bf16 times sqrt(d) (float32, as JAX promotes them), and its prefill
    logits are the JAX prefill's on those embeddings."""
    P = Arch("phi-3-vision-4.2b")
    toks = np.random.default_rng(6).integers(2, P.cfg.vocab, (2, 40)).astype(np.int32)
    emb = jnp.take(P.params["embed"].astype(jnp.bfloat16), jnp.asarray(toks), axis=0)
    want_emb = emb * np.sqrt(P.cfg.d_model)
    got_emb = serve.prompt_batch(P.model, torch.from_numpy(toks).long())["embeds"]
    assert got_emb.dtype == torch.float32 and rel(got_emb, want_emb) <= 1e-6
    _, jl = jax_prefill(P.jcfg, P.plan, P.params, {"embeds": want_emb}, 48)
    with torch.inference_mode():
        out, rec = serve.generate(P.model, torch.from_numpy(toks).long(), 3)
    assert rel(rec["logits"], jl) <= MODEL_TOL["float32"]
    assert out.shape == (2, 4) and bool(((out >= 0) & (out < P.cfg.vocab)).all())


@pytest.mark.parametrize("arch", ("yi-9b", "phi-3-vision-4.2b"))
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "32", "--decode-steps", "4"])
    out = capsys.readouterr().out
    assert f"{get_smoke(arch).name} on cpu" in out
    assert "prefill 2x32" in out and "decode 4 steps" in out and out.count("  seq") == 2
    assert "flash_attention 0" in out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,chunk", (("float32", 0), ("float32", 16), ("bfloat16", 16)))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, dtype, chunk):
    """``loss_fn`` and every gradient against ``jax.value_and_grad`` of the
    JAX loss, S 40 (dense logits, or chunks of 16 with a padded tail):
    yi-9b's ``head`` gets the logits' gradient and its table only the
    lookup's; phi-3-vision's tied table only the logits' (its inputs are
    embeddings)."""
    c = Arch(arch, dtype, trainable=True, logits_chunk=chunk)
    batch = jax_make_batch(c.jcfg, 40, 2, seed=7)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(c.jcfg, c.plan, p, to_jax(batch))))(c.params)
    got = loss_fn(c.model, to_torch(batch))
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(loss)) <= LOSS_TOL[dtype] * abs(float(loss))
    port = leaves_to_jax({k: [p.grad for p in ps] for k, ps in param_leaves(c.model).items()})
    jl = jax.tree_util.tree_flatten_with_path(grads)[0]
    pl = jax.tree_util.tree_flatten_with_path(port)[0]
    assert [p for p, _ in jl] == [p for p, _ in pl]
    for (path, want), (_, g) in zip(jl, pl):
        assert rel(g, want) <= GRAD_TOL[dtype], jax.tree_util.keystr(path)
    assert ("head" in port) == (arch == "yi-9b")


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, mb):
    """One ``make_train_step`` AdamW update against the JAX step, float32,
    batch 4 x 40, chunked logits; with microbatches 2 the batch (the
    embeddings too) is split in two. Held as in ``tests/test_torch_dense.py``:
    loss and grad_norm 1e-6 relative, m and v 1e-5, every parameter within
    2 * lr of JAX's and at most 1% of a leaf's elements apart by more than
    1e-6."""
    c = Arch(arch, "float32", trainable=True, logits_chunk=16, microbatches=mb)
    jo = jax_make_optimizer("adamw", peak_lr=LR, warmup=0, total=100)
    to = make_optimizer("adamw", peak_lr=LR, warmup=0, total=100)
    batch = jax_make_batch(c.jcfg, 40, 4, seed=1)
    s0 = JaxTrainState(c.params, jo.init(c.params), jnp.zeros((), jnp.int32))
    s1, m1 = jax.jit(jax_train_step(c.jcfg, c.plan, jo))(s0, to_jax(batch))
    state = TrainState(c.model, {}, 0)
    state.opt_state = to.init(state.params)
    state, mt = make_train_step(c.cfg, to)(state, to_torch(batch))
    assert rel(float(mt["loss"]), float(m1["loss"])) <= LOSS_TOL["float32"]
    assert rel(float(mt["grad_norm"]), float(m1["grad_norm"])) <= LOSS_TOL["float32"]
    opt = leaves_to_jax(state.opt_state)
    for key in ("m", "v"):
        jl = jax.tree_util.tree_flatten_with_path(s1.opt_state[key])[0]
        pl = jax.tree_util.tree_flatten_with_path(opt[key])[0]
        assert [p for p, _ in jl] == [p for p, _ in pl]
        for (path, want), (_, got) in zip(jl, pl):
            assert rel(got, want) <= GRAD_TOL["float32"], (key, jax.tree_util.keystr(path))
    port = jax.tree.leaves(leaves_to_jax(state.params))
    for got, want in zip(port, jax.tree.leaves(s1.params)):
        d = np.abs(got - np.asarray(want))
        assert d.max() <= 2 * LR and (d > 1e-6).mean() <= 0.01


TCFG = dict(seq_len=32, global_batch=2, total_steps=40, ckpt_every=2, warmup=2)


@pytest.mark.parametrize("arch", ("yi-9b", "phi-3-vision-4.2b"))
def test_checkpoint_restores_across_packages(arch, tmp_path):
    """Two port steps (phi-3-vision on the pipeline's embeddings), a
    checkpoint, and a restore into the JAX trainer, bit for bit: the
    ``head`` leaf and its optimizer states sit at their JAX paths."""
    d = str(tmp_path)
    t = Trainer(get_smoke(arch), TrainerConfig(ckpt_dir=d, **TCFG), device="cpu")
    losses = t.run(2)["losses"]
    assert all(np.isfinite(losses))
    saved = load_arrays(d)
    jt = JaxTrainer(jax_smoke(arch), JaxTrainerConfig(ckpt_dir=d, **TCFG))
    assert jt.restore_latest() == 2
    want = jax_flatten(jt.state)
    assert sorted(saved) == sorted(want)
    for k in saved:
        assert np.array_equal(saved[k], want[k]), k
    assert any(k == "0::head" for k in saved) == (arch == "yi-9b")
    assert flatten(t.state_tree()).keys() == saved.keys()


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 30-33, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_phases_30_33_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s ``blocked_phases`` on the CPU with the smoke
    configs in place of the full ones, the shapes cut, the card's memory
    counters and profiler stubbed, and the blocked path's kernel branch
    taken for tensors that do not require grad, each ``flash_attention_gqa``
    call counted as a launch (its plain version runs). Every gate must
    pass: no launch on the xla path, one flash launch per layer a blocked
    prefill and none in decode or training, blocked logits within 5e-2 of
    the xla run's, card (here the CPU) against the CPU."""
    import sys

    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke as cs
    import repro_torch.configs as port_configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.models import layers as TL

    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "device_kernels", lambda torch, fn: (fn(), [])[1])
    monkeypatch.setattr(cs, "SERVE_SHAPE", (2, 64, 3))
    for arch in cs.ARCHS_30:
        monkeypatch.setitem(cs.TRAIN_CELLS, arch, (2, 64))
    for name in ("CUT_30", "TRAIN_CUT_30"):  # the lengths cut, 384 still past the window
        monkeypatch.setattr(cs, name, tuple((arch, n, 128 if S == 256 else 384, over)
                                            for arch, n, S, over in getattr(cs, name)))
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
    out = cs.blocked_phases(torch, rg, detail, {"kernel_ms": 1.0}, dev="cpu")
    assert out["flash"] == {"yi-9b": get_smoke("yi-9b").n_layers,
                            "gemma3-4b": get_smoke("gemma3-4b").n_layers}
    for arch in cs.ARCHS_30:
        assert not any(detail[f"serve_{arch}"]["kernel_launches"].values())
    assert detail["serve_yi-9b_blocked"]["vs_xla"]["rel_err"] <= 5e-2
    def key(arch, over):
        return f"{arch}_blocked" if over else arch

    assert detail["serve_yi-9b_blocked"]["vs_xla"]["rel_err_all_positions"] <= 5e-2
    for arch, _n, _S, over in cs.CUT_30:
        rec = detail[f"card_vs_cpu_{key(arch, over)}"]
        assert rec["float32"]["tokens_equal"] and rec["float32"]["flash_launches"] == (
            _n if over else 0), (arch, over)
        # the planted non-causal kernel call fails the every-position check,
        # and so does gemma3-4b's dropped window in float32
        for dtype, tol in (("float32", 1e-4), ("bfloat16", 5e-2)):
            planted = rec[dtype]["planted"]
            assert set(planted) == ({"noncausal", "no_window"} if arch == "gemma3-4b" else
                                    {"noncausal"} if over else set()), (arch, planted)
            failed = {k for k, v in planted.items() if v["rel_err_all_positions"] > tol}
            gated = set(planted) if dtype == "float32" else set(planted) - {"no_window"}
            assert failed >= gated, (arch, dtype, planted)
    for arch, _n, _S, over in cs.TRAIN_CUT_30:
        rec = detail[f"train_card_vs_cpu_{key(arch, over)}"]
        assert rec["grad_err"] == 0.0 and rec["launches"] == [0, 0], arch
        assert rec["head"] == (arch == "yi-9b")
    for arch, _n, over in cs.TRAIN_30:
        train = detail[f"train_{key(arch, over)}"]
        assert train["launches_per_step"] == [(0, 0)] * 3 and len(train["losses"]) == 3
        assert train["second_run_first_loss"] == train["losses"][0]
    assert set(out["phase_s"]) == {30, 31, 32, 33}


@pytest.mark.parametrize("arch", ("yi-9b", "phi-3-vision-4.2b"))
def test_chip_smoke_decode_on_replays_generate(arch):
    """``chip_smoke.decode_on``, which the card-vs-CPU phases use to take
    the CPU's last decode logits on the card's tokens, gives exactly
    ``generate``'s last logits when fed ``generate``'s own tokens."""
    import sys

    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke as cs

    P = Arch(arch)
    prompts = torch.from_numpy(np.random.default_rng(9).integers(
        2, P.cfg.vocab, (2, 24)).astype(np.int64))
    with torch.inference_mode():
        toks, rec = serve.generate(P.model, prompts, 5)
        last = cs.decode_on(P.model, prompts, toks, 24 + 5 + 8)
    assert torch.equal(last, rec["last_logits"])
