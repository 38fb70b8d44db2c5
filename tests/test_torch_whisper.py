"""The port's whisper-tiny vs the JAX model, on the CPU.

whisper-tiny is an encoder-decoder: precomputed frames (B, T, d) (the
audio frontend is a stub in both packages) get sinusoidal positions and
run through non-causal ``full`` layers and ``encoder_norm``; every decoder
layer then attends causally to the tokens (sinusoidal positions, no RoPE)
and, after that, to the encoder's output, the memory; decode attends to
each layer's cached memory K/V. Weights come from the JAX package's
``init_params`` on the smoke config (d 64, 2 + 2 layers, vocab 384 padded
to 512), with the norm scales drawn at random before they are carried (JAX
initialises them to ones), through ``repro_torch.interop.model_from_jax``;
inputs are made with numpy, with T != S wherever both enter. The
reference is the JAX model under its own config (``attention_impl="xla"``),
and under ``"blocked"`` for the blocked case.

Tolerances are those of ``tests/test_torch_dense.py``, as
max |port - jax| / max |jax|: the model 1e-4 (float32) / 5e-2 (bf16) with
float32 greedy tokens identical; the loss 1e-6 / 1e-4 relative and every
gradient leaf (the encoder's included) 1e-5 / 5e-2; the AdamW step as
there; parameter counts and costs exactly equal; checkpoints bit for bit;
the sinusoid table within 1e-5 of JAX's.
"""
import dataclasses
import os
import sys

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
from repro.models import prefill as jax_prefill
from repro.models.config import ShapeCell as JaxCell
from repro.models.model import _encode as jax_encode, _sinusoidal as jax_sinusoidal
from repro.optim import make_optimizer as jax_make_optimizer
from repro.runtime import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro.runtime import TrainState as JaxTrainState, make_train_step as jax_train_step
from repro_torch.checkpoint import flatten, load_arrays
from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import cache_to_jax, leaves_to_jax, model_from_jax
from repro_torch.kernels import wrappers
from repro_torch.launch import serve, train as train_cli
from repro_torch.models import (Model, costs, decode_step, init_cache, loss_fn,
                                param_leaves, prefill)
from repro_torch.models import layers as TL
from repro_torch.models.config import ShapeCell
from repro_torch.models.model import _encode, sinusoidal
from repro_torch.optim import make_optimizer
from repro_torch.runtime import Trainer, TrainerConfig, TrainState, make_train_step
from torch_threads import one_thread

one_thread()

ARCH = "whisper-tiny"
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
LR = 1e-3
#: frames and tokens of the serving tests: T != S
T_FRAMES, S_TOKENS = 40, 24


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


class Whisper:
    """The smoke config's JAX params (scales perturbed) and the port's model
    holding the same weights."""

    def __init__(self, dtype: str = "float32", trainable: bool = False, **over):
        self.jcfg = jax_smoke(ARCH, dtype=dtype, **over)
        self.cfg = get_smoke(ARCH, dtype=dtype, **over)
        self.plan = make_plan(None, n_heads=self.jcfg.n_heads,
                              n_kv_heads=self.jcfg.n_kv_heads)
        self.params = perturbed_scales(jax_init(self.jcfg, jax.random.PRNGKey(3)), 4)
        self.model = model_from_jax(self.cfg, jax.tree.map(np.asarray, self.params),
                                    device="cpu", trainable=trainable)


def prompt(cfg, B: int, T: int, S: int, seed: int):
    """A prefill batch of T float32 frames and S tokens."""
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((B, T, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(2, cfg.vocab, (B, S)).astype(np.int32)}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def grads_of(model):
    return leaves_to_jax({k: [p.grad for p in ps] for k, ps in param_leaves(model).items()})


def assert_trees_close(port, want, tol):
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    pl = jax.tree_util.tree_flatten_with_path(port)[0]
    assert [p for p, _ in jl] == [p for p, _ in pl]
    for (path, a), (_, b) in zip(jl, pl):
        assert rel(b, a) <= tol, jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# configs, shapes, counts, positions
# ---------------------------------------------------------------------------


def test_configs_are_the_jax_configs():
    for port, ref in ((get_config(ARCH), jax_config(ARCH)), (get_smoke(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_full_config_has_the_jax_shapes_and_count():
    """At full width on the meta device: every weight of the JAX model at
    its shape, in the JAX flatten order (``encoder`` before
    ``encoder_norm``, ``cross`` and ``norm_cross`` in each unit), and
    ``param_count`` plus what it leaves out: the decoder's cross-attention
    and its norms, ``final_norm`` and ``encoder_norm``."""
    cfg = get_config(ARCH)
    model = Model(cfg, device="meta")
    shapes = jax.eval_shape(lambda: jax_init(jax_config(ARCH), jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf.shape)
            for path, leaf in flat]
    got = [(k, tuple(ps[0].shape) if "units" not in k else (len(ps),) + tuple(ps[0].shape))
           for k, ps in param_leaves(model).items()]
    assert got == want
    d = cfg.d_model
    n = sum(p.numel() for p in model.parameters())
    assert cfg.param_count() == jax_config(ARCH).param_count()
    assert n == cfg.param_count() + cfg.n_layers * (4 * d * d + d) + 2 * d
    assert n == 41_197_824 and cfg.padded_vocab == 51_968
    assert len(model.encoder) == cfg.encoder_layers == 4 and model.kinds == ["full"] * 4
    assert all(layer.cross is None and not layer.mixer.causal for layer in model.encoder)
    assert all(not layer.mixer.use_rope for layer in model.layers)


def test_costs_match_jax():
    """``models.costs`` is the JAX package's at ``chip_smoke.py``'s cells."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    for cell in (("train_8x1500", "train", 1500, 8), ("prefill_8x1500", "prefill", 1500, 8),
                 ("decode_8", "decode", 1540, 8)):
        for fn in ("model_flops", "attention_flops", "kv_cache_bytes", "summarize"):
            assert getattr(costs, fn)(cfg, ShapeCell(*cell)) == getattr(jax_costs, fn)(
                jcfg, JaxCell(*cell)), (fn, cell)
    assert costs.param_bytes(cfg) == jax_costs.param_bytes(jcfg)


def test_sinusoid_table_matches_jax():
    """The table at Whisper's 1500 frames and d 384 within 1e-5 of JAX's
    ``_sinusoidal`` (the same operations; a few ulp apart), and a decode
    step's row at ``pos`` the table's row ``pos`` exactly."""
    want = np.asarray(jax_sinusoidal(1500, 384))
    got = sinusoidal(torch.arange(1500), 384)
    assert got.dtype == torch.float32 and got.shape == (1500, 384)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5
    for pos in (0, 1, 777, 1499):
        assert torch.equal(sinusoidal(torch.full((1,), pos), 384)[0], got[pos])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_encode_matches_jax(dtype):
    """The encoder alone: sinusoids on the frames, the non-causal layers,
    ``encoder_norm``."""
    W = Whisper(dtype)
    frames = prompt(W.cfg, 2, T_FRAMES, S_TOKENS, seed=1)["frames"]
    want = jax_encode(W.jcfg, W.plan, W.params, jnp.asarray(frames))
    with torch.no_grad():
        got = _encode(W.model, torch.from_numpy(frames))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, T_FRAMES, W.cfg.d_model)
    assert rel(got.float(), want) <= MODEL_TOL[dtype]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_prefill_and_greedy_decode_match_jax(dtype):
    """Prefill on T frames and S tokens: the logits and the whole cache
    through ``cache_to_jax`` (self-attention K/V of ``cache_len``, the
    cross caches of T frames), then 8 greedy decode steps (each a sinusoid
    row and the cross caches); in float32 each side decodes its own argmax
    and the tokens must agree, in bf16 both are fed the JAX tokens."""
    W = Whisper(dtype)
    tol = MODEL_TOL[dtype]
    B, cache_len = 2, 36
    batch = prompt(W.cfg, B, T_FRAMES, S_TOKENS, seed=5)
    jc, jl = jax.jit(lambda p, b: jax_prefill(W.jcfg, W.plan, p, b, cache_len))(
        W.params, to_jax(batch))
    with torch.no_grad():
        tc, tl = prefill(W.model, to_torch(batch), cache_len)
    assert tl.shape == (B, 1, W.cfg.padded_vocab) and tc["pos"] == S_TOKENS == int(jc["pos"])
    assert rel(tl.float(), jl) <= tol
    jleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jc))
    tleaves = jax.tree_util.tree_leaves_with_path(cache_to_jax(W.model, tc))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        assert rel(b, a) <= tol, jax.tree_util.keystr(path)
    assert tc["cross"][0]["ck"].shape == (B, T_FRAMES, W.cfg.n_kv_heads, 32)
    step = jax.jit(lambda p, c, x: jax_decode(W.jcfg, W.plan, p, c, x))
    V = W.cfg.vocab
    jt = np.argmax(np.asarray(jl, np.float32)[:, -1, :V], -1)[:, None].astype(np.int32)
    tt = torch.argmax(tl[:, -1, :V], -1)[:, None]
    for s in range(8):
        if dtype == "float32":
            assert (tt.numpy() == jt).all(), s
        else:
            tt = torch.from_numpy(jt).long()
        jc, jl = step(W.params, jc, jnp.asarray(jt))
        with torch.no_grad():
            tc, tl = decode_step(W.model, tc, tt)
        assert rel(tl.float(), jl) <= tol, s
        jt = np.argmax(np.asarray(jl, np.float32)[:, -1, :V], -1)[:, None].astype(np.int32)
        tt = torch.argmax(tl[:, -1, :V], -1)[:, None]
    assert tc["pos"] == S_TOKENS + 8


@pytest.mark.parametrize("encoder_seq", (0, 50))
def test_init_cache_shapes_match_jax(encoder_seq):
    """``init_cache``'s leaves in the JAX layout, shapes and order: the
    cross caches of ``cfg.encoder_seq or cache_len`` frames."""
    cfg = get_smoke(ARCH, encoder_seq=encoder_seq)
    jcfg = jax_smoke(ARCH, encoder_seq=encoder_seq)
    plan = make_plan(None, n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads)
    want = jax.eval_shape(lambda: jax_init_cache(jcfg, plan, 3, 20))
    got = cache_to_jax(Model(cfg, device="cpu"), init_cache(Model(cfg, device="cpu"), 3, 20))
    jl = jax.tree_util.tree_leaves_with_path(want)
    pl = jax.tree_util.tree_leaves_with_path(got)
    assert [(p, tuple(a.shape)) for p, a in jl] == [(p, np.shape(b)) for p, b in pl]
    assert got["units"]["p0"]["cross"]["ck"].shape[2] == (encoder_seq or 20)


def test_serve_generate_matches_the_jax_prefill():
    """``generate`` on an encoder model prefills on ``prompt_batch``'s
    ``{"frames", "tokens"}`` (frames of the prompts' length by default, or
    as given) and its prefill logits are the JAX prefill's on them."""
    W = Whisper()
    toks = np.random.default_rng(6).integers(2, W.cfg.vocab, (2, 30)).astype(np.int32)
    prompts = torch.from_numpy(toks).long()
    batch = serve.prompt_batch(W.model, prompts)
    assert set(batch) == {"frames", "tokens"} and batch["frames"].dtype == torch.bfloat16
    assert batch["frames"].shape == (2, 30, W.cfg.d_model)
    frames = serve.audio_frames(W.cfg, 2, 44, torch.Generator().manual_seed(2))
    _, jl = jax_prefill(W.jcfg, W.plan, W.params, {
        "frames": jnp.asarray(frames.float().numpy()).astype(jnp.bfloat16),
        "tokens": jnp.asarray(toks)}, 38)
    with torch.inference_mode():
        out, rec = serve.generate(W.model, prompts, 3, frames)
    assert rel(rec["logits"], jl) <= MODEL_TOL["float32"]
    assert out.shape == (2, 4) and bool(((out >= 0) & (out < W.cfg.vocab)).all())
    assert not any(rec["prefill_kernel_launches"].values())


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "48", "--decode-steps", "4"])
    out = capsys.readouterr().out
    assert f"{get_smoke(ARCH).name} on cpu" in out
    assert "prefill 2x48" in out and "decode 4 steps" in out and out.count("  seq") == 2
    assert "flash_attention 0" in out


@pytest.mark.parametrize("phase", ("prefill", "loss"))
def test_blocked_path_takes_the_decoder_self_attention_only(phase, monkeypatch):
    """``attention_impl="blocked"`` with tiles 16 / 32 and 64 tokens beside
    40 frames (a multiple of neither tile: a blocked encoder or
    cross-attention would raise): the prefill and the loss with every
    gradient match the JAX model under the same override, and with the
    kernel branch taken on the CPU a prefill calls the flash op once per
    decoder layer and never for the encoder or cross-attention."""
    over = {"attention_impl": "blocked", "attention_block_q": 16, "attention_block_kv": 32}
    W = Whisper(trainable=phase == "loss", **over)
    batch = prompt(W.cfg, 2, T_FRAMES, 64, seed=8)
    if phase == "prefill":
        real, calls = TL.kops.flash_attention_gqa, []

        def counted(q, k, v, **kw):
            calls.append((q.shape, k.shape))
            return real(q, k, v, **kw)

        monkeypatch.setattr(TL, "_on_kernel", lambda q, k, v: not (
            q.requires_grad or k.requires_grad or v.requires_grad))
        monkeypatch.setattr(TL.kops, "flash_attention_gqa", counted)
        _, jl = jax.jit(lambda p, b: jax_prefill(W.jcfg, W.plan, p, b, 72))(
            W.params, to_jax(batch))
        with torch.no_grad():
            _, tl = prefill(W.model, to_torch(batch), 72)
        assert rel(tl, jl) <= MODEL_TOL["float32"]
        assert len(calls) == W.cfg.n_layers and all(
            q[2] == k[2] == 64 for q, k in calls), calls
        return
    batch["targets"] = np.random.default_rng(9).integers(
        2, W.cfg.vocab, (2, 64)).astype(np.int32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(W.jcfg, W.plan, p, to_jax(batch))))(W.params)
    got = loss_fn(W.model, to_torch(batch))
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= LOSS_TOL["float32"] * abs(float(loss))
    assert_trees_close(grads_of(W.model), grads, GRAD_TOL["float32"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,remat,chunk", (("float32", "none", 0), ("float32", "full", 0),
                                               ("float32", "full", 16),
                                               ("bfloat16", "full", 0)))
def test_loss_and_every_gradient_match_jax(dtype, remat, chunk):
    """``loss_fn`` and every gradient (the encoder's and the cross
    attention's included) against ``jax.value_and_grad`` of the JAX loss
    on the pipeline's batch of 40 frames and tokens, with the decoder's
    units checkpointed or not, dense or chunked logits."""
    W = Whisper(dtype, trainable=True, remat=remat, logits_chunk=chunk)
    batch = jax_make_batch(W.jcfg, 40, 2, seed=7)
    assert set(batch) == {"frames", "tokens", "targets"}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(W.jcfg, W.plan, p, to_jax(batch))))(W.params)
    got = loss_fn(W.model, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(loss)) <= LOSS_TOL[dtype] * abs(float(loss))
    port = grads_of(W.model)
    assert_trees_close(port, grads, GRAD_TOL[dtype])
    assert {"encoder", "encoder_norm"} <= set(port) and "cross" in port["units"]["p0"]


def test_remat_recomputes_the_units_and_not_the_encoder():
    """Under ``remat="full"`` the backward reruns each decoder unit once
    (the unit's layer starts twice a step) and the encoder never (once), and
    the memory the checkpointed units close over gets its gradient: the
    encoder's gradients equal those without remat."""
    grads = {}
    for remat in ("none", "full"):
        W = Whisper(trainable=True, remat=remat)
        runs = {"encoder": 0, "decoder": 0}
        # pre-hooks: the recompute stops once it has what the backward
        # needs, before a layer's forward returns
        W.model.encoder[0].register_forward_pre_hook(
            lambda *a: runs.__setitem__("encoder", runs["encoder"] + 1))
        W.model.layers[0].register_forward_pre_hook(
            lambda *a: runs.__setitem__("decoder", runs["decoder"] + 1))
        batch = jax_make_batch(W.jcfg, 24, 2, seed=3)
        loss_fn(W.model, {k: torch.from_numpy(v) for k, v in batch.items()}).backward()
        assert runs == {"encoder": 1, "decoder": 2 if remat == "full" else 1}, (remat, runs)
        grads[remat] = grads_of(W.model)
    for a, b in zip(jax.tree.leaves(grads["none"]["encoder"]),
                    jax.tree.leaves(grads["full"]["encoder"])):
        assert np.abs(a).max() > 0 and np.array_equal(a, b)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_jax(mb):
    """One ``make_train_step`` AdamW update against the JAX step, float32,
    batch 4 of 32 frames and tokens; with microbatches 2 the frames are
    split with the tokens. Held as in ``tests/test_torch_dense.py``: loss
    and grad_norm 1e-6 relative, m and v 1e-5, every parameter within
    2 * lr of JAX's and at most 1% of a leaf's elements apart by more than
    1e-6."""
    W = Whisper("float32", trainable=True, microbatches=mb)
    jo = jax_make_optimizer("adamw", peak_lr=LR, warmup=0, total=100)
    to = make_optimizer("adamw", peak_lr=LR, warmup=0, total=100)
    batch = jax_make_batch(W.jcfg, 32, 4, seed=1)
    s0 = JaxTrainState(W.params, jo.init(W.params), jnp.zeros((), jnp.int32))
    s1, m1 = jax.jit(jax_train_step(W.jcfg, W.plan, jo))(s0, to_jax(batch))
    state = TrainState(W.model, {}, 0)
    state.opt_state = to.init(state.params)
    state, mt = make_train_step(W.cfg, to)(state, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    assert rel(float(mt["loss"]), float(m1["loss"])) <= LOSS_TOL["float32"]
    assert rel(float(mt["grad_norm"]), float(m1["grad_norm"])) <= LOSS_TOL["float32"]
    opt = leaves_to_jax(state.opt_state)
    for key in ("m", "v"):
        assert_trees_close(opt[key], s1.opt_state[key], GRAD_TOL["float32"])
    port = jax.tree.leaves(leaves_to_jax(state.params))
    for got, want in zip(port, jax.tree.leaves(s1.params)):
        d = np.abs(got - np.asarray(want))
        assert d.max() <= 2 * LR and (d > 1e-6).mean() <= 0.01


TCFG = dict(seq_len=32, global_batch=2, total_steps=40, ckpt_every=2, warmup=2)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_restores_across_packages(direction, tmp_path):
    """Two steps on the pipeline's frames and tokens, a checkpoint, and a
    restore into the other package's trainer, bit for bit: the encoder
    list, ``encoder_norm`` and the units' cross leaves at their JAX paths."""
    d = str(tmp_path)
    if direction == "port_to_jax":
        t = Trainer(get_smoke(ARCH), TrainerConfig(ckpt_dir=d, **TCFG), device="cpu")
        assert all(np.isfinite(t.run(2)["losses"]))
        saved = load_arrays(d)
        jt = JaxTrainer(jax_smoke(ARCH), JaxTrainerConfig(ckpt_dir=d, **TCFG))
        assert jt.restore_latest() == 2
        want, got = jax_flatten(jt.state), saved
    else:
        jt = JaxTrainer(jax_smoke(ARCH), JaxTrainerConfig(ckpt_dir=d, **TCFG))
        jt.run(2)
        t = Trainer(get_smoke(ARCH), TrainerConfig(ckpt_dir=d, **TCFG), device="cpu")
        assert t.restore_latest() == 2 and t.state.step == 2
        want, got = jax_flatten(jt.state), flatten(t.state_tree())
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert "0::encoder_norm::scale" in got and "0::encoder::1::mixer::wq" in got
    assert "0::units::p0::cross::wk" in got and "0::units::p0::norm_cross::scale" in got


def test_train_cli_runs_on_the_cpu(capsys, tmp_path):
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
                    "--seq-len", "32", "--batch", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"training {get_smoke(ARCH).name} on cpu" in out
    assert "done: step 1, loss" in out and "tokens/s" in out
    assert "kernel launches: waterfill_masses 0," in out and "flash_attention 0" in out


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 34-37, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_phases_34_37_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s ``whisper_phases`` on the CPU with the smoke
    config in place of the full one, the shapes cut (still T != S), the
    card's memory counters and profiler stubbed. Every gate must pass: no
    kernel launch, card (here the CPU) against the CPU on the logits, the
    hidden state at every position and the cross caches of T frames, the
    train step's loss, gradients (the encoder's) and AdamW."""
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke as cs
    import repro_torch.configs as port_configs
    from repro_torch.kernels import rglru_scan as rg

    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "device_kernels", lambda torch, fn: (fn(), [])[1])
    monkeypatch.setattr(cs, "WHISPER_SERVE", (2, 48, 3))
    monkeypatch.setattr(cs, "WHISPER_CUT", (40, 24))
    monkeypatch.setitem(cs.TRAIN_CELLS, ARCH, (2, 48))
    monkeypatch.setattr(port_configs, "get_config", get_smoke)
    detail = {}
    out = cs.whisper_phases(torch, rg, detail, {"kernel_ms": 1.0}, dev="cpu")
    assert set(out["phase_s"]) == {34, 35, 36, 37}
    assert set(out["launches"]) == set(wrappers())
    assert not any(out["launches"].values())
    serve_rec = detail[f"serve_{ARCH}"]
    assert serve_rec["prompt_len"] == 48 and not any(serve_rec["kernel_launches"].values())
    for dtype in ("float32", "bfloat16"):
        rec = detail[f"card_vs_cpu_{ARCH}"][dtype]
        assert rec["frames"] == 40 and len(rec["rel_err_cross"]) == 2 * get_smoke(ARCH).n_layers
        assert rec["rel_err_all_positions"] <= MODEL_TOL[dtype]
    assert detail[f"card_vs_cpu_{ARCH}"]["float32"]["tokens_equal"]
    train = detail[f"train_{ARCH}"]
    assert train["launches_per_step"] == [(0, 0)] * 3 and len(train["losses"]) == 3
    assert train["second_run_first_loss"] == train["losses"][0]
    step = detail[f"train_card_vs_cpu_{ARCH}"]
    assert step["grad_err"] == 0.0 and step["encoder_leaves"] > 0
