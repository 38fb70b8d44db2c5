"""The port's training path vs the JAX package's, on the CPU.

recurrentgemma-2b's smoke config, JAX weights carried across by
``repro_torch.interop.model_from_jax(..., trainable=True)`` (float32
masters), batches from the data pipeline (numpy, seeded). The reference is
the JAX package under ``attention_impl="xla"`` (its RG-LRU differentiates the
associative scan ``rglru_scan_ref``); the port's scan runs its plain
forward and backward on CPU tensors. Gradients, optimizer states and
checkpoints are compared leaf by leaf in the JAX layout
(``interop.leaves_to_jax``).

Tolerances, as max |port - jax| / max |jax| per leaf unless said otherwise:

  - ``loss_fn`` and its gradients: float32 loss 1e-6 relative, every
    gradient leaf 1e-5 (the two frameworks' products and reductions sum in
    other orders: measured ~1e-6); bfloat16 loss 1e-4 relative and every
    gradient leaf 5e-2, the bound ``tests/test_torch_models.py`` holds bf16
    activations to (bf16 rounds at other places in the two frameworks);
  - each optimizer given identical gradients: parameters and states 1e-6,
    a few float32 ulps (XLA fuses multiply-adds and evaluates ``pow`` and
    the norm's sum its own way; measured <= 4e-7), the schedule 1e-9;
  - one whole ``make_train_step`` (float32, microbatches 1 and 2): loss and
    grad_norm 1e-6 relative, AdamW's m and v 1e-5 (linear and quadratic in
    the gradients); parameters: AdamW's first update is ~ +-lr * sign(g), so
    where a gradient is at noise level the two can move a weight in
    opposite directions. Every parameter is held within 2 * lr of JAX's and
    at most 1% of any leaf's elements may differ by more than 1e-6
    (measured: 0.02%);
  - data, checkpoints, remat ``full`` against ``none`` and the recovery
    path: identical, bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.manager import _flatten as jax_flatten
from repro.configs import get_smoke as jax_smoke
from repro.data import SyntheticTokens as JaxTokens, batch_iterator as jax_batches
from repro.data import make_batch as jax_make_batch
from repro.distributed.sharding import make_plan
from repro.models import init_params as jax_init, loss_fn as jax_loss
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim.optimizers import clip_by_global_norm as jax_clip
from repro.optim.optimizers import cosine_schedule as jax_cosine
from repro.optim.optimizers import global_norm as jax_global_norm
from repro.runtime import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro.runtime import TrainState as JaxTrainState, make_train_step as jax_train_step
from repro_torch.checkpoint import (CheckpointManager, available_steps, flatten,
                                    from_numpy, load_arrays, save_pytree)
from repro_torch.configs import get_smoke
from repro_torch.data import SyntheticTokens, batch_iterator, make_batch
from repro_torch.interop import leaves_to_jax, model_from_jax
from repro_torch.kernels import rglru_scan as rg
from repro_torch.launch import train as train_cli
from repro_torch.models import init_params, loss_fn, param_leaves
from repro_torch.optim import (clip_by_global_norm, cosine_schedule, global_norm,
                               make_optimizer)
from repro_torch.runtime import (SimulatedFailure, Trainer, TrainerConfig, TrainState,
                                 make_train_step)
from torch_threads import one_thread

one_thread()

ARCH = "recurrentgemma-2b"
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
OPT_TOL = 1e-6
LR = 1e-3


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def leaf_errors(port_tree, jax_tree):
    """max |port - jax| / max |jax| per leaf, keyed by the JAX key path;
    the two trees must have the same leaves."""
    jl = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    pl = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in pl]
    return {jax.tree_util.keystr(p): rel(b, a) for (p, a), (_, b) in zip(jl, pl)}


def np_params(params):
    return jax.tree.map(np.asarray, params)


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class Case:
    """JAX params and config, and the port's trainable model with the same
    weights, on the smoke config with overrides."""

    def __init__(self, seed=0, **over):
        self.jcfg = jax_smoke(ARCH, **over)
        self.cfg = get_smoke(ARCH, **over)
        self.plan = make_plan(None, n_heads=self.jcfg.n_heads, n_kv_heads=self.jcfg.n_kv_heads)
        self.params = jax_init(self.jcfg, jax.random.PRNGKey(seed))

    def model(self, cfg=None):
        return model_from_jax(cfg or self.cfg, np_params(self.params), device="cpu",
                              trainable=True)


# ---------------------------------------------------------------------------
# the loss and every gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_every_gradient_match_jax(dtype, chunk):
    """``loss_fn`` and the gradient of every parameter against
    ``jax.value_and_grad(loss_fn)``: dense logits and chunks of 16 over
    S = 40 (not a multiple: the zero-padded tail is weighted out)."""
    c = Case(dtype=dtype, logits_chunk=chunk)
    batch = jax_make_batch(c.jcfg, 40, 2, seed=3)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(c.jcfg, c.plan, p, to_jax(batch))))(c.params)
    model = c.model()
    got = loss_fn(model, to_torch(batch))
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(loss)) <= LOSS_TOL[dtype] * abs(float(loss))
    port = leaves_to_jax({k: [p.grad for p in ps] for k, ps in param_leaves(model).items()})
    errs = leaf_errors(port, grads)
    assert len(errs) == 30  # embed, final_norm and 28 leaves of the unit
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL[dtype], (worst, errs[worst])


def _count_scans(monkeypatch):
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = rg.rglru_scan_plain, rg.rglru_scan_backward_plain

    def counted_fwd(*a):
        calls["forward"] += 1
        return fwd(*a)

    def counted_bwd(*a):
        calls["backward"] += 1
        return bwd(*a)

    monkeypatch.setattr(rg, "rglru_scan_plain", counted_fwd)
    monkeypatch.setattr(rg, "rglru_scan_backward_plain", counted_bwd)
    return calls


def test_remat_full_matches_none_and_recomputes_only_the_units(monkeypatch):
    """``remat="full"`` checkpoints each pattern unit: identical loss and
    gradients to ``remat="none"``, and the scan runs once more per RG-LRU
    layer of a unit (not of the tail) in the backward. n_layers 5: one unit
    (rglru, rglru, sliding) and a two-layer rglru tail."""
    c = Case(n_layers=5, dtype="float32", logits_chunk=16)
    batch = to_torch(jax_make_batch(c.jcfg, 40, 2, seed=4))
    out = {}
    for remat in ("none", "full"):
        calls = _count_scans(monkeypatch)
        model = c.model(dataclasses.replace(c.cfg, remat=remat))
        loss = loss_fn(model, batch)
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                      dict(calls))
        monkeypatch.undo()
    assert torch.equal(out["none"][0], out["full"][0])
    for name, g in out["none"][1].items():
        assert torch.equal(g, out["full"][1][name]), name
    assert out["none"][2] == {"forward": 4, "backward": 4}
    assert out["full"][2] == {"forward": 6, "backward": 4}


@pytest.mark.parametrize("remat", ["dots", "names"])
def test_remat_policies_are_not_ported(remat, monkeypatch):
    """The checkpoint policies, once refused here, are ported: under
    ``dots`` (products without batch dims kept) and ``names`` (each layer's
    mixer and FFN outputs kept) the loss and every gradient equal
    ``remat="none"``'s bit for bit, and the backward recomputes the scan of
    each RG-LRU layer of the unit (not of the tail), as ``full`` does: the
    scan is neither a product nor a tagged output. (The name is kept from
    when the policies raised.)"""
    c = Case(n_layers=5, dtype="float32", logits_chunk=16)
    batch = to_torch(jax_make_batch(c.jcfg, 40, 2, seed=4))
    out = {}
    for policy in ("none", remat):
        calls = _count_scans(monkeypatch)
        model = c.model(dataclasses.replace(c.cfg, remat=policy))
        loss = loss_fn(model, batch)
        loss.backward()
        out[policy] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                       dict(calls))
        monkeypatch.undo()
    assert torch.equal(out["none"][0], out[remat][0])
    for name, g in out["none"][1].items():
        assert torch.equal(g, out[remat][1][name]), name
    assert out[remat][2] == {"forward": 6, "backward": 4}


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _same_grads(leaves, params, rng, scale):
    """Gradients drawn with numpy, as the JAX tree and as the port's leaves."""
    g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                     params)
    out = {}
    for path in leaves:
        leaf = g
        for k in path.split("/"):
            leaf = leaf[int(k)] if isinstance(leaf, list) else leaf[k]
        out[path] = [torch.from_numpy(np.array(x)) for x in
                     (leaf if "units" in path.split("/") else [leaf])]
    return g, out


@pytest.mark.parametrize("scale", [1e-5, 1e-2])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizer_matches_jax_given_the_same_gradients(name, scale):
    """Three updates of each optimizer from the same params and gradients;
    d_model 128 and 8 layers (2 units, a 2-layer tail) so that Adafactor
    factors the 128-wide matrices and takes its RMS over stacked units.
    Gradients at 1e-5 are never clipped; at 1e-2 they are."""
    c = Case(dtype="float32", d_model=128, n_layers=8)
    jo = jax_make_optimizer(name, peak_lr=LR, warmup=1, total=100)
    to = make_optimizer(name, peak_lr=LR, warmup=1, total=100)
    model = c.model()
    leaves = param_leaves(model)
    jp, js, ts = c.params, jo.init(c.params), to.init(leaves)
    rng = np.random.default_rng(7)
    update = jax.jit(jo.update)
    for step in range(3):
        jg, tg = _same_grads(leaves, c.params, rng, scale)
        jp, js = update(jg, js, jp, jnp.asarray(step, jnp.int32))
        to.update(tg, ts, leaves, step)
        for what, port, ref in (("params", leaves_to_jax(leaves), jp),
                                ("state", leaves_to_jax(ts), js)):
            errs = leaf_errors(port, ref)
            worst = max(errs, key=errs.get)
            assert errs[worst] <= OPT_TOL, (step, what, worst, errs[worst])


def test_cosine_schedule_matches_jax():
    for args in ((3e-4, 20, 200), (1e-3, 0, 50), (2e-3, 100, 10_000)):
        j, t = jax_cosine(*args), cosine_schedule(*args)
        for step in list(range(0, 300, 7)) + [args[2], args[2] + 5]:
            want = float(j(jnp.asarray(step, jnp.int32)))
            assert abs(float(t(step)) - want) <= 1e-9, (args, step)


def test_global_norm_and_clip_match_jax():
    c = Case(dtype="float32")
    leaves = param_leaves(c.model())
    jg, tg = _same_grads(leaves, c.params, np.random.default_rng(3), 0.05)
    assert rel(float(global_norm(tg)), float(jax_global_norm(jg))) <= OPT_TOL
    clipped, norm = clip_by_global_norm(tg, 1.0)
    jclipped, jnorm = jax_clip(jg, 1.0)
    assert float(jnorm) > 1.0 and rel(float(norm), float(jnorm)) <= OPT_TOL
    errs = leaf_errors(leaves_to_jax(clipped), jclipped)
    assert max(errs.values()) <= OPT_TOL


def test_make_optimizer_refuses_an_unknown_name():
    with pytest.raises(ValueError):
        make_optimizer("lion")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_jax(mb):
    """One ``make_train_step`` update against the JAX step: float32, AdamW,
    batch 4 x 40, chunked logits, one unit and a tail; with microbatches 2
    the batch is split in two and the gradients accumulated."""
    c = Case(dtype="float32", n_layers=5, logits_chunk=16, microbatches=mb)
    jo = jax_make_optimizer("adamw", peak_lr=LR, warmup=0, total=100)
    to = make_optimizer("adamw", peak_lr=LR, warmup=0, total=100)
    batch = jax_make_batch(c.jcfg, 40, 4, seed=1)
    s0 = JaxTrainState(c.params, jo.init(c.params), jnp.zeros((), jnp.int32))
    s1, m1 = jax.jit(jax_train_step(c.jcfg, c.plan, jo))(s0, to_jax(batch))
    state = TrainState(c.model(), {}, 0)
    state.opt_state = to.init(state.params)
    state, mt = make_train_step(c.cfg, to)(state, to_torch(batch))
    assert state.step == 1 and mt["step"] == 0
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


def test_microbatches_split_the_batch_and_average():
    """microbatches 2 on a batch of 4 equals the mean of the two halves'
    losses, and the accumulated gradient the mean of their gradients."""
    c = Case(dtype="float32", n_layers=3)
    batch = to_torch(jax_make_batch(c.jcfg, 24, 4, seed=2))
    model = c.model()
    halves = []
    for i in range(2):
        model.zero_grad()
        loss = loss_fn(model, {k: v[2 * i:2 * i + 2] for k, v in batch.items()})
        loss.backward()
        halves.append((loss.detach(), model.embed.grad.clone()))
    to = make_optimizer("sgdm", peak_lr=0.0, warmup=0, total=10)
    cfg2 = dataclasses.replace(c.cfg, microbatches=2)
    seen = {}
    orig = to.update

    def spy(grads, state, params, step):
        seen["embed"] = grads["embed"][0].clone()
        return orig(grads, state, params, step)

    to = dataclasses.replace(to, update=spy)
    state = TrainState(model, to.init(param_leaves(model)), 0)
    _, m = make_train_step(cfg2, to)(state, batch)
    assert torch.equal(m["loss"], (halves[0][0] + halves[1][0]) / 2)
    assert torch.equal(seen["embed"], (halves[0][1] + halves[1][1]) / 2)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 5, 17])
def test_data_pipeline_gives_the_jax_batches(seed):
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    for a, b in ((make_batch(cfg, 64, 3, seed=seed), jax_make_batch(jcfg, 64, 3, seed=seed)),
                 (SyntheticTokens(1000, 33, 2, seed=seed).next_batch(),
                  JaxTokens(1000, 33, 2, seed=seed).next_batch())):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    it, jit_ = batch_iterator(cfg, 32, 2, seed=seed), jax_batches(jcfg, 32, 2, seed=seed)
    for _ in range(3):
        a, b = next(it), next(jit_)
        assert all(np.array_equal(a[k], b[k]) for k in b)


# ---------------------------------------------------------------------------
# checkpoints and recovery
# ---------------------------------------------------------------------------

TCFG = dict(seq_len=32, global_batch=2, total_steps=40, ckpt_every=2, warmup=2)


def _jax_arrays(trainer):
    return jax_flatten(trainer.state)


def _assert_same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgdm"])
def test_checkpoint_keys_are_the_jax_train_states(optimizer):
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    jo = jax_make_optimizer(optimizer)
    want = jax_flatten(JaxTrainState(params, jo.init(params), jnp.zeros((), jnp.int32)))
    t = Trainer(cfg, TrainerConfig(optimizer=optimizer, **{k: v for k, v in TCFG.items()
                                                           if k != "ckpt_every"}),
                device="cpu")
    got = flatten(t.state_tree())
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert "0::units::p0::mixer::w_gate" in got and "2" in got


def test_port_checkpoint_restores_into_the_jax_trainer(tmp_path):
    d = str(tmp_path)
    t = Trainer(get_smoke(ARCH), TrainerConfig(ckpt_dir=d, **TCFG), device="cpu")
    t.run(2)
    assert available_steps(d) == [2]
    saved = load_arrays(d)
    _assert_same_arrays(saved, flatten(t.state_tree()))
    jt = JaxTrainer(jax_smoke(ARCH), JaxTrainerConfig(ckpt_dir=d, **TCFG))
    assert jt.restore_latest() == 2
    _assert_same_arrays(_jax_arrays(jt), saved)


def test_jax_checkpoint_restores_into_the_port_trainer(tmp_path):
    d = str(tmp_path)
    jt = JaxTrainer(jax_smoke(ARCH), JaxTrainerConfig(ckpt_dir=d, **TCFG))
    jt.run(2)
    t = Trainer(get_smoke(ARCH), TrainerConfig(ckpt_dir=d, **TCFG), device="cpu")
    assert t.restore_latest() == 2 and t.state.step == 2
    _assert_same_arrays(flatten(t.state_tree()), _jax_arrays(jt))


def test_bf16_is_stored_as_uint_bits_both_ways(tmp_path):
    from repro.checkpoint import restore_pytree as jax_restore, save_pytree as jax_save

    x = torch.randn(5, 3).bfloat16()
    save_pytree({"a": x, "b": [torch.arange(4, dtype=torch.int32)]}, str(tmp_path), 1)
    arrays = load_arrays(str(tmp_path))
    assert arrays["a"].dtype == np.uint16 and torch.equal(from_numpy(arrays["a"], torch.bfloat16), x)
    back = jax_restore({"a": jax.ShapeDtypeStruct((5, 3), jnp.bfloat16),
                        "b": [jax.ShapeDtypeStruct((4,), jnp.int32)]}, str(tmp_path))
    assert np.array_equal(np.asarray(back["a"], np.float32), x.float().numpy())
    jax_save({"a": jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)}, str(tmp_path), 2)
    assert torch.equal(from_numpy(load_arrays(str(tmp_path))["a"], torch.bfloat16), x)


def test_keep_last_k_and_atomic_commit(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, every=1, keep=2, async_save=True)
    for step in range(1, 6):
        mgr.maybe_save({"x": torch.full((4,), float(step))}, step)
    mgr.wait()
    assert available_steps(d) == [4, 5]
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert float(mgr.restore()["x"][0]) == 5.0 and mgr.latest_step() == 5
    every3 = CheckpointManager(d, every=3, keep=2, async_save=False)
    assert not every3.maybe_save({"x": torch.ones(1)}, 7)
    assert every3.maybe_save({"x": torch.ones(1)}, 7, force=True)
    assert available_steps(d) == [5, 7]


def test_fail_at_recovery_matches_an_uninterrupted_run(tmp_path):
    """Inject a failure at step 9 with checkpoints every 4 steps: the trainer
    restores step 8, whose state is bit for bit that of an uninterrupted
    run at step 8, and resumes to step 11 (as the JAX trainer's test)."""
    cfg = get_smoke(ARCH)
    tcfg = dict(seq_len=32, global_batch=2, total_steps=40, ckpt_every=4)
    ref = Trainer(cfg, TrainerConfig(**tcfg), device="cpu")
    ref.run(8)
    t = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path), **tcfg), device="cpu")
    with pytest.raises(SimulatedFailure):
        t.run(12, fail_at=9)
    assert t.state.step == 9
    assert t.restore_latest() == 8
    _assert_same_arrays(flatten(t.state_tree()), flatten(ref.state_tree()))
    out = t.run(3)
    assert out["final_step"] == 11 and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))


def test_trainer_refuses_a_mesh_and_resize():
    """A mesh whose device type is not the trainer's raises (a cuda mesh is
    NCCL's, a cpu one gloo's: nothing falls back), and ``resize`` without
    a checkpoint dir raises, as the JAX trainer's does."""

    class CudaMesh:
        device_type = "cuda"

    with pytest.raises(ValueError, match="mesh is on 'cuda' devices but the trainer on 'cpu'"):
        Trainer(get_smoke(ARCH), TrainerConfig(), mesh=CudaMesh(), device="cpu")
    t = Trainer(get_smoke(ARCH), TrainerConfig(seq_len=16, global_batch=2), device="cpu")
    with pytest.raises(RuntimeError, match="elastic resize requires checkpointing"):
        t.resize(None)
    with pytest.raises(RuntimeError, match="checkpoint dir"):
        t.restore_latest()


def test_trainer_init_is_seeded_and_trainable():
    cfg = get_smoke(ARCH)
    a = Trainer(cfg, TrainerConfig(seed=3), device="cpu").state.model
    b = init_params(cfg, torch.Generator().manual_seed(3), trainable=True)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert p.dtype == torch.float32 and p.requires_grad and torch.equal(p, q), n
    serving = init_params(cfg, torch.Generator().manual_seed(3))
    assert not any(p.requires_grad for p in serving.parameters())
    assert torch.equal(serving.layers[0].mixer.w_gate, b.layers[0].mixer.w_gate.bfloat16())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_train_cli_runs_on_the_cpu(capsys, tmp_path):
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                    "--seq-len", "32", "--batch", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "training recurrentgemma-smoke on cpu" in out and "M params" in out
    assert "done: step 3, loss" in out and "steps/s" in out and "tokens/s" in out


def test_train_cli_recovers_from_an_injected_failure(capsys, tmp_path):
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "6",
                    "--seq-len", "16", "--batch", "2", "--ckpt-dir", str(tmp_path),
                    "--ckpt-every", "2", "--fail-at", "3"])
    out = capsys.readouterr().out
    assert "restored step 2" in out and "done: step 6" in out


def test_train_cli_without_a_gpu_raises_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", ARCH, "--smoke", "--steps", "1"])


@pytest.mark.parametrize("flags", [["--mesh", "2x4"], ["--mesh", "1x1"]])
def test_train_cli_refuses_what_is_not_ported(flags, tmp_path, capsys):
    """``--mesh 2x4`` in a process without 8 ranks raises and names the
    ``torchrun`` line; ``--mesh 1x1`` starts a world-1 gloo group of its own,
    trains 2 steps on it and destroys the group."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", *flags]
    if flags[1] == "2x4":
        with pytest.raises(RuntimeError, match="needs 8 ranks.*torchrun --nproc-per-node 8"):
            train_cli.main(argv)
        return
    train_cli.main(argv + ["--steps", "2", "--seq-len", "16", "--batch", "2",
                           "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 1}" in out and "done: step 2, loss" in out
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# chip_smoke.py's training phases, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_cpu_half_fails_at_its_drain(monkeypatch):
    """``chip_smoke.Behind``: a check that fails on the CPU half's thread
    raises at the drain, once, and the next half runs."""
    monkeypatch.syspath_prepend(os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke as cs

    behind, ran = cs.Behind(torch), []
    behind.submit(lambda: cs.check(False, "planted"))
    with pytest.raises(cs.SmokeFailure, match="planted"):
        behind.drain()
    behind.submit(lambda: ran.append(1))
    behind.drain()
    behind.drain()
    assert ran == [1]


def test_chip_smoke_train_phases_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phases 15-17 on the CPU at cut shapes: the RG-LRU
    plain forward and backward stand in for the kernels and count as their
    launches on the route ``_route`` names, the timers, the profiler and the
    card's memory counters are stubbed. Their checks must pass: backward ==
    plain bit for bit on both routes, grad through both "kernels", 6
    forward and 4 backward launches a step at n_layers 5 (one unit,
    recomputed, and a two-layer tail), all on the TMA route, no other
    kernel, a second run's first loss identical, card (here the CPU)
    against the CPU."""
    monkeypatch.syspath_prepend(os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke as cs

    fwd, bwd = rg.rglru_scan_plain, rg.rglru_scan_backward_plain

    def count(wrapper, a, others, route=None):
        wrapper.launches += 1
        route = route or rg._route(a.dtype, a.shape[-1], [t.data_ptr() for t in (a, *others)])
        wrapper.launches_tma += route == rg.TMA

    def plain(a, b, h0):
        count(rg.rglru_scan, a, (b,))
        return fwd(a, b, h0)

    def plain_backward(a, h, h0, dh):
        count(rg.rglru_scan_backward, a, (h, dh))
        return bwd(a, h, h0, dh)

    monkeypatch.setattr(rg, "rglru_scan_plain", plain)
    monkeypatch.setattr(rg, "rglru_scan_backward_plain", plain_backward)
    monkeypatch.setattr(rg, "_launch", lambda a, b, h0, route=None: (
        count(rg.rglru_scan, a, (b,), route), fwd(a, b, h0))[1])
    monkeypatch.setattr(rg, "_launch_backward", lambda a, h, h0, dh, route=None: (
        count(rg.rglru_scan_backward, a, (h, dh), route), bwd(a, h, h0, dh))[1])
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "graph_ms", lambda torch, fn, reps=1, rounds=1: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "call_ms", lambda torch, fn, reps=1: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "device_kernels", lambda torch, fn: (fn(), [])[1])
    monkeypatch.setattr(cs, "TRAIN_SHAPE", (2, 40, 96))
    monkeypatch.setitem(cs.TRAIN_CELLS, ARCH, (2, 40))
    detail = {}
    t = cs.rglru_backward_phase(torch, rg, detail, dev="cpu")
    assert detail["rglru_backward_kernel"]["max_abs_err"] == 0.0 and t["bound_by"] == "bytes"
    cfg = get_smoke(ARCH, n_layers=5, remat="full", logits_chunk=16)
    out = cs.train_phase(torch, rg, detail, dev="cpu", cfg=cfg)
    assert out["launches_per_step"] == [(6, 4)] * 3 and out["launches"] == [18, 12]
    assert out["launches_tma"] == [18, 12]
    assert detail["rglru_backward_kernel"]["runs"] == {"tma": 14, "direct": 16}
    assert len(out["losses"]) == 3 and out["second_run_first_loss"] == out["losses"][0]
    cs.train_devices_phase(torch, rg, detail, dev="cpu",
                           cfg=get_smoke(ARCH, n_layers=5, dtype="float32", remat="full"))
    rec = detail[f"train_card_vs_cpu_{ARCH}"]
    assert rec["launches"] == [6, 4] and rec["grad_err"] == 0.0 and rec["adamw_err"] == 0.0
    # the CPU half on a thread of its own, as the script runs it beside the
    # next card phase: the same numbers once drained
    behind = cs.Behind(torch)
    cs.train_devices_phase(torch, rg, detail, dev="cpu", behind=behind,
                           cfg=get_smoke(ARCH, n_layers=5, dtype="float32", remat="full"))
    behind.drain()
    again = detail[f"train_card_vs_cpu_{ARCH}"]
    assert again["cpu_half_beside_later_phases"]
    assert {k: again[k] for k in ("launches", "grad_err", "adamw_err", "loss_cpu")} == {
        k: rec[k] for k in ("launches", "grad_err", "adamw_err", "loss_cpu")}
