"""Serving on a mesh, on the CPU: the port against the JAX package.

One run of 4 gloo processes (``torch_dist_workers.spawn``; a 2x2
``("data", "model")`` mesh) and, at the same time, one JAX subprocess with 4
forced host devices serve every case: float32 smoke configs with the JAX
package's weights (norm scales and QKV biases perturbed), a prefill of 4
prompts (2 rows a rank: ``data`` splits the batch) and 4 greedy decode
steps. JAX places the weights and the prompts in its specs (``param_specs``,
``input_specs``) and runs ``prefill(cfg, plan, ...)`` and
``make_serve_step(cfg, plan)`` jitted; the port places the same weights with
``runtime.place_on_mesh`` and runs ``prefill`` / ``decode_step`` on each
rank's rows. Cases:

  - qwen2 ``seq_tp``: the residual stream in sequence blocks, K/V gathered,
    the KV cache's slots split over ``model`` (14 of 28 a rank);
  - gemma3 on the grouped einsum and on the blocked path, S 32 in blocks of
    16 with a window of 12 crossing the blocks' boundary (tiles of 8 / 16
    that divide the block); the blocked case with a cache of 16 slots, so
    that decode writes past a full layer's end (slot 15, rank 1's) and wraps
    the sliding layers' ring buffer (slot 0, rank 0's);
  - recurrentgemma under head TP (1 head a rank, S 64 past its window of
    32); its KV heads do not divide ``model``, so it decodes;
  - arctic, 2 of its 4 experts a rank, also in decode;
  - whisper, whose cross caches' 16 frames are split too;
  - xlstm (the mLSTM's ``C`` held whole, by batch rows);
  - kimi, with its dense prefix layer's cache;
  - qwen2 under ``ddp`` at a global batch of 2, which leaves ``model`` to
    the sequence;
  - qwen2 with a cache of 27 slots, which ``model`` does not divide: each
    rank keeps the whole cache and combines nothing;
  - qwen2 under head TP (its 2 KV heads divide ``model``): JAX's decode
    raises ``DuplicateSpecError`` and the port's ``ValueError`` there
    (ROADMAP Queue C).

Gates: the tokens equal JAX's and the meshless port's; every step's logits
within ``TOL`` of the largest |logit| of both; the final cache, gathered
whole (``interop.gather_cache``) and in the JAX layout, within ``TOL`` of
the largest |value| of each of JAX's leaves. Under head TP JAX's decode
misses its repeated KV heads (``HEAD_TP``), so there the decode and the
cache are held to JAX's meshless serve. ``TOL`` is 1e-5 as float32
reorders the sums (the meshless port and JAX's own 2x2 run differ by
less). Also the decode combine on the
model axis's ranks, and phase 49 of ``chip_smoke.py`` rehearsed. The spec
twins (``sharding.cache_specs`` / ``input_specs``) are held to JAX's in
``tests/test_torch_sharding.py``.
"""
import dataclasses
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import init_params as jax_init
from repro_torch.configs import get_smoke
from repro_torch.interop import cache_to_jax, model_from_jax
from repro_torch.launch.serve import prompt_batch
from repro_torch.models import decode_step, prefill
from test_torch_distributed import ROOT, _finish, _jax_subprocess
from torch_dist_workers import mesh_serve, spawn
from torch_threads import one_thread

one_thread()

TOL = 1e-5
MESH_2x2 = ((2, 2), ("data", "model"))
FP32 = {"dtype": "float32", "param_dtype": "float32"}
GEMMA = {**FP32, "window": 12}
BLOCKED = {**GEMMA, "attention_impl": "blocked", "attention_block_q": 8,
           "attention_block_kv": 16}
#: name, arch, config overrides, global batch, prompt length, decode steps,
#: cache slots
CASES = (
    ("qwen2_seq", "qwen2-1.5b", FP32, 4, 16, 4, 28),
    ("gemma3_xla", "gemma3-4b", GEMMA, 4, 32, 4, 44),
    ("gemma3_blocked", "gemma3-4b", BLOCKED, 4, 32, 4, 16),
    ("recurrentgemma_head", "recurrentgemma-2b", {**FP32, "attn_parallelism": "head"},
     4, 64, 4, 76),
    ("arctic", "arctic-480b", FP32, 4, 16, 4, 28),
    ("whisper", "whisper-tiny", FP32, 4, 16, 4, 28),
    ("xlstm", "xlstm-350m", FP32, 4, 16, 4, 28),
    ("kimi", "kimi-k2-1t-a32b", FP32, 4, 16, 4, 28),
    ("qwen2_ddp", "qwen2-1.5b", {**FP32, "attn_parallelism": "ddp"}, 2, 16, 4, 28),
    ("qwen2_odd_cache", "qwen2-1.5b", FP32, 4, 16, 4, 27),
    ("qwen2_head", "qwen2-1.5b", {**FP32, "attn_parallelism": "head"}, 4, 16, 4, 28),
)
SERVED = [c[0] for c in CASES if c[0] != "qwen2_head"]
#: JAX's head-TP prefill caches each KV head repeated to its query heads,
#: and its decode writes a token's K/V into the first copy only
#: (``attention_decode``'s ``dynamic_update_slice`` of an ``n_kv_heads``
#: update into an ``n_heads`` cache), so its later query heads miss the
#: decoded tokens (ROADMAP Queue C): these cases' decode is held to JAX's
#: meshless serve, their prefill to its 2x2 serve
HEAD_TP = {"recurrentgemma_head"}

JAX_SERVE = """
import dataclasses, json, os, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_smoke
from repro.distributed.sharding import make_plan
from repro.launch.mesh import make_test_mesh
from repro.models import prefill
from repro.models.model import input_specs
from repro.runtime import make_serve_step
from repro.runtime.trainstep import param_specs

root = sys.argv[1]
mesh = make_test_mesh((2, 2), ("data", "model"))
status = {}
for name, arch, over, B, S, steps, cache_len in json.loads(sys.argv[2]):
    cfg = dataclasses.replace(get_smoke(arch), **over)
    plan = make_plan(mesh, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                     prefer=cfg.attn_parallelism, global_batch=B)
    with open(os.path.join(root, name + ".pkl"), "rb") as f:
        data = pickle.load(f)
    params = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)),
                          data["params"], param_specs(cfg, plan, data["params"]))
    specs = input_specs(cfg, S, B, "prefill", plan)
    batch = {"tokens": data["prompts"]}
    if data["frames"] is not None:
        batch["frames"] = data["frames"]
    batch = {k: jax.device_put(jnp.asarray(v), specs[k].sharding) for k, v in batch.items()}


    def serve(plan, params, batch):
        out = {"logits": []}
        cache, logits = jax.jit(lambda p, b: prefill(cfg, plan, p, b, cache_len))(params, batch)
        step = jax.jit(make_serve_step(cfg, plan))
        toks = []
        for i in range(steps + 1):
            out["logits"].append(np.asarray(logits))
            tok = jnp.argmax(logits[:, -1, :cfg.vocab], axis=-1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(tok))
            if i < steps:
                cache, _, logits = step(params, cache, tok)
        out["tokens"] = np.concatenate(toks, axis=1)
        out["cache"] = jax.tree.map(np.asarray, cache)
        return out

    out = {"logits": []}
    try:
        out = serve(plan, params, batch)
        status[name] = "ok"
    except Exception as e:
        status[name] = type(e).__name__
    if cfg.attn_parallelism == "head" and status[name] == "ok":
        meshless = make_plan(None, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
        out["meshless"] = serve(meshless, data["params"], {k: np.asarray(v)
                                                           for k, v in batch.items()})
    with open(os.path.join(root, name + ".jax.pkl"), "wb") as f:
        pickle.dump(out, f)
print(json.dumps(status))
"""


def _perturbed(params, rng):
    """The JAX params as float32 numpy with every norm scale and QKV bias
    moved off its init (ones, zeros), so the serving paths use them."""
    def leaf(path, a):
        a = np.asarray(a, np.float32)
        name = str(getattr(path[-1], "key", ""))
        if name in ("scale", "bq", "bk", "bv", "norm"):
            a = a + rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


def _cfg(arch, over):
    return dataclasses.replace(get_smoke(arch), **over)


def _meshless(cfg, data, steps, cache_len):
    """The meshless port's greedy run on the same weights and prompts."""
    model = model_from_jax(cfg, data["params"], device="cpu")
    frames = torch.from_numpy(data["frames"]) if data["frames"] is not None else None
    prompts = torch.from_numpy(data["prompts"]).long()
    logits_all, toks = [], []
    with torch.inference_mode():
        cache, logits = prefill(model, prompt_batch(model, prompts, frames), cache_len)
        for i in range(steps + 1):
            logits_all.append(logits.numpy())
            tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
            toks.append(tok)
            if i < steps:
                cache, logits = decode_step(model, cache, tok)
    return {"tokens": torch.cat(toks, dim=1).numpy(), "logits": logits_all,
            "cache": cache_to_jax(model, cache)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's weights and prompts written for both sides; then at once
    the JAX 2x2 runs (a subprocess) and the port's 4 ranks."""
    root = tmp_path_factory.mktemp("mesh_serve")
    rng = np.random.default_rng(0)
    data = {}
    for seed, (name, arch, over, B, S_, steps, cache_len) in enumerate(CASES):
        jcfg = dataclasses.replace(jax_smoke(arch), **over)
        params = _perturbed(jax_init(jcfg, jax.random.PRNGKey(seed)), rng)
        prompts = rng.integers(2, jcfg.vocab, (B, S_)).astype(np.int32)
        frames = (rng.standard_normal((B, S_, jcfg.d_model)).astype(np.float32)
                  if jcfg.encoder_layers else None)
        data[name] = {"params": params, "prompts": prompts, "frames": frames}
        with open(root / f"{name}.pkl", "wb") as f:
            pickle.dump(data[name], f)
        os.makedirs(root / "ranks", exist_ok=True)
        torch.save(data[name], root / "ranks" / f"{name}.pt")
    jax_proc = _jax_subprocess(JAX_SERVE, [root, json.dumps(CASES)])
    ranks = spawn(mesh_serve, 4, root / "ranks",
                  [(n, a, o, st, cl) for n, a, o, _, _, st, cl in CASES], *MESH_2x2,
                  timeout=300)
    status = _finish(jax_proc, 300)
    jx = {}
    for name, *_ in CASES:
        with open(root / f"{name}.jax.pkl", "rb") as f:
            jx[name] = pickle.load(f)
    return {"data": data, "ranks": ranks, "jax": jx, "status": status}


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, t in tree.items() for k2, v in _leaves(t, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _leaves(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("name", SERVED)
def test_mesh_serving_matches_the_jax_2x2_serve(runs, name):
    assert runs["status"][name] == "ok"
    want = runs["jax"][name]
    if name in HEAD_TP:
        assert _rel(want["meshless"]["logits"][0], want["logits"][0]) < TOL
        want = want["meshless"]
    for r in runs["ranks"]:  # every rank gets the whole batch's tokens and logits
        got = r[name]
        assert got["error"] is None, got["error"]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert len(got["logits"]) == len(want["logits"])
        for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            assert _rel(a, b) < TOL, (step, _rel(a, b))


@pytest.mark.parametrize("name", SERVED)
def test_mesh_serving_matches_the_meshless_port(runs, name):
    _, arch, over, _, _, steps, cache_len = _case(name)
    want = _meshless(_cfg(arch, over), runs["data"][name], steps, cache_len)
    got = runs["ranks"][0][name]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        assert _rel(a, b) < TOL, (step, _rel(a, b))
    gl, wl = _leaves(got["cache"]), _leaves(want["cache"])
    assert sorted(gl) == sorted(wl)
    for k in wl:
        assert gl[k].shape == wl[k].shape, k
        assert _rel(gl[k], wl[k]) < TOL if np.abs(wl[k]).max() else not gl[k].any(), k


def test_jax_s_head_tp_decode_misses_the_repeated_kv_heads(runs):
    """The limit of the reference that ``HEAD_TP`` works around: in JAX's
    2x2 head-TP serve the second copy of the KV head holds zeros at every
    decoded slot (16 prompt positions are written, then 4 tokens), and its
    decode logits leave its meshless serve's, which the port's match."""
    name = "recurrentgemma_head"
    _, _, _, _, S_, steps, _ = _case(name)
    jx = runs["jax"][name]
    k = jx["cache"]["units"]["p2"]["mixer"]["k"]  # (units, B, L, n_heads, D)
    assert k.shape[-2] == 2
    assert np.abs(k[..., S_:S_ + steps, 0, :]).min(axis=-1).max() > 0
    assert not k[..., S_:S_ + steps, 1, :].any() and k[..., :S_, 1, :].any()
    assert _rel(jx["logits"][1], jx["meshless"]["logits"][1]) > 10 * TOL


@pytest.mark.parametrize("name", SERVED)
def test_the_gathered_cache_matches_jax_s(runs, name):
    jx = runs["jax"][name]
    gl, wl = _leaves(runs["ranks"][0][name]["cache"]), _leaves(
        jx["meshless"]["cache"] if name in HEAD_TP else jx["cache"])
    assert sorted(gl) == sorted(wl)
    for k in wl:
        g = gl[k]
        assert g.shape == wl[k].shape, (k, g.shape, wl[k].shape)
        assert _rel(g, wl[k]) < TOL if np.abs(wl[k]).max() else not g.any(), k
    for r in runs["ranks"][1:]:  # every rank gathers the same cache
        for k, v in _leaves(r[name]["cache"]).items():
            np.testing.assert_array_equal(v, gl[k])


@pytest.mark.parametrize("name", SERVED)
def test_each_rank_holds_its_block_of_the_cache(runs, name):
    """Rows: half the global batch a rank. Slots of the first attention
    cache: half the cache where ``model`` divides it (the prefill's
    caches have ``cache_len`` slots, sliding layers too), all of it where
    it does not; none for xlstm, which has no attention layer."""
    _, arch, over, B, _, _, cache_len = _case(name)
    for r in runs["ranks"]:
        kv = r[name]["local_kv"]
        if arch == "xlstm-350m":
            assert kv is None
            continue
        slots = cache_len // 2 if cache_len % 2 == 0 else cache_len
        assert kv[:2] == (B // 2, slots), kv


def test_head_tp_decode_refuses_where_jax_raises(runs):
    assert runs["status"]["qwen2_head"] == "DuplicateSpecError"
    for r in runs["ranks"]:
        err = r["qwen2_head"]["error"]
        assert err is not None and "DuplicateSpecError" in err
        assert len(r["qwen2_head"]["logits"]) == 1  # the prefill ran, decode refused


def test_generate_on_a_mesh_returns_the_whole_batch_on_every_rank(runs):
    """``launch.serve.generate`` on the placed model (qwen2, the first case,
    whose cache of 28 slots is S + steps + 8): every rank returns the
    global batch's tokens, JAX's 2x2 serve's, having served its 2 rows, and
    its record counts the prefill's and the decode's collectives by kind
    ([calls, bytes]): parameter gathers, the masked lookup's sums and the
    combine's max in decode, each at least once a step."""
    name, _, _, B, _, steps, cache_len = CASES[0]
    assert cache_len == 16 + steps + 8
    for r in runs["ranks"]:
        g = r["generate"]
        np.testing.assert_array_equal(g["tokens"], runs["jax"][name]["tokens"])
        assert g["rows"] == (2 * r["coordinate"][0], 2 * r["coordinate"][0] + 2)
        assert g["prefill_collectives"]["all_gather"][0] > 0
        dec = g["decode_collectives"]
        assert dec["all_reduce_max"][0] >= steps and dec["all_reduce"][0] >= steps
        assert all(n > 0 and b > 0 for n, b in dec.values())


def test_a_mesh_of_another_device_type_is_refused():
    """``place_on_mesh`` raises, as the ``Trainer`` does, when the mesh's
    device type is not the model's."""
    from repro_torch.models import init_params
    from repro_torch.runtime import place_on_mesh

    class CudaMesh:
        device_type = "cuda"

    model = init_params(_cfg("qwen2-1.5b", FP32), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cuda"):
        place_on_mesh(model, CudaMesh(), 4)


@pytest.mark.parametrize("which", ["combine", "combine_dead"])
def test_the_decode_combine_is_one_softmax_over_every_rank_s_keys(runs, which):
    """Each model rank's block of the keys (12 of 24), float64: the combined
    output equals the softmax over all keys on every rank, also where one
    rank's keys are all masked."""
    for r in runs["ranks"]:
        c = r[which]
        p = torch.softmax(c["scores"], dim=-1)
        want = torch.einsum("bkgst,btkd->bskgd", p, c["v"]).reshape(c["out"].shape)
        torch.testing.assert_close(c["out"], want, rtol=1e-12, atol=1e-12)


def test_chip_smoke_phase_49_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 49 on the CPU: gemma3 smoke on the blocked
    path (window 12, tiles of 8 / 16, float32), B 2 x 32 and 4 decode
    steps (44 cache slots, 22 a rank) on two gloo ranks of a (1, 2) mesh against the meshless port in
    this process; the flash kernel's plain version counted as the launch
    (``layers._on_kernel`` widened to CPU tensors), the planted faults
    failing the gates."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    detail = {}
    cfg = _cfg("gemma3-4b", {**BLOCKED, "param_dtype": "float32"})
    out = chip_smoke.mesh_serve_phase(torch, detail, dev="cpu", cfg=cfg, shape=(2, 32, 4))
    assert detail["mesh_serve"] is out
    assert not torch.distributed.is_initialized()
    n_attn = cfg.n_layers
    for r, got in enumerate(out["ranks"]):
        assert got["flash"]["prefill"] == n_attn and got["flash"]["decode"] == 0
        assert got["flash"]["offsets"] == [16 * r] * n_attn
        assert got["plain_blocked"] == 0
    assert out["meshless"]["flash"]["prefill"] == n_attn
    for gate, err in out["errors"].items():
        assert err <= out["tol"], (gate, err)
    assert set(out["planted"]) == {"no_global_max", "global_slot", "no_offset"}
    for name, p in out["planted"].items():
        assert p["failed"], (name, p)
