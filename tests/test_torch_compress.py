"""The port's int8 error-feedback compression vs the JAX package's, on the CPU.

- ``ef_int8_compress`` / ``ef_int8_decompress`` / ``init_error_state`` on
  seeded numpy leaves in float32 and bfloat16, with a carried error, an
  all-zero leaf (the scale's 1e-12 floor) and quotients on exact .5 ties
  (both round half to even): ``q`` and ``scale`` bit for bit, ``new_err``
  within one float32 ulp of its magnitude (XLA may fuse the multiply and
  the subtract of ``gc - q * scale``);
- ``compressed_psum_tree`` on 4 gloo ranks (``torch_dist_workers.spawn``)
  against JAX's ``shard_map`` on 4 forced host devices, on JAX's own test
  inputs (``arange(32) / 7.3`` in four rows), two steps: the sums within
  1e-6 of max |exact| of JAX's, each rank's error within the same of
  JAX's, and JAX's own checks (within 5% of the exact sum, residual under
  0.02); over the two steps the error feedback shrinks the bias.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.optim.compress import ef_int8_compress as jax_compress
from repro.optim.compress import ef_int8_decompress as jax_decompress
from repro.optim.compress import init_error_state as jax_init_error
from repro_torch.optim import ef_int8_compress, ef_int8_decompress
from repro_torch.optim.compress import init_error_state
from torch_dist_workers import compressed_psum, spawn
from torch_threads import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSUM_TOL = 1e-6


def _leaf(kind, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        g = rng.standard_normal((7, 33)).astype(np.float32) * 3.0
    elif kind == "zero":
        g = np.zeros((5, 4), np.float32)
    else:  # max 127 gives scale 1: every quotient is the value itself, ties .5
        g = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -126.5]],
                     np.float32)
    err = (rng.standard_normal(g.shape) * 1e-2).astype(np.float32) if kind == "normal" \
        else np.zeros(g.shape, np.float32)
    return g, err, dtype


CASES = [_leaf(k, d) for k in ("normal", "zero", "ties") for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("g,err,dtype", CASES,
                         ids=[f"{k}-{d}" for k in ("normal", "zero", "ties")
                              for d in ("float32", "bfloat16")])
def test_compress_is_the_jax_compress(g, err, dtype):
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jq, js, je = jax_compress(jg, jnp.asarray(err))
    q, s, e = ef_int8_compress(tg, torch.from_numpy(err))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    assert e.dtype == torch.float32 and e.shape == tg.shape
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    ulp = np.spacing(np.maximum(np.abs(np.asarray(je)), np.float32(1e-30)))
    assert np.all(np.abs(e.numpy() - np.asarray(je)) <= ulp)
    assert np.array_equal(ef_int8_decompress(q, s).numpy(),
                          np.asarray(jax_decompress(jq, js)))


def test_ties_round_half_to_even():
    g, err, _ = _leaf("ties", "float32")
    q, s, _ = ef_int8_compress(torch.from_numpy(g), torch.from_numpy(err))
    assert float(s) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4, 126, -126]]


def test_the_zero_leaf_keeps_the_scale_floor():
    g, err, _ = _leaf("zero", "float32")
    q, s, e = ef_int8_compress(torch.from_numpy(g), torch.from_numpy(err))
    assert float(s) == np.float32(np.float32(1e-12) / np.float32(127.0))
    assert not q.any() and not e.any()


def test_init_error_state_is_the_jax_one():
    leaves = {"a": [torch.zeros(3, 4, dtype=torch.bfloat16)], "units/w": [torch.ones(2)] * 3}
    got = init_error_state(leaves)
    want = jax_init_error({"a": jnp.zeros((3, 4), jnp.bfloat16)})
    assert got["a"][0].dtype == torch.float32 and not got["a"][0].any()
    assert got["a"][0].shape == want["a"].shape and want["a"].dtype == jnp.float32
    assert [t.shape for t in got["units/w"]] == [torch.Size([2])] * 3


JAX_PSUM = """
import json
import jax, jax.numpy as jnp, numpy as np
from repro.optim.compress import compressed_psum_tree

mk = {"axis_types": (jax.sharding.AxisType.Auto,)} if hasattr(jax.sharding, "AxisType") else {}
mesh = jax.make_mesh((4,), ("data",), **mk)
P = jax.sharding.PartitionSpec
f = jax.jit(jax.shard_map(lambda g, e: compressed_psum_tree(g, e, "data"), mesh=mesh,
                          in_specs=({"w": P("data")}, {"w": P("data")}),
                          out_specs=({"w": P()}, {"w": P("data")}), check_vma=False))
gs = {"w": jnp.arange(32.0).reshape(4, 8) / 7.3}
red1, err1 = f(gs, {"w": jnp.zeros((4, 8))})
red2, err2 = f(gs, err1)
print(json.dumps({"red": [np.asarray(red1["w"]).tolist(), np.asarray(red2["w"]).tolist()],
                  "err": [np.asarray(err1["w"]).tolist(), np.asarray(err2["w"]).tolist()]}))
"""


@pytest.fixture(scope="module")
def psum(tmp_path_factory):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", JAX_PSUM], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    rows = np.asarray(jnp.arange(32.0).reshape(4, 8) / 7.3, np.float32)
    ranks = spawn(compressed_psum, 4, tmp_path_factory.mktemp("psum"), rows)
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    return {"ranks": ranks, "jax": json.loads(out.strip().splitlines()[-1]), "rows": rows}


def test_compressed_psum_matches_the_jax_shard_map(psum):
    exact = psum["rows"].sum(axis=0, keepdims=True)
    scale = float(np.abs(exact).max())
    for r, got in enumerate(psum["ranks"]):
        for step in range(2):
            want = np.asarray(psum["jax"]["red"][step], np.float32)
            assert np.max(np.abs(got["red"][step] - want)) <= PSUM_TOL * scale
            want_err = np.asarray(psum["jax"]["err"][step], np.float32)[r:r + 1]
            assert np.max(np.abs(got["err"][step] - want_err)) <= PSUM_TOL * scale


def test_compressed_psum_passes_the_jax_checks_and_feedback_shrinks_the_bias(psum):
    exact = psum["rows"].sum(axis=0, keepdims=True)
    got = psum["ranks"][0]
    rel = float(np.max(np.abs(got["red"][0] - exact)) / (np.max(np.abs(exact)) + 1e-9))
    assert rel < 0.05
    assert max(float(np.abs(r["err"][0]).max()) for r in psum["ranks"]) < 0.02
    one = float(np.abs(got["red"][0] - exact).max())
    two = float(np.abs((got["red"][0] + got["red"][1]) / 2 - exact).max())
    assert two < one
