"""The port's sharding plan, specs and meshes vs the JAX package's, on the CPU.

- ``make_plan``: both packages' plans built on one stub mesh (JAX's
  ``mesh_shape_of`` reads ``axis_names`` and ``devices``, the port's
  ``mesh_dim_names`` and ``shape``) for meshes (16, 16), (2, 16, 16),
  (2, 2), (2, 2, 2), (1, 2) and (4,), prefer ``auto`` / ``head`` / ``ddp``
  and global batch None, 1, 4, 256 and 6: every field and every method's
  answer over a range of sizes equal. One exception: on a 1-D mesh JAX's
  ``fsdp_dim`` raises ``IndexError`` (no data axis) where the port gives
  None;
- ``param_specs`` / ``state_specs`` (AdamW and Adafactor) for all ten full
  configs against JAX's over ``jax.eval_shape``, leaf by leaf, on (16, 16),
  (2, 16, 16) and (2, 2) and without a mesh: equal, the port's leaves on
  the meta device;
- each rank's block (``zero.Placed``) on every coordinate of (2, 2) and
  (2, 16, 16): the global shape divided over the spec's axes, the blocks
  tiling the tensor;
- ``make_production_mesh`` raises below 256 / 512 ranks, naming the size;
  ``hardware_constants`` are the H100's.
"""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.distributed.sharding import make_plan as jax_make_plan
from repro.models import init_params as jax_init
from repro.optim import make_optimizer as jax_make_optimizer
from repro.runtime.trainstep import TrainState as JaxTrainState
from repro.runtime.trainstep import param_specs as jax_param_specs
from repro.runtime.trainstep import state_specs as jax_state_specs
from repro_torch.configs import get_config
from repro_torch.distributed import ShardingPlan, make_plan, spec_to_sharding
from repro_torch.distributed.zero import Placed
from repro_torch.launch.mesh import hardware_constants, make_production_mesh
from repro_torch.models.model import Model, param_leaves
from repro_torch.optim import make_optimizer
from repro_torch.runtime.trainstep import param_specs, state_specs, unit_spec
from torch_threads import one_thread

one_thread()

ARCHS = ("recurrentgemma-2b", "qwen2-1.5b", "gemma3-4b", "xlstm-350m", "yi-9b",
         "phi4-mini-3.8b", "phi-3-vision-4.2b", "whisper-tiny", "arctic-480b",
         "kimi-k2-1t-a32b")
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2): ("data", "model"), (2, 2, 2): ("pod", "data", "model"),
          (1, 2): ("data", "model"), (4,): ("data",)}
SIZES = list(range(1, 130)) + [256, 384, 512, 1536, 2560, 8960, 151936, 262144]


class StubMesh:
    """A mesh as both packages' plans read it, with a rank's coordinate
    for ``Placed``."""

    def __init__(self, shape, axes, coordinate=None):
        self.axis_names = self.mesh_dim_names = tuple(axes)
        self.devices = np.zeros(shape)
        self.shape = tuple(shape)
        self.ndim = len(shape)
        self._coord = coordinate

    def size(self, d):
        return self.shape[d]

    def get_coordinate(self):
        return self._coord


def _call(fn, n):
    try:
        return fn(n)
    except IndexError:
        return IndexError


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(map(str, s)))
def test_make_plan_is_the_jax_plan(shape):
    mesh = StubMesh(shape, MESHES[shape])
    for prefer, batch, (h, kv) in itertools.product(
            ("auto", "head", "ddp"), (None, 1, 4, 256, 6), ((12, 2), (32, 8), (16, 16), (6, 2))):
        j = jax_make_plan(mesh, n_heads=h, n_kv_heads=kv, prefer=prefer, global_batch=batch)
        p = make_plan(mesh, n_heads=h, n_kv_heads=kv, prefer=prefer, global_batch=batch)
        assert isinstance(p, ShardingPlan) and p.mesh is mesh
        for f in ("attn_mode", "kv_heads_sharded", "heads_sharded", "ddp_seq_over_model"):
            assert getattr(p, f) == getattr(j, f), f
        assert (p.shape.data_axes, p.shape.model_axis, p.shape.sizes) == (
            j.shape.data_axes, j.shape.model_axis, j.shape.sizes)
        assert (p.shape.data_size, p.shape.model_size) == (j.shape.data_size, j.shape.model_size)
        for method in ("batch", "model_dim", "fsdp_dim", "heads", "seq"):
            for n in SIZES:
                want = _call(getattr(j, method), n)
                got = getattr(p, method)(n)
                if want is IndexError:  # JAX's fsdp_dim on a mesh without a data axis
                    assert method == "fsdp_dim" and len(shape) == 1 and got is None
                else:
                    assert got == want, (method, n, prefer, batch)


def test_the_meshless_plan_is_the_jax_one():
    j = jax_make_plan(None, n_heads=12, n_kv_heads=2)
    p = make_plan(None, n_heads=12, n_kv_heads=2)
    assert (p.mesh, p.shape, p.attn_mode, p.kv_heads_sharded, p.heads_sharded) == (
        None, None, j.attn_mode, j.kv_heads_sharded, j.heads_sharded)
    x = torch.ones(3)
    assert p.constrain(x, "data") is x and p.sharding("data") is None
    assert p.batch(8) is None and p.model_dim(8) is None and p.seq(8) is None


def _jax_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): v
            for path, v in flat}


class _State:
    def __init__(self, params, opt_state):
        self.params, self.opt_state = params, opt_state


@pytest.fixture(scope="module")
def jax_shapes():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jax_config(arch)
            params = jax.eval_shape(lambda: jax_init(cfg, jax.random.PRNGKey(0)))
            states = {o: jax.eval_shape(lambda o=o: jax_make_optimizer(o).init(
                jax_init(cfg, jax.random.PRNGKey(0)))) for o in ("adamw", "adafactor")}
            cache[arch] = (cfg, params, states)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_are_the_jax_specs(arch, jax_shapes):
    jcfg, jparams, jstates = jax_shapes(arch)
    cfg = get_config(arch)
    leaves = param_leaves(Model(cfg, device="meta", trainable=True))
    states = {o: make_optimizer(o).init(leaves) for o in ("adamw", "adafactor")}
    for shape in ((16, 16), (2, 16, 16), (2, 2), None):
        mesh = None if shape is None else StubMesh(shape, MESHES[shape])
        jplan = jax_make_plan(mesh, n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads,
                              prefer=jcfg.attn_parallelism)
        plan = make_plan(mesh, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                         prefer=cfg.attn_parallelism)
        want = {k: tuple(v) for k, v in _jax_paths(jax_param_specs(jcfg, jplan, jparams)).items()}
        assert param_specs(cfg, plan, leaves) == want, shape
        for o in ("adamw", "adafactor"):
            jstate = JaxTrainState(jparams, jstates[o], jnp.zeros((), jnp.int32))
            jspecs = jax_state_specs(jcfg, jplan, jstate)
            got = state_specs(cfg, plan, _State(leaves, states[o]))
            assert got.params == want
            assert got.opt_state == {k: tuple(v) for k, v in
                                     _jax_paths(jspecs.opt_state).items()}, (shape, o)
            assert got.step == tuple(jspecs.step)


@pytest.mark.parametrize("shape", [(2, 2), (2, 16, 16)], ids=["2x2", "2x16x16"])
def test_each_block_is_the_global_shape_divided_over_the_spec_axes(shape):
    cfg = get_config("qwen2-1.5b")
    leaves = param_leaves(Model(cfg, device="meta", trainable=True))
    plan = make_plan(StubMesh(shape, MESHES[shape]), n_heads=cfg.n_heads,
                     n_kv_heads=cfg.n_kv_heads)
    specs = param_specs(cfg, plan, leaves)
    sizes = dict(zip(MESHES[shape], shape))
    coords = list(itertools.product(*(range(n) for n in shape)))
    split_any = False
    for path, ts in leaves.items():
        gshape = tuple(ts[0].shape)
        spec = unit_spec(path, specs[path])
        want = tuple(n // int(np.prod([sizes[a] for a in
                                       ((() if e is None else (e,) if isinstance(e, str) else e))]))
                     for n, e in zip(gshape, spec + (None,) * (len(gshape) - len(spec))))
        cover = torch.zeros(gshape, dtype=torch.int32) if np.prod(gshape) < 2 ** 22 else None
        blocks = set()
        for c in coords:
            pl = Placed(StubMesh(shape, MESHES[shape], list(c)), spec, gshape)
            assert pl.local_shape == want, path
            blocks.add(tuple((s.start, s.stop) for s in pl.index))
            split_any |= bool(pl.split)
            if cover is not None:
                cover[pl.index] += 1
        n_blocks = int(np.prod(gshape) // np.prod(want))
        assert len(blocks) == n_blocks, path
        if cover is not None:  # the distinct blocks tile the tensor
            assert int(cover.min()) == int(cover.max()) == len(coords) // n_blocks, path
    assert split_any


def test_spec_to_sharding_names_the_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = StubMesh((2, 2, 2), ("pod", "data", "model"))
    assert spec_to_sharding(mesh, ("model", "data")) == (Replicate(), Shard(1), Shard(0))
    assert spec_to_sharding(mesh, (("pod", "data"), None)) == (Shard(0), Shard(0), Replicate())
    assert spec_to_sharding(mesh, ()) == (Replicate(),) * 3
    assert spec_to_sharding(None, ("data",)) is None
    with pytest.raises(ValueError, match="mesh's axis order"):
        spec_to_sharding(mesh, (("data", "pod"),))


@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_the_production_mesh_needs_its_ranks(multi_pod, n):
    with pytest.raises(RuntimeError, match=f"need {n} ranks.*--nproc-per-node {n}"):
        make_production_mesh(multi_pod=multi_pod)


def test_hardware_constants_are_the_h100_datasheet():
    hw = hardware_constants()
    assert hw == {"peak_flops": 989e12, "hbm_gbps": 3.35e12, "nvlink_gbps": 450e9,
                  "hbm_gib": 80.0}


# ---------------------------------------------------------------------------
# the cache and input specs (the JAX input_specs / cache_specs twins)
# ---------------------------------------------------------------------------

SPEC_MESHES = (None, (2, 2), (1, 2))
#: (batch, cache slots or prompt length): a batch of 8 is recurrentgemma-2b's
#: ``n_units``, so its tail state reads as a stacked leaf in both packages
SPEC_SIZES = ((8, 2064), (4, 1500))

JAX_SPECS = """
import json, sys
from repro.configs import get_config
from repro.distributed.sharding import make_plan
from repro.launch.mesh import make_test_mesh
from repro.models.model import cache_specs, input_specs


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, t in tree.items() for k2, v in leaves(t, prefix + k + "/").items()}
    if isinstance(tree, list):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in leaves(t, prefix + str(i) + "/").items()}
    spec = getattr(getattr(tree, "sharding", None), "spec", None)
    if spec is not None:
        spec = [list(e) if isinstance(e, tuple) else e for e in spec]
        spec += [None] * (len(tree.shape) - len(spec))
    return {prefix[:-1]: [list(tree.shape), str(tree.dtype), spec]}


out = {}
for arch in json.loads(sys.argv[1]):
    cfg = get_config(arch)
    for mesh in json.loads(sys.argv[2]):
        plan = None if mesh is None else make_plan(
            make_test_mesh(tuple(mesh), ("data", "model")), n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads)
        for B, L in json.loads(sys.argv[3]):
            rec = {"cache": leaves(cache_specs(cfg, plan, B, L))}
            for kind in ("train", "prefill"):
                rec[kind] = leaves(input_specs(cfg, L, B, kind, plan))
            out[f"{arch}|{mesh}|{B}|{L}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_specs():
    """JAX's ``cache_specs`` and ``input_specs`` of every full config on
    real 2x2 and 1x2 meshes (a subprocess with 4 forced host devices)."""
    import json

    from test_torch_distributed import _finish, _jax_subprocess

    proc = _jax_subprocess(JAX_SPECS, [json.dumps(ARCHS), json.dumps(SPEC_MESHES),
                                       json.dumps(SPEC_SIZES)])
    return _finish(proc, 240)


def _spec_leaves(tree, prefix=""):
    from repro_torch.distributed.sharding import LeafSpec

    if isinstance(tree, dict):
        return {k2: v for k, t in tree.items()
                for k2, v in _spec_leaves(t, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _spec_leaves(t, f"{prefix}{i}/").items()}
    assert isinstance(tree, LeafSpec)
    # a ``PartitionSpec`` reads a one-axis tuple back as the axis's name
    spec = None if tree.spec is None else [
        (e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple) else e for e in tree.spec]
    return {prefix[:-1]: [list(tree.shape), tree.dtype, spec]}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SPEC_MESHES)
def test_cache_and_input_specs_equal_jax_s(jax_specs, arch, shape):
    """``cache_specs`` (through ``cache_leaf_spec``, keyed by the leaves'
    shapes) and ``input_specs`` for train and prefill, leaf by leaf, equal
    JAX's: shapes, dtypes and specs, without a mesh and on (2, 2) and
    (1, 2); the port's cache built on the meta device."""
    from repro_torch.distributed.sharding import cache_specs, input_specs

    cfg = get_config(arch)
    plan = None if shape is None else make_plan(
        StubMesh(shape, ("data", "model")), n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    for B, L in SPEC_SIZES:
        want = jax_specs[f"{arch}|{list(shape) if shape else None}|{B}|{L}"]
        assert _spec_leaves(cache_specs(cfg, plan, B, L)) == want["cache"]
        for kind in ("train", "prefill"):
            assert _spec_leaves(dict(input_specs(cfg, L, B, kind, plan))) == want[kind]


def test_the_shape_keyed_rule_reads_these_leaves_as_jax_does(jax_specs):
    """The limits of the reference that the twin keeps (ROADMAP Queue C):
    xlstm-350m's mLSTM memory ``C`` (B, 4, 512, 512) is read as a KV cache,
    its 4 heads split over ``model`` as if slots, and recurrentgemma-2b's
    tail state (8, 2560) at a batch of 8, its ``n_units``, is read as
    stacked: ``(None, "data")``. The port's serving stores both whole by
    batch rows (``RankView.cache`` splits only attention and cross caches,
    ``tests/test_torch_mesh_serve.py``)."""
    xl = jax_specs["xlstm-350m|[2, 2]|8|2064"]["cache"]
    assert xl["units/p0/mixer/C"] == [[12, 8, 4, 512, 512], "float32",
                                      [None, "data", "model", None, None]]
    rg = jax_specs["recurrentgemma-2b|[2, 2]|8|2064"]["cache"]
    assert rg["tail/0/mixer/h"] == [[8, 2560], "float32", [None, "data"]]
