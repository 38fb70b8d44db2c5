"""Multi-pod dry-run: trace every (architecture x input shape) cell on the
production meshes and report memory, FLOPs, bytes and collectives per card.
The port of ``repro.launch.dryrun``.

The JAX dry-run forces 512 host devices, compiles each cell's step for the
``(16, 16)`` or ``(2, 16, 16)`` mesh and reads XLA's memory and cost
analyses and the HLO's collectives. The port has no compiler; it *traces*
one rank's eager step instead. :func:`lower_cell` starts a fake process
group (``torch.testing._internal.distributed.fake_pg``: no communication,
every collective a no-op) the size of the mesh, as rank ``rank`` of it,
builds the production mesh on it and runs one train, prefill or decode
step of that rank under ``FakeTensorMode``: every tensor is fake, with a
shape, dtype and device but no storage, so a 512-card cell traces on one
host and nothing is allocated on any device. The state is built as the
port builds it: ``runtime.trainer.sharded_state`` (the trainer's ZeRO-3
blocks of the masters and the optimizer's states, parameters left
uninitialised) for ``train``, ``runtime.place_on_mesh`` for ``prefill`` and
``decode``, whose cache is ``models.init_cache`` of this rank's rows at
``seq_len + DECODE_MARGIN`` slots (the slots cut where
``sharding.cache_specs`` splits them), its position at ``seq_len``. The
batch is this rank's rows of ``sharding.input_specs``, in the dtypes the
port's launchers feed (int32 tokens; float32 ``embeds``, and ``frames``
float32 in training, bfloat16 in serving).

On ``device="cuda"`` the fake tensors are CUDA tensors, so the step takes
the card's path: the hand-written kernels are called, through their custom
ops' fake forms (``kernels.flash_attention``, ``kernels.rglru_scan``),
which give the output's shape and launch nothing (``kernels.slstm``'s scan
and its backward too: one fake call an sLSTM layer). On ``device="cpu"`` the
step takes the plain versions, as every CPU test of the port does. The
fake-form calls and the launches (none) are in the record.

What the trace counts, against what XLA counts:

  - FLOPs: :class:`_Tally`, each op by ``torch.utils.flop_counter``'s
    formulas, the products (matmuls, convolutions, attention; flash
    attention by its own formula, 4 D per visible query-key pair), not the
    elementwise ops XLA's ``flops`` also counts;
  - bytes: :class:`_Tally`, every op's input and output bytes, views and
    allocations left out: the port's eager HBM traffic, each op unfused,
    where XLA's ``bytes accessed`` counts its fused kernels;
  - memory: :class:`_Tally` also keeps the bytes of the storages alive
    (a dispatch mode of its own, not ``torch.distributed._tools.mem_tracker``:
    each op's new storages counted until Python frees them), from the
    step's arguments (``argument_bytes_per_device``: the state, the batch
    and the cache) up; ``peak_bytes_per_device`` is the most alive at once,
    where XLA's is its buffer assignment's arguments and temporaries;
  - collectives: the port's own calls, counted by
    ``distributed.parallel`` (calls, input and result bytes by kind) while
    the fake group runs them, and read by :mod:`.comm_analysis`.

Eager tracing runs every layer, so no per-unit calibration is needed
(JAX's ``_unit_cfg``): the record says ``"calibrated": false``. The
record keeps JAX's keys where they mean the same; ``compile_seconds`` is
``trace_seconds`` and ``hlo_flops_total`` is ``counted_flops_total``;
``transcendentals``, ``alias_bytes_per_device``,
``output_bytes_per_device`` and ``calibration_seconds`` have no meaning
here and are left out; ``rank`` and ``device`` are added. The roofline
takes the H100's constants (``mesh.hardware_constants``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --device cpu

Artifacts: ``artifacts/dryrun_torch/*.json``, under the JAX file names.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import traceback
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..obs.clock import wall

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")

DECODE_MARGIN = 128  # decode cache capacity beyond the prefilled context

def cell_applicable(cfg, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, "long_500k needs sub-quadratic attention (pure full-attention arch)"
    return True, ""


# ---------------------------------------------------------------------------
# The fake process group and the trace's counters
# ---------------------------------------------------------------------------


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the dry-run traces cuda or cpu tensors, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry-run was asked for device='cuda', but torch sees no CUDA "
                           "device; pass device='cpu' to trace the CPU's path")
    return dev


@contextlib.contextmanager
def fake_group(world: int, rank: int):
    """A fake process group of ``world`` ranks as rank ``rank`` for the
    context, destroyed on the way out. Raises when a process group is
    already initialised in this process."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the dry-run starts "
                           "its own fake one (run it in a process of its own)")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


class _Tally(TorchDispatchMode):
    """Within the context: ``flops``, each op's operations by
    ``torch.utils.flop_counter``'s formulas (what ``FlopCounterMode``
    counts, without its module hooks, which hold tensors alive); ``bytes``,
    the input and output bytes of every op that returns a tensor and is
    neither a view nor an allocation (a query of a tensor's metadata
    returns none); and ``peak``, the most bytes of storages alive at once:
    ``args`` (counted as ``argument_bytes``), then each op's new storages
    until they are freed."""

    def __init__(self, args):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self._held: Dict[int, int] = {}
        for t in args:
            self._hold(t)
        self.argument_bytes = self.peak = self.live

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        self._held[key] = n = st.nbytes()
        self.live += n
        weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        self.live -= self._held.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = [t for t in _pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if outs and not (func.is_view or func.overloadpacket.__name__ in _NO_TRAFFIC):
            ins = [t for t in _pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._hold(t)
        self.peak = max(self.peak, self.live)
        return out


def _fake_calls() -> Dict[str, int]:
    from ..kernels import flash_attention, rglru_scan, slstm

    return {"flash_attention": flash_attention.flash_attention.fake_calls,
            "rglru_scan": rglru_scan.rglru_scan.fake_calls,
            "rglru_scan_backward": rglru_scan.rglru_scan_backward.fake_calls,
            "slstm_scan": slstm.slstm_scan.fake_calls,
            "slstm_scan_backward": slstm.slstm_scan_backward.fake_calls}


# ---------------------------------------------------------------------------
# One rank's step
# ---------------------------------------------------------------------------


def _batch(cfg, cell, rows: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """This rank's ``rows`` of the cell's batch (``input_specs``' leaves),
    in the dtypes the port's launchers feed; zeros (valid token ids)."""
    from ..distributed.sharding import input_specs

    floats = torch.float32 if cell.kind == "train" else torch.bfloat16
    dtypes = {"tokens": torch.int32, "targets": torch.int32, "embeds": torch.float32,
              "frames": floats}
    return {k: torch.zeros((rows,) + tuple(leaf.shape[1:]), dtype=dtypes[k], device=device)
            for k, leaf in input_specs(cfg, cell.seq_len, cell.global_batch,
                                       cell.kind).items()}


def _state(cfg, cell, mesh, plan, device: torch.device):
    """This rank's state and the step over it: ``(step, arguments)``,
    ``step()`` running the cell's step once and ``arguments`` the tensors
    it reads (the state, the batch, the cache)."""
    from ..models import Model, init_cache
    from ..optim import make_optimizer
    from ..runtime import make_prefill_step, make_serve_step, make_train_step, place_on_mesh
    from ..runtime.trainer import sharded_state
    from ..runtime.trainstep import TrainState

    if cell.kind == "train":
        okw = {"state_dtype": cfg.opt_state_dtype} if cfg.optimizer == "adamw" else {}
        optimizer = make_optimizer(cfg.optimizer, **okw)
        zero, model, opt_state, _ = sharded_state(cfg, mesh, plan, optimizer,
                                                  cell.global_batch, device)
        state = TrainState(model, opt_state, 0)
        batch = _batch(cfg, cell, cell.global_batch // zero.split.blocks, device)
        fn = make_train_step(cfg, optimizer, zero)
        args = [*model.parameters(), *(t for ts in opt_state.values() for t in ts),
                *batch.values()]
        return (lambda: fn(state, batch)), args
    if cell.kind not in ("prefill", "decode"):
        raise ValueError(cell.kind)
    model = place_on_mesh(Model(cfg, device=device), mesh, cell.global_batch)
    rows = cell.global_batch // model.rows.blocks
    cache_len = cell.seq_len + DECODE_MARGIN
    params = list(model.parameters())
    if cell.kind == "prefill":
        batch = _batch(cfg, cell, rows, device)
        fn = make_prefill_step(model, cache_len)
        return (lambda: fn(batch)), params + list(batch.values())
    cache = init_cache(model, rows, cache_len)
    cache["pos"] = cell.seq_len
    tokens = torch.zeros((rows, 1), dtype=torch.int32, device=device)
    fn = make_serve_step(model)
    leaves = _pytree.tree_leaves(cache)
    return (lambda: fn(cache, tokens)), params + [t for t in leaves
                                                  if isinstance(t, torch.Tensor)] + [tokens]


def _trace_cell(cfg, cell, mesh, plan, *, rank: int, device="cuda") -> Dict[str, Any]:
    """Trace one step of ``cell`` as rank ``rank`` of the running (fake)
    process group on ``mesh`` under ``plan``, on fake tensors of
    ``device``; returns what the trace counted: ``argument_bytes``,
    ``peak_bytes``, ``flops``, ``bytes``, the collectives (``counts``, kind
    -> [calls, input bytes]; ``result_bytes`` by kind), each kernel's
    fake-form calls (``fake_calls``) and real launches (``launches``: none)
    in the step."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..distributed import parallel as P
    from ..kernels import launch_counts

    dev = _check_device(device)
    if dist.get_rank() != rank:
        raise ValueError(f"the process group's rank is {dist.get_rank()}, not {rank}")
    launches0 = launch_counts()
    with FakeTensorMode():
        step, args = _state(cfg, cell, mesh, plan, dev)
        P.reset_counts()
        fake0 = _fake_calls()
        tally = _Tally(args)
        del args
        with tally:
            step()
        fake = {k: v - fake0[k] for k, v in _fake_calls().items()}
    launched = {k: v - launches0[k] for k, v in launch_counts().items()}
    return {"argument_bytes": tally.argument_bytes, "peak_bytes": tally.peak,
            "flops": float(tally.flops), "bytes": float(tally.bytes),
            "counts": {k: list(v) for k, v in P.COUNTS.items()},
            "result_bytes": dict(P.RESULT_BYTES), "fake_calls": fake,
            "launches": {k: v for k, v in launched.items() if v}}


# ---------------------------------------------------------------------------
# The record
# ---------------------------------------------------------------------------


def roofline(flops: float, n_bytes: float, wire: float) -> Dict[str, Any]:
    """The roofline terms of a step of ``flops`` operations, ``n_bytes`` of
    memory traffic and ``wire`` collective bytes a card, on the H100's
    constants: each term's seconds, the largest (``bottleneck``) and its
    time (``step_time_s_max_term``)."""
    from .mesh import hardware_constants

    hw = hardware_constants()
    terms = {"compute_s": flops / hw["peak_flops"], "memory_s": n_bytes / hw["hbm_gbps"],
             "collective_s": wire / hw["nvlink_gbps"]}
    return {**terms, "bottleneck": max(terms, key=terms.get),
            "step_time_s_max_term": max(terms.values())}


def _plan(cfg, cell, mesh):
    """The cell's plan on ``mesh``, with JAX's arguments."""
    from ..distributed.sharding import make_plan

    return make_plan(mesh, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                     prefer=cfg.attn_parallelism, global_batch=cell.global_batch)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               overrides: Optional[Dict[str, Any]] = None, rank: int = 0,
               device="cuda") -> Dict[str, Any]:
    """Trace one cell as ``rank`` of the production mesh (``(16, 16)``, or
    ``(2, 16, 16)`` with ``multi_pod``) on fake tensors of ``device``;
    returns its record. Raises when a process group is already initialised
    or when ``device`` is ``cuda`` and torch sees no CUDA device."""
    from ..configs import get_config
    from ..models import shape_cell
    from ..models.costs import attention_flops, model_flops
    from .comm_analysis import collective_stats
    from .mesh import hardware_constants, make_production_mesh

    dev = _check_device(device)
    cfg = get_config(arch, **(overrides or {}))
    cell = shape_cell(shape_name)
    ok, why = cell_applicable(cfg, shape_name)
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": cell.kind, "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "overrides": overrides or {}, "rank": rank, "device": dev.type,
    }
    if not ok:
        rec["status"] = "SKIP"
        rec["reason"] = why
        return rec
    n_chips = 512 if multi_pod else 256
    with fake_group(n_chips, rank):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
        plan = _plan(cfg, cell, mesh)
        t0 = wall()
        traced = _trace_cell(cfg, cell, mesh, plan, rank=rank, device=dev)
        trace_s = wall() - t0

    hw = hardware_constants()
    coll = collective_stats(traced["counts"], traced["result_bytes"])
    coll["calibrated"] = False
    flops_dev, bytes_dev = traced["flops"], traced["bytes"]
    roof = roofline(flops_dev, bytes_dev, coll["wire_bytes_per_device"])
    mf = model_flops(cfg, cell)
    arg, peak = traced["argument_bytes"], traced["peak_bytes"]
    budget = int(hw["hbm_gib"] * 2**30)
    rec.update({
        "status": "OK",
        "trace_seconds": trace_s,
        "memory_analysis": {
            "argument_bytes_per_device": arg,
            "temp_bytes_per_device": peak - arg,
            "peak_bytes_per_device": peak,
            "fits_hbm": peak <= budget,
            "hbm_budget_bytes": budget,
        },
        "cost_analysis": {"flops_per_device": flops_dev, "bytes_per_device": bytes_dev},
        "collectives": coll,
        "n_chips": n_chips,
        "roofline": {
            **roof,
            "model_flops_total": mf,
            "attention_flops_total": attention_flops(cfg, cell),
            "counted_flops_total": flops_dev * n_chips,
            "useful_flops_ratio": (mf / (flops_dev * n_chips)) if flops_dev else 0.0,
            "step_time_s_sum": roof["compute_s"] + roof["memory_s"] + roof["collective_s"],
        },
        "attn_mode": plan.attn_mode,
        "kernels": {"fake_calls": traced["fake_calls"], "launches": traced["launches"]},
    })
    return rec


def run_and_save(arch: str, shape_name: str, multi_pod: bool,
                 overrides: Optional[Dict[str, Any]] = None, tag: str = "", *,
                 rank: int = 0, device="cuda", out_dir: str = ARTIFACT_DIR) -> Dict[str, Any]:
    """:func:`lower_cell`'s record (a ``FAIL`` record with the error where
    it raises), written to ``out_dir`` under the JAX file name."""
    os.makedirs(out_dir, exist_ok=True)
    try:
        rec = lower_cell(arch, shape_name, multi_pod=multi_pod, overrides=overrides,
                         rank=rank, device=device)
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:], "overrides": overrides or {},
               "rank": rank, "device": str(device)}
    mesh_tag = "multipod" if multi_pod else "singlepod"
    suffix = f"_{tag}" if tag else ""
    fname = f"{arch.replace('.', '_')}__{shape_name}__{mesh_tag}{suffix}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> None:
    from ..configs import ALIASES
    from ..models.config import SHAPE_CELLS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None, help="assigned arch id (dashed)")
    ap.add_argument("--shape", type=str, default=None, choices=[c.name for c in SHAPE_CELLS])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="sweep every (arch x shape)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--override", type=str, default=None,
                    help="JSON dict of ArchConfig overrides (perf experiments)")
    ap.add_argument("--rank", type=int, default=0, help="the rank of the mesh to trace")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the fake tensors' device: cuda (the card's path; needs a GPU) "
                         "or cpu (the plain versions)")
    ap.add_argument("--out", type=str, default=ARTIFACT_DIR,
                    help="the directory the records are written to")
    args = ap.parse_args(argv)
    overrides = json.loads(args.override) if args.override else None

    arch_list = list(ALIASES.keys()) if (args.all or args.arch is None) else [args.arch]
    shape_list = [c.name for c in SHAPE_CELLS] if (args.all or args.shape is None) else [args.shape]
    mesh_list = [False, True] if args.both_meshes else [args.multi_pod]

    t0 = wall()
    for arch in arch_list:
        for shape_name in shape_list:
            for mp in mesh_list:
                rec = run_and_save(arch, shape_name, mp, overrides, args.tag,
                                   rank=args.rank, device=args.device, out_dir=args.out)
                status = rec.get("status")
                extra = ""
                if status == "OK":
                    r = rec["roofline"]
                    extra = (f" trace={rec['trace_seconds']:.0f}s"
                             f" bottleneck={r['bottleneck']}"
                             f" t={r['step_time_s_max_term']*1e3:.2f}ms"
                             f" mem/dev={rec['memory_analysis']['peak_bytes_per_device']/2**30:.2f}GiB")
                elif status == "FAIL":
                    extra = " " + rec.get("error", "")[:160]
                print(f"[{wall()-t0:7.0f}s] {arch:20s} {shape_name:12s} "
                      f"{'2x16x16' if mp else '16x16':8s} {status}{extra}", flush=True)
    print(f"total: {wall()-t0:.0f}s")


if __name__ == "__main__":
    main()
