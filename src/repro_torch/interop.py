"""Carry state into the port from plain data.

The port shares no objects with the JAX package. These helpers rebuild the
port's own types from plain Python and numpy values, so a caller that holds
the JAX package's trace or allocation can hand the same inputs to both:

  - :func:`events_from_rows` — trace rows as tuples in ``TRACE_HEADER``'s
    schema ``(time, kind, tenant, job_id, payload)``;
  - :func:`allocation_from_arrays` — an :class:`Allocation` from its arrays,
    keeping the warm-start state: ``meta["tau"]``, the water-filling hint,
    and ``meta["pd_state"]``, the primal–dual tier's certified saddle;
  - :func:`model_from_jax` — the model from the JAX package's params
    pytree as numpy arrays (``jax.tree.map(np.asarray, params)``), for
    serving or, with ``trainable=True``, with masters for training;
  - :func:`leaves_to_jax` — its inverse for any per-parameter tree (params,
    grads, optimizer states) held as leaves (``models.param_leaves``): the
    JAX layout as numpy, unit leaves stacked on a leading ``n_units`` axis,
    ``prefix`` and ``tail`` lists, the JAX names; :func:`load_leaves` copies such arrays
    back into the port's tensors; and :func:`cache_to_jax` for decode
    caches. Tests compare gradients, optimizer states and caches leaf by
    leaf through these, and the checkpoint writes and reads its arrays
    through them; :func:`gather_cache` gathers a cache served on a mesh
    (every rank's rows and blocks) into the whole cache first. They import
    torch and the model stack when called, so the service's data helpers
    above load neither.
"""
from __future__ import annotations

import json
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .core.types import Allocation
from .service.events import Event, EventKind, TRACE_KINDS

if TYPE_CHECKING:
    import torch

    from .models.config import ArchConfig
    from .models.model import Cache, Model


def events_from_rows(rows: Iterable[Tuple[object, ...]]) -> List[Event]:
    """Build trace events from ``(time, kind, tenant, job_id, payload)`` rows.

    ``kind`` is an event-kind value such as ``"job_submit"``; ``payload`` is
    a dict or its JSON text. Internal kinds (predicted finishes, resolve
    timers) are rejected, as in a CSV replay.
    """
    events = []
    for time, kind, tenant, job_id, payload in rows:
        if isinstance(payload, str):
            payload = json.loads(payload)
        ev = Event(float(time), EventKind(kind), tenant=str(tenant),
                   job_id=str(job_id), payload=dict(payload))
        if ev.kind not in TRACE_KINDS:
            raise ValueError(f"trace rows contain internal event kind {ev.kind}")
        events.append(ev)
    return events


def allocation_from_arrays(X, W, m, rows: Sequence[str],
                           meta: Dict[str, object]) -> Allocation:
    """Build the port's :class:`Allocation`; ``meta`` is copied, with ``tau``
    as a Python float and each array of ``pd_state`` as a fresh float64
    numpy array, so either seeds the port's warm start."""
    meta = dict(meta)
    if meta.get("tau") is not None:
        meta["tau"] = float(meta["tau"])
    if meta.get("pd_state") is not None:
        meta["pd_state"] = {k: np.array(v, dtype=np.float64)
                            for k, v in meta["pd_state"].items()}
    return Allocation(X=np.array(X, dtype=np.float64), rows=tuple(rows),
                      W=np.array(W, dtype=np.float64),
                      m=np.array(m, dtype=np.float64), meta=meta)


def _paths(tree, prefix: str = "") -> List[str]:
    """Leaf paths of a nested dict / list tree, as ``a/b/0/c``."""
    if isinstance(tree, dict):
        return [q for k in tree for q in _paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [q for i, t in enumerate(tree) for q in _paths(t, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _stacked(path: str) -> bool:
    """A leaf under ``units`` stacks the pattern units on its first axis."""
    return "units" in path.split("/")


def load_leaves(leaves: Dict[str, List["torch.Tensor"]],
                lookup: Callable[[str], np.ndarray]) -> None:
    """Copy arrays in the JAX layout into the port's tensors, in place.

    ``leaves`` maps JAX leaf paths to tensors (``models.param_leaves``);
    ``lookup(path)`` gives that leaf's array, unit leaves stacked on their
    first axis. Each array is cast to its tensor's dtype (as the JAX code
    casts at use). Raises if a shape differs.
    """
    import torch

    with torch.no_grad():
        for path, ts in leaves.items():
            arr = np.asarray(lookup(path))
            parts = list(arr) if _stacked(path) else [arr]
            if len(parts) != len(ts):
                raise ValueError(f"JAX leaf {path} holds {len(parts)} units, the "
                                 f"port {len(ts)}")
            for t, a in zip(ts, parts):
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"JAX leaf {path} has shape {a.shape} per unit, "
                                     f"the tensor {tuple(t.shape)}")
                # floats (bfloat16 too) via float32; integers as they are
                t.copy_(torch.from_numpy(np.array(a, dtype=np.float32)
                                         if a.dtype.kind not in "iub" else np.array(a)))


def leaves_to_jax(leaves: Dict[str, Sequence[Any]],
                  convert: Callable[[Any], np.ndarray] = None) -> Dict[str, Any]:
    """Leaves (a JAX leaf path to its tensors) as the JAX pytree of numpy
    arrays: a path through ``units`` stacks its tensors on a new first
    axis, any other takes its one tensor, and a numeric path component
    indexes a list (``tail/0/...``). ``convert`` turns one tensor into
    numpy (default: float32 for bfloat16, as numpy has no bfloat16)."""
    convert = convert or _to_numpy
    root: Dict[str, Any] = {}
    for path, ts in leaves.items():
        arrs = [convert(t) for t in ts]
        if _stacked(path):
            value = np.stack(arrs)
        elif len(arrs) == 1:
            value = arrs[0]
        else:
            raise ValueError(f"leaf {path} is not under units but holds {len(arrs)} tensors")
        node, keys = root, path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return _lists(root)


def _lists(node):
    """Dicts whose keys are all numeric become lists (JAX's ``tail``)."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def model_from_jax(cfg: ArchConfig, params: Dict[str, Any], device=None,
                   trainable: bool = False) -> Model:
    """The port's ``Model`` on ``device`` holding the JAX package's weights.

    ``params`` is ``repro.models.init_params``'s pytree as numpy arrays.
    Each pattern position's params carry a leading ``n_units`` axis, which
    is unstacked into one ``Block`` per unit (its ``cross`` and
    ``norm_cross`` with it); ``prefix`` (the dense prefix layers), ``tail``,
    ``embed``, ``final_norm``, an untied model's ``head`` and an encoder
    model's ``encoder`` layers and ``encoder_norm`` are copied, and a MoE
    layer's ``ffn/router`` (float32 either way), ``ffn/w_in``,
    ``ffn/w_out`` and its ``shared`` and ``dense`` SwiGLUs. Names and
    layouts match, so every weight is a copy: into the serving model's
    storage dtype (as the JAX code casts at use), or with ``trainable=True``
    into masters that require grad, in the JAX leaf's dtype (the config's
    ``param_dtype``, or float32; bfloat16 arrives here as float32 and is
    copied back exactly).
    Raises if a leaf is missing, left over or of another shape. ``device``
    defaults to ``cuda`` and raises without a GPU (``resolve_device``); pass
    ``device="cpu"`` to build on the CPU.
    """
    from .core.torch_solve import resolve_device
    from .models.model import Model, param_leaves

    model = Model(cfg, device=resolve_device(device), trainable=trainable)
    leaves = param_leaves(model)

    def lookup(path: str):
        leaf = params
        for key in path.split("/"):
            leaf = leaf[int(key) if isinstance(leaf, (list, tuple)) else key]
        return leaf

    load_leaves(leaves, lookup)
    left = sorted(set(_paths(params)) - set(leaves))
    if left:
        raise ValueError(f"JAX params the port's {cfg.name} does not take: {left}")
    return model


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    import torch

    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def cache_to_jax(model: Model, cache: Cache) -> Dict[str, Any]:
    """The port's decode cache in the JAX package's layout, as numpy: the
    dense prefix layers' as the list ``prefix``, pattern position ``p``'s
    states stacked over units under ``units/p{p}/mixer`` (and an encoder
    model's cross caches under ``units/p{p}/cross``), the tail's as a list,
    ``pos`` an int32 scalar. A layer's state is its
    mixer's, named as in JAX: ``k``, ``v`` (attention), ``h`` (RG-LRU),
    ``C``, ``n`` (mLSTM), ``h``, ``c``, ``n``, ``m`` (sLSTM); its cross
    cache ``ck``, ``cv``. bfloat16 leaves come as float32 (numpy has no
    bfloat16). A cache served on a mesh goes through :func:`gather_cache`
    first."""
    return cache_layout(model, cache, _to_numpy, lambda ts: np.stack([_to_numpy(t) for t in ts]),
                        np.int32)


def cache_layout(model: Model, cache: Cache, one: Callable, stack: Callable,
                 pos: Callable) -> Dict[str, Any]:
    """The JAX package's layout of ``cache`` (:func:`cache_to_jax`) with
    each leaf ``one(tensor)``, a stacked pattern leaf ``stack(tensors)`` (a
    unit's tensor each) and ``pos`` as ``pos(cache["pos"])``."""
    cfg = model.cfg
    P, n0 = len(cfg.pattern), model.n_prefix
    n = n0 + cfg.n_units * P
    out: Dict[str, Any] = {}
    parts = {"mixer": cache["layers"]}
    if "cross" in cache:
        parts["cross"] = cache["cross"]

    def layer(i: int) -> Dict[str, Any]:
        return {part: {k: one(v) for k, v in states[i].items()}
                for part, states in parts.items()}

    if n0:
        out["prefix"] = [layer(i) for i in range(n0)]
    if cfg.n_units:
        out["units"] = {
            f"p{p}": {part: {k: stack([states[n0 + u * P + p][k] for u in range(cfg.n_units)])
                             for k in states[n0 + p]}
                      for part, states in parts.items()}
            for p in range(P)}
    if len(cache["layers"]) > n:
        out["tail"] = [layer(i) for i in range(n, len(cache["layers"]))]
    out["pos"] = pos(cache["pos"])
    return out


def gather_cache(model: Model, cache: Cache) -> Cache:
    """The whole decode cache of a model served on a mesh
    (``repro_torch.runtime.place_on_mesh``) from every rank's: each
    attention cache's and cross cache's blocks of slots all-gathered over
    the model axis where the plan splits them (``kv_len``, ``cross_len``),
    then every leaf's rows over the batch's mesh dims. Every rank of the
    mesh calls it and gets the same cache; without a mesh, ``cache``."""
    from .distributed import parallel as P

    view, rows = model.view, model.rows
    if rows is None:
        return cache

    def whole(t, length):
        if length is not None and view.cache(length) is not None:
            t = P.all_gather(t, 1, view.group)
        return rows.gather(t.contiguous())

    n = len(cache["layers"])
    lens = cache.get("kv_len", [None] * n)
    out = {"layers": [{k: whole(t, length if k in ("k", "v") else None) for k, t in c.items()}
                      for c, length in zip(cache["layers"], lens)],
           "pos": cache["pos"]}
    if "cross" in cache:
        out["cross"] = [{k: whole(t, cache["cross_len"]) for k, t in c.items()}
                        for c in cache["cross"]]
    return out
