"""Carry state into the port from plain data.

The port shares no objects with the JAX package. These helpers rebuild the
port's own types from plain Python and numpy values, so a caller that holds
the JAX package's trace or allocation can hand the same inputs to both:

  - :func:`events_from_rows` — trace rows as tuples in ``TRACE_HEADER``'s
    schema ``(time, kind, tenant, job_id, payload)``;
  - :func:`allocation_from_arrays` — an :class:`Allocation` from its arrays,
    keeping the warm-start state: ``meta["tau"]``, the water-filling hint,
    and ``meta["pd_state"]``, the primal–dual tier's certified saddle;
  - :func:`model_from_jax` — the serving model from the JAX package's params
    pytree as numpy arrays (``jax.tree.map(np.asarray, params)``), and its
    inverse for caches, :func:`cache_to_jax`, so tests compare caches leaf
    by leaf. These two import torch and the model stack when called, so the
    service's data helpers above load neither.
"""
from __future__ import annotations

import json
from typing import TYPE_CHECKING, Any, Dict, Iterable, List, Sequence, Tuple

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


def model_from_jax(cfg: ArchConfig, params: Dict[str, Any], device=None) -> Model:
    """The port's ``Model`` on ``device`` holding the JAX package's weights.

    ``params`` is ``repro.models.init_params``'s pytree as numpy arrays.
    Each pattern position's params carry a leading ``n_units`` axis, which
    is unstacked into one ``Block`` per unit; ``tail``, ``embed`` and
    ``final_norm`` are copied. Names and layouts match, so every weight is a
    copy (cast to the port's storage dtype, as the JAX code casts at use).
    Raises if a leaf is missing, left over or of another shape. ``device``
    defaults to ``cuda`` and raises without a GPU (``resolve_device``); pass
    ``device="cpu"`` to build on the CPU.
    """
    import torch

    from .core.torch_solve import resolve_device
    from .models.model import Model

    model = Model(cfg, device=resolve_device(device))
    P = len(cfg.pattern)
    copied = set()

    def put(p: torch.Tensor, path: str, unit=None) -> None:
        leaf = params
        for key in path.split("/"):
            leaf = leaf[int(key) if isinstance(leaf, (list, tuple)) else key]
        arr = np.asarray(leaf) if unit is None else np.asarray(leaf)[unit]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"JAX leaf {path} has shape {arr.shape}, the "
                             f"parameter {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
        copied.add(path)

    with torch.no_grad():
        put(model.embed, "embed")
        put(model.final_norm.scale, "final_norm/scale")
        for i, layer in enumerate(model.layers):
            unit, p = divmod(i, P)
            if unit < cfg.n_units:
                prefix = f"units/p{p}/"
            else:
                prefix, unit = f"tail/{i - cfg.n_units * P}/", None
            for name, prm in layer.named_parameters():
                put(prm, prefix + name.replace(".", "/"), unit)
    left = sorted(set(_paths(params)) - copied)
    if left:
        raise ValueError(f"JAX params the port's {cfg.name} does not take: {left}")
    return model


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    import torch

    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def cache_to_jax(model: Model, cache: Cache) -> Dict[str, Any]:
    """The port's decode cache in the JAX package's layout, as numpy: pattern
    position ``p``'s states stacked over units under ``units/p{p}/mixer``,
    the tail's as a list, ``pos`` an int32 scalar. bfloat16 leaves come as
    float32 (numpy has no bfloat16)."""
    cfg = model.cfg
    P = len(cfg.pattern)
    out: Dict[str, Any] = {}
    states = cache["layers"]
    if cfg.n_units:
        out["units"] = {
            f"p{p}": {"mixer": {k: np.stack([_to_numpy(states[u * P + p][k])
                                             for u in range(cfg.n_units)])
                                for k in states[p]}}
            for p in range(P)}
    tail = states[cfg.n_units * P:]
    if tail:
        out["tail"] = [{"mixer": {k: _to_numpy(v) for k, v in st.items()}}
                       for st in tail]
    out["pos"] = np.int32(cache["pos"])
    return out
