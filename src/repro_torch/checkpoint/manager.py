"""Checkpointing: npz save/restore with atomic commit, async writes and
keep-last-k GC, in the JAX package's layout.

Layout:   <dir>/step_<n>/arrays.npz + manifest.json   (+ .tmp staging)

The port of ``repro.checkpoint.manager``: a tree (nested dicts, lists and
tuples of tensors or numpy arrays) is flattened to ``::``-joined keys in the
JAX flatten order (dict keys sorted, list entries by index), so a
``TrainState`` written as ``[params, opt_state, step]`` in the JAX layout
(``repro_torch.interop.leaves_to_jax``) has the JAX trainer's keys
(``0::units::p0::mixer::w_gate``, ``1::m::...``, ``2``). bfloat16 is stored
as its uint16 bits, as the JAX ``_encode`` stores it. A checkpoint of either
package restores into the other. Leaves are always whole: a mesh trainer
gathers them to write and cuts its blocks out on restore
(``repro_torch.runtime.trainer``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..obs.clock import epoch

SEP = "::"


def to_numpy(t) -> np.ndarray:
    """A tensor (or array) as numpy for the npz: bfloat16 as its uint16 bits,
    as the JAX ``_encode`` stores it (npz has no bfloat16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


def from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A stored array as a tensor of ``dtype``: uint16 bits of a bfloat16
    leaf are viewed back, anything else is cast."""
    if dtype == torch.bfloat16 and arr.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dtype)


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{key: array}`` of a nested dict / list / tuple tree, keys joined by
    ``::`` in the JAX flatten order."""
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}{SEP}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(flatten(t, f"{prefix}{i}{SEP}"))
        return out
    return {prefix[:-len(SEP)]: to_numpy(tree)}


def save_pytree(tree: Any, directory: str, step: int) -> str:
    """Atomic: write into .tmp, then rename."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "treedef": "flat keys joined by '::' (repro_torch)",
        "time": epoch(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_arrays(directory: str, step: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The arrays of checkpoint ``step`` (default: the latest) by key, as
    stored (bfloat16 as uint16 bits: :func:`from_numpy` views them back)."""
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    with np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as data:
        return {k: data[k] for k in data.files}


def available_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                continue
    return sorted(steps)


class CheckpointManager:
    """Periodic async checkpoints with keep-last-k garbage collection."""

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def due(self, step: int) -> bool:
        """Whether ``step`` is one to checkpoint (every ``every`` steps)."""
        return self.every > 0 and step % self.every == 0

    def maybe_save(self, tree: Any, step: int, *, force: bool = False) -> bool:
        if not force and not self.due(step):
            return False
        flat = flatten(tree)  # snapshot to the host before the async write
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(flat, step), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(flat, step)
        return True

    def _save_and_gc(self, flat: Dict[str, np.ndarray], step: int) -> None:
        save_pytree(flat, self.directory, step)
        steps = available_steps(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def latest_step(self) -> Optional[int]:
        steps = available_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        return load_arrays(self.directory, step)
