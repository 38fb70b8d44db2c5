"""Reading a ``torch.profiler`` trace of the traced window.

The device's operations (kernels, copies, fills) are read from the raw
kineto events, not ``key_averages`` (which builds an object for every host
and device event: minutes for an xLSTM step). What the readers get:

  - ``busy_s``: the union of the device operations' intervals inside the
    window, so operations that overlap on several streams count once;
  - ``window_s``: the length of the window, the span of the harness's
    ``bench.window`` annotation on the trace's own clock;
  - ``ops``: by operation name (:func:`short`), ``[count, seconds]``, and
    ``kernels``, the same for kernels alone (not copies or fills);
  - ``gaps``: the idle stretches of the device inside the window, each named
    by the innermost host operation that spans its middle.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch

WINDOW = "bench.window"
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


@contextlib.contextmanager
def profiled(on: bool):
    """A profiler over the block when ``on`` (CPU and, on a card, CUDA
    activities); yields it, or None."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def short(name: str, width: int = 200) -> str:
    """A device operation's name without its trailing argument list, at
    most ``width`` letters (kernels' demangled names run to kilobytes)."""
    name = name[5:] if name.startswith("void ") else name
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name[:width]


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted disjoint intervals covering the rows of ``iv`` (n, 2)."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64)


def read(prof, n_gaps: int = 64) -> Dict[str, object]:
    """The window's device record from a finished profiler (see above)."""
    dev_t, dev_names, cpu, cpu_names = [], [], [], []
    w0 = w1 = None
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if e.is_user_annotation():  # an annotation's span, not an operation
                continue
            dev_t.append((s, t))
            dev_names.append(short(e.name()))
        elif e.name() == WINDOW:
            w0, w1 = s, t
        else:
            cpu.append((s, t))
            cpu_names.append(e.name())
    rec = {"window_s": 0.0, "busy_s": 0.0, "ops": {}, "kernels": {}, "gaps": []}
    if w0 is None:
        return rec
    rec["window_s"] = (w1 - w0) / 1e9
    dev = np.asarray(dev_t, dtype=np.int64).reshape(-1, 2)
    inside = (dev[:, 1] > w0) & (dev[:, 0] < w1)
    for (s, t), name, ok in zip(dev_t, dev_names, inside):
        if not ok:
            continue
        row = rec["ops"].setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (t - s) / 1e9
        if not name.startswith(_NOT_KERNELS):
            k = rec["kernels"].setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (t - s) / 1e9
    busy = _union(np.clip(dev[inside], w0, w1))
    rec["busy_s"] = float(np.sum(busy[:, 1] - busy[:, 0])) / 1e9 if len(busy) else 0.0
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    rec["gaps"] = _name_gaps(gaps, np.asarray(cpu, dtype=np.int64).reshape(-1, 2),
                             cpu_names, n_gaps)
    return rec


def _name_gaps(gaps: np.ndarray, cpu: np.ndarray, names: List[str],
               n: int) -> List[Tuple[str, float]]:
    """The ``n`` longest gaps as (host operation at their middle, seconds)."""
    order = np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:n]
    out = []
    dur = cpu[:, 1] - cpu[:, 0] if len(cpu) else cpu
    for g in gaps[order]:
        mid = (g[0] + g[1]) // 2
        name = "host (no operation traced)"
        if len(cpu):
            hit = np.nonzero((cpu[:, 0] <= mid) & (cpu[:, 1] >= mid))[0]
            if len(hit):
                name = names[hit[np.argmin(dur[hit])]]
        out.append((name, float(g[1] - g[0]) / 1e9))
    return out


def breakdown(rec: Dict[str, object], top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by the
    host operation it fell in, ``top`` of each, in seconds."""
    ops = sorted(((k, v[1]) for k, v in rec["ops"].items()), key=lambda kv: -kv[1])
    idle: Dict[str, float] = {}
    for name, s in rec["gaps"]:
        idle[name] = idle.get(name, 0.0) + s
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops[:top]],
            "idle_gaps": [[k, v] for k, v in gaps[:top]]}
