"""One run of one cell: set-up, the measured (or traced) window, the check
of what the window produced, and the result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the weights
drawn from the seed on the card, the pool of batches, the program built
and warmed on every shape the window uses. A training cell's set-up drives
the trainer through its first steps (``check_steps``) with the window's own
call and feed, which also warms it, and reads their losses, the first
gradients and the weights' change. A prefill cell warms with ``warmup``
requests. Last, what set-up made is frozen out of the garbage collector
(``gc.freeze``) until the window has closed.

The window: closed loop, one client. ``--trace 0`` runs steps or requests
until ``--seconds`` have passed and reports the cell's end-to-end metrics;
``--trace 1`` runs ``trace_steps`` of them under the profiler and reports
the per-layer metrics, ``busy_s``, ``window_s`` and the breakdown.

Then the peak memory is read, the program is freed and the reference
(float32, TF32 off) reworks the same steps or the sampled requests; each
number compared is printed beside its limit as the last lines on standard
error and under ``compared``, the last key of the result line.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import sys
import time
from typing import Dict, Optional

import numpy as np

from . import judge, manifest, program, trace, traffic as traffic_mod, weights
from .peaks import PEAKS

#: top-level module names that must never be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """The forbidden top-level names present in ``sys.modules``, each
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def p90(values) -> float:
    """The 90th percentile by nearest rank (a failed request is inf)."""
    s = sorted(values)
    return s[max(0, math.ceil(0.9 * len(s)) - 1)] if s else math.inf


def _tensors(batch: dict, device):
    import torch

    return (torch.from_numpy(batch["tokens"]).long().to(device),
            torch.from_numpy(batch["targets"]).long().to(device))


def _card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def _power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _reference_mode() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def run_cell(man: manifest.Manifest, name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             cfgfile: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[Dict[str, float]] = None) -> dict:
    """One run of cell ``name``; returns the result (see the module's
    docstring). ``cfgfile``, ``traffic`` and ``limits`` replace the cell's
    files (the tests run smaller ones on the CPU)."""
    import torch

    t_start = time.time() if t_start is None else t_start
    cell = man.cell(name)
    cfgfile = cfgfile or man.config(cell["config"])
    traffic = traffic or man.traffic(cell["traffic"])
    limits = man.limits(name) if limits is None else limits
    ref_mod = manifest.module("reference", cfgfile["reference"])
    run = cfgfile["run"]
    kind = traffic["kind"]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    spec = ref_mod.weight_spec(run)
    pool = traffic_mod.pool(traffic, run["vocab"], seed)
    drv = program.driver(kind)(cfgfile, traffic, spec, seed, dev, pool)

    prog = {}
    if kind == "train":
        n_check = traffic["check_steps"]
        prog["losses"] = [drv.step()]
        prog["grad"] = drv.first_grads()
        prog["losses"] += [drv.step() for _ in range(n_check - 1)]
        prog["change"] = drv.change()
        act = drv.step
    else:
        for i in range(traffic["warmup"]):
            drv.request(i)
        served: Dict[int, program.Served] = {}
        counter = itertools.count(traffic["warmup"])

        def act() -> float:
            i = next(counter)
            lat, out = drv.request(i)
            served[i % len(pool)] = out
            return lat
    program.sync(dev)
    # what set-up made (the imports, the program's state) leaves the
    # collector's generations: a full collection rescans every tracked
    # object, a pause of a few hundred milliseconds each few hundred steps
    gc.freeze()
    setup_s = time.time() - t_start

    # the window
    import torch.autograd.profiler as tap

    lat, failed, done = [], 0, 0
    limit_n = traffic["trace_steps"] if traced else None
    with trace.profiled(traced) as prof:
        with tap.record_function(trace.WINDOW):
            t0 = time.perf_counter()
            while True:
                try:
                    got = act()
                    lat.append(got if kind == "prefill" else 0.0)
                    done += 1
                except Exception as e:  # a failed step or request is counted, then stops the run
                    print(f"bench: a {kind} failed in the window: {e!r}", file=sys.stderr)
                    failed += 1
                    lat.append(math.inf)
                    break
                elapsed = time.perf_counter() - t0
                if (limit_n is not None and done >= limit_n) or \
                        (limit_n is None and elapsed >= seconds):
                    break
            program.sync(dev)
            elapsed = time.perf_counter() - t0
    peak = program.memory_peak(dev)
    gc.unfreeze()

    metrics: Dict[str, dict] = {}
    record = None
    if traced:
        record = trace.read(prof)
        record.update(kind=kind, run=run, traffic=traffic, steps=done, peaks=PEAKS,
                      model_counts=manifest.module("counts", cfgfile["counts"]))
        for m in man.per_layer(name):
            value = man.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        tokens = done * traffic["batch"] * traffic["seq_len"]
        e2e = {"setup_s": setup_s,
               "train_tokens_per_s": tokens / elapsed,
               "prefill_tokens_per_s": tokens / elapsed,
               "ttft_p90_s": p90(lat)}
        for m in man.end_to_end(name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the check, once the program is freed
    t_check = time.time()
    if kind == "prefill":
        rng = np.random.default_rng([seed, 0xC4EC])
        have = sorted(served)
        pick = sorted(rng.choice(have, size=min(traffic["check_requests"], len(have)),
                                 replace=False).tolist()) if have else []
        sample = [(served[i].tokens, served[i].logits.float().cpu()) for i in pick]
        served.clear()
    drv.free()
    del drv
    program.release(dev)
    _reference_mode()
    P = {n: w.clone() for n, w in weights.draw(spec, seed, dev)}
    if kind == "train":
        from bench.reference import adamw

        batches = [_tensors(b, dev) for b in pool[:traffic["check_steps"]]]
        ref = adamw.train_readings(P, run, traffic["optimizer"], batches,
                                   lambda: weights.draw(spec, seed, dev))
        where: Dict[str, str] = {}
        numbers = judge.train_numbers(prog, ref, where)
        print(f"bench: the worst first-gradient gap {where['grad_worst']} (beside the "
              f"median) is at {where['grad_gap']}", file=sys.stderr)
        for k, key in (("grad_gap", "grad"), ("change_gap", "change")):
            leaf = where[k]
            print(f"bench: {key} of {leaf}: program {prog[key].get(leaf)!r}, "
                  f"reference {ref[key].get(leaf)!r}", file=sys.stderr)
    else:
        with torch.no_grad():
            refs = [ref_mod.last_logits(P, run, torch.from_numpy(pool[i]["tokens"]).long()
                                        .to(dev)) for i in pick]
        numbers = judge.prefill_numbers(sample, refs, run["vocab"])
    del P
    program.release(dev)
    print(f"bench: setup {setup_s:.2f} s, window {elapsed:.2f} s for {done} {kind} calls, "
          f"peak {peak / 1e9:.2f} GB, check {time.time() - t_check:.2f} s", file=sys.stderr)
    correct = judge.verdict(numbers, limits) and failed == 0

    result = {"correct": correct, "attempted": done + failed, "failed": failed,
              "metrics": metrics,
              "device": dict(_card(dev), memory_peak_bytes=peak)}
    if traced:
        result["device"].update(busy_s=record["busy_s"], window_s=record["window_s"])
        result["breakdown"] = trace.breakdown(record)
    for k in sorted(set(numbers) - set(limits)):
        print(f"bench: read, not compared (no limit separates the control): {k} "
              f"{numbers[k]!r}", file=sys.stderr)
    result["compared"] = {k: {"value": numbers.get(k, math.inf), "limit": lim}
                          for k, lim in limits.items()}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description="run one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import repro_torch  # noqa: F401  (the system under test, beside the benchmark)
    import torch

    # the host's side of a run is one Python thread feeding the card: a pool
    # of one CPU thread keeps torch's others off the cores it runs on
    torch.set_num_threads(1)

    man = manifest.Manifest()
    cell = man.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules that must not load were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    card = _power_limit()
    if card:
        print(f"bench: card {card}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
