"""The readings that set the limits' upper ends: the control (the
reference put in the program's place, in float8 where the configuration
states bfloat16: ``prec="fp8"`` of the reference) and, for a training
cell, a planted fault read with the reference in the program's place
(half of each batch left out, the mean taken over the rest). The
benchmark's own runs never run these; ``bench/controls.py`` runs them on
the card at a cell's own size, and ``bench/tests`` at a size a test run
holds.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import judge, manifest, traffic as traffic_mod, weights


def _params(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    return {n: w.clone() for n, w in weights.draw(spec, seed, device)}


def train_readings(cfgfile: dict, traffic: dict, seed: int, device, prec: str = "fp32",
                   rows: Optional[int] = None) -> dict:
    """The reference's readings of the cell's first steps (as the harness
    checks them) in ``prec``, on the first ``rows`` of each batch."""
    from bench.reference import adamw

    ref = manifest.module("reference", cfgfile["reference"])
    run = cfgfile["run"]
    spec = ref.weight_spec(run)
    pool = traffic_mod.pool(traffic, run["vocab"], seed)[:traffic["check_steps"]]
    batches = [tuple(torch.from_numpy(b[k]).long().to(device) for k in ("tokens", "targets"))
               for b in pool]
    P = _params(spec, seed, device)
    return adamw.train_readings(P, run, traffic["optimizer"], batches,
                                lambda: weights.draw(spec, seed, device), prec, rows)


def train_control(cfgfile: dict, traffic: dict, seed: int, device) -> Dict[str, dict]:
    """The numbers of the fp8 control and of the half-batch fault."""
    sound = train_readings(cfgfile, traffic, seed, device)
    low = train_readings(cfgfile, traffic, seed, device, "fp8")
    half = train_readings(cfgfile, traffic, seed, device, rows=traffic["batch"] // 2)
    return {"control": judge.train_numbers(low, sound),
            "half_batch": judge.train_numbers(half, sound)}


def prefill_control(cfgfile: dict, traffic: dict, seed: int, device) -> Dict[str, dict]:
    """The fp8 control's numbers on the first ``check_requests`` prompt
    batches of the pool, as the harness reads the program's."""
    ref = manifest.module("reference", cfgfile["reference"])
    run = cfgfile["run"]
    spec = ref.weight_spec(run)
    pool = traffic_mod.pool(traffic, run["vocab"], seed)[:traffic["check_requests"]]
    P = _params(spec, seed, device)
    served, refs = [], []
    with torch.no_grad():
        for b in pool:
            tokens = torch.from_numpy(b["tokens"]).long().to(device)
            low = ref.last_logits(P, run, tokens, "fp8")
            served.append((low.argmax(-1), low))
            refs.append(ref.last_logits(P, run, tokens, "fp32"))
    return {"control": judge.prefill_numbers(served, refs, run["vocab"])}
