"""The numbers that decide ``correct``, each against its limit.

Training (the first steps the set-up drove, against the reference's same
steps from the same weights and batches):

  - ``loss_rel``: the largest over the steps of |loss - reference's| over
    the reference's loss;
  - ``grad_gap``: the median over the weights of the gap between the norm
    of a weight's first gradient as the optimizer took it and the
    reference's, over the reference's (the worst weight's gap is printed
    beside it: it is the noise of the mLSTM's 8-element gate bias, whose
    gradient sums 16 k cancelling terms, and swings from seed to seed);
  - ``change_gap``: by the worst weight, the gap between the norm of its
    change over the steps and the reference's, over the reference's norm
    of that weight or of the median weight, whichever is larger, leaving
    out weights whose reference first gradient is under a thousandth of
    the median weight's (they move by round-off alone).

Prefill (the requests sampled from those the window finished, against the
reference's last-position logits of the same prompts):

  - ``logit_gap``: the widest gap between a served logit and the
    reference's, over the root-mean-square of the reference's logits of
    that prompt, the largest over the sampled prompts.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

#: a weight whose first gradient is under this share of the median weight's
#: is left out of ``change_gap``
STILL = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: List[str]
             ) -> Tuple[float, str]:
    """The worst weight's gap (see above) and its name."""
    if not names:
        return math.inf, ""
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog.get(n, math.nan) - ref[n]) / max(ref[n], med, 1e-30)
        gap = math.inf if math.isnan(gap) else gap
        if gap > worst or not at:
            worst, at = gap, n
    return worst, at


def train_numbers(prog: dict, ref: dict, where: Dict[str, str] = None) -> Dict[str, float]:
    """The three numbers; ``where``, if given, gets the worst weights'
    names and the worst first-gradient gap."""
    lp, lr = prog["losses"], ref["losses"]
    loss_rel = max((abs(a - b) / abs(b) for a, b in zip(lp, lr)), default=math.inf)
    if len(lp) != len(lr) or any(math.isnan(a) for a in lp):
        loss_rel = math.inf
    names = sorted(ref["grad"])
    med = statistics.median(ref["grad"][n] for n in names)
    moving = [n for n in names if ref["grad"][n] >= STILL * med]
    gaps = [abs(prog["grad"].get(n, math.nan) - ref["grad"][n]) / max(ref["grad"][n], 1e-30)
            for n in names]
    grad = math.inf if any(math.isnan(g) for g in gaps) or not gaps else statistics.median(gaps)
    worst, g_at = leaf_gap(prog["grad"], ref["grad"], names)
    change, c_at = leaf_gap(prog["change"], ref["change"], moving)
    if where is not None:
        where.update(grad_gap=g_at, change_gap=c_at, grad_worst=f"{worst!r}")
    return {"loss_rel": loss_rel, "grad_gap": grad, "change_gap": change}


def prefill_numbers(served: List[Tuple[torch.Tensor, torch.Tensor]],
                    ref: List[torch.Tensor], vocab: int) -> Dict[str, float]:
    """``served``: (first tokens (B,), last-position logits (B, >= vocab))
    of each sampled request; ``ref``: the reference's (B, vocab) logits."""
    gap = 0.0
    for (_, logits), r in zip(served, ref):
        r = r.double().cpu()
        p = logits[:, :vocab].double().cpu()
        rms = torch.sqrt(torch.mean(r * r, dim=1))
        gap = max(gap, float(((p - r).abs().max(dim=1).values / rms).max()))
    return {"logit_gap": gap if served else math.inf}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell's limits name within its limit (a named
    number the run did not read fails)."""
    return all(numbers.get(k, math.inf) <= lim for k, lim in limits.items())
