#!/usr/bin/env python
"""Time the sLSTM kernels of the checkout this runs from, on the card.

Builds ``csrc/slstm.cu`` of that checkout and times its forward (at
inference and keeping every step) and backward kernels by CUDA-graph replay
(``chip_smoke.graph_ms``) at xlstm-350m's prefill shape (8, 2048, d 1024, H
4) and, where the checkout has the wide route (``slstm.slstm_plan``), at the
xLSTM paper's 1.3B width (8, 2048, d 2048, H 4); the backward on the
kernel's own saved forward. Prints the card's name and power limit, then
one JSON line of milliseconds. To compare two commits on one card, run it
from each checkout in turns within one session (A, B, B, A): the operands
are seeded, so the runs time the same work.

Usage (from the root of a checkout, on a machine with the card):
    python <path to this file>
"""
import json
import os
import subprocess
import sys

ROOT = os.getcwd()
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, slstm as sl  # noqa: E402

SHAPES = (("prefill", 8, 2048, 1024, 4), ("xl1b3_prefill", 8, 2048, 2048, 4))


def main() -> int:
    if not torch.cuda.is_available():
        print("slstm_times: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _build.build("slstm")
    sl.load()
    out = {"checkout": ROOT}
    for label, B, S, d, H in SHAPES:
        if d // H > 256 and not hasattr(sl, "slstm_plan"):
            continue  # a checkout without the wide route refuses this width
        g = torch.Generator().manual_seed(51)
        card = [t.cuda() for t in cs.slstm_operands(torch, g, B, S, d, H, False)]
        _, cs_, ns, ms, pre = sl._launch(*card, True)
        dhs = torch.randn((B, S, d), generator=g).cuda()
        zeros = [torch.zeros_like(card[2]) for _ in range(3)]
        args = (card[1], pre, cs_, ns, ms, *card[3:], dhs, *zeros)
        out[label] = {name: cs.graph_ms(torch, fn, reps=3, rounds=5) for name, fn in (
            ("forward", lambda: sl._launch(*card, False)),
            ("forward_saving", lambda: sl._launch(*card, True)),
            ("backward", lambda: sl._launch_backward(*args)))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
