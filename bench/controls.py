"""Read the control and the planted faults of a cell on the card, at the
cell's own size, on several seeds in one process (see
``bench/harness/control.py``): one JSON line a seed.

    python3 bench/controls.py --workload <cell> --seeds 11,12,13

The benchmark's runs (``bench/run.py``) never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench.harness import cli, control, manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    cli._reference_mode()
    man = manifest.Manifest()
    cell = man.cell(args.workload)
    cfgfile, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    read = control.train_control if traffic["kind"] == "train" else control.prefill_control
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = read(cfgfile, traffic, seed, torch.device("cuda:0"))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.time() - t0, **out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
