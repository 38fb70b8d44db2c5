"""End to end: the OEF scheduler allocating a heterogeneous fleet
across tenants running REAL PyTorch training jobs.

The twin of the JAX package's ``examples/cluster_scheduler_e2e.py``, with
its fleet, profiles and constants. Three tenants train different
architectures (reduced configs). Each scheduling round:
  1. the ProfilingAgent derives each job's speedup vector across the fleet
     from its analytic roofline costs (§4.1 adaptation — on real hardware
     this is a measured mini-batch run);
  2. the OEF fair-share evaluator solves the cooperative allocation;
  3. the rounding placer converts shares to whole devices;
  4. every tenant's Trainer executes a number of optimizer steps proportional
     to its granted device-throughput (device-seconds x speedup), then
     checkpoints — an allocation change is an elastic resize + restore.

Run:  PYTHONPATH=src python -m repro_torch.examples.cluster_scheduler_e2e [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import get_smoke
from repro_torch.core import ClusterSpec, ProfilingAgent, Tenant, WorkloadCost
from repro_torch.core import oef
from repro_torch.core.placement import RoundingPlacer
from repro_torch.core.torch_solve import resolve_device
from repro_torch.launch.train import FLEET_M, FLEET_TYPES
from repro_torch.models.config import ShapeCell
from repro_torch.models.costs import model_flops, param_bytes
from repro_torch.runtime import Trainer, TrainerConfig

FLEET_CLUSTER = ClusterSpec(types=FLEET_TYPES, m=FLEET_M)
ROUND_SECONDS = 60.0
N_ROUNDS = 3
STEPS_PER_UNIT = 2  # training steps per granted device-throughput unit


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    agent = ProfilingAgent()
    arch_names = ["qwen2-1.5b", "gemma3-4b", "xlstm-350m"]
    tenants, trainers = [], {}
    cell = ShapeCell("train_small", "train", 128, 4)
    for name in arch_names:
        cfg = get_smoke(name)
        # analytic profile: per-step flops & bytes of this tenant's job
        cost = WorkloadCost(name=name, flops=model_flops(cfg, cell) / 4,
                            hbm_bytes=float(param_bytes(cfg)) * 3 + 1e9 * 0.1)
        profile = agent.profile(cost)
        tenants.append(Tenant(name=name, job_types=(profile,)))
        trainers[name] = Trainer(cfg, TrainerConfig(
            seq_len=64, global_batch=4, total_steps=500,
            ckpt_dir=tempfile.mkdtemp(prefix=f"oef-{name}-"), ckpt_every=10),
            device=device)
        print(f"tenant {name}: speedup vector "
              f"{np.round(np.asarray(profile.speedup), 3)}")

    placer = RoundingPlacer(len(tenants), FLEET_CLUSTER.m)
    for rnd in range(N_ROUNDS):
        ta = oef.evaluate_tenants(tenants, FLEET_CLUSTER, mode="cooperative")
        real = placer.round_shares(ta.X)
        print(f"\n-- round {rnd}: fractional shares\n{np.round(ta.X, 2)}")
        print(f"   integer grants\n{real}")
        for ti, tenant in enumerate(tenants):
            speedups = np.asarray(tenant.job_types[0].speedup)
            throughput_units = float(np.dot(speedups, real[ti]))
            steps = max(1, int(throughput_units * STEPS_PER_UNIT))
            out = trainers[tenant.name].run(steps)
            print(f"   {tenant.name}: {steps} steps "
                  f"(granted units {throughput_units:.2f}), "
                  f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    print(f"\nall tenants trained under OEF allocations on {device}; "
          f"checkpoints on disk.")


if __name__ == "__main__":
    main()
