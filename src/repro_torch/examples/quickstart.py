"""Quickstart: OEF fair-share allocation in 30 lines.

The twin of the JAX package's ``examples/quickstart.py``. Three tenants
with different speedup profiles share a heterogeneous cluster; the
non-cooperative (strategy-proof) and cooperative (envy-free +
sharing-incentive) OEF allocations are computed by the LP, the oracle, as
the JAX example computes them, then by the device tiers on ``--device``:
the water-filling solve (on the card one launch of the fused water-filling
kernel) and the cooperative primal-dual tier through ``backends.dispatch``
(fused PD segments of the envy-gap kernel). The fairness properties and
the strategy-proofness probe run on the device tiers' answers.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import backends, oef, properties
from repro_torch.core.torch_solve import resolve_device

# Speedup matrix from the paper's running example (§2.4): three users on two
# GPU types; user 3's model accelerates 4x on the fast GPU, user 1 only 2x.
W = np.array([
    [1.0, 2.0],
    [1.0, 3.0],
    [1.0, 4.0],
])
m = np.array([1.0, 1.0])  # one device of each type
SP_TRIALS = 32


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Print the allocations, properties and probe; return the numbers
    printed (``noncoop`` / ``coop``: the LP's and the device tier's X and
    throughputs and their largest difference; ``properties``; ``sp``: the
    probe's throughputs, gain and the device solves it made)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    out = {"device": str(dev)}

    print(f"=== non-cooperative OEF (strategy-proof) on {dev} ===")
    lp = oef.solve_noncoop(W, m)
    tier = oef.solve_noncoop_waterfill_torch(W, m, device=dev)
    out["noncoop"] = _compare(lp, tier)
    print("allocation:\n", np.round(tier.X, 4))
    print("per-user normalized throughput:", np.round(tier.throughput, 4))
    print("equal throughput =>", np.allclose(tier.throughput, tier.throughput[0]))
    print(f"LP oracle vs device tier: max |dX| {out['noncoop']['max_diff']:.2e}")

    print(f"\n=== cooperative OEF (envy-free + sharing-incentive) on {dev} ===")
    lp = oef.solve_coop(W, m)
    tier = backends.dispatch("oef-coop", W, m, backend="torch", device=dev)
    out["coop"] = _compare(lp, tier)
    out["coop"]["backend"] = tier.meta.get("backend")
    out["coop"]["fallback_from"] = tier.meta.get("fallback_from")
    out["coop"]["pd_iters"] = tier.meta.get("pd_iters")
    print("allocation:\n", np.round(tier.X, 4))
    print("per-user normalized throughput:", np.round(tier.throughput, 4))
    out["properties"] = properties.property_report(W, tier.X, m)
    print("properties:", out["properties"])
    print(f"LP oracle vs device tier ({out['coop']['backend']}): "
          f"max |dX| {out['coop']['max_diff']:.2e}")

    print("\n=== cheating does not pay (SP probe on non-coop OEF) ===")
    solves = []

    def mechanism(Wx, mx):
        alloc = oef.solve_noncoop_waterfill_torch(Wx, mx, device=dev)
        solves.append(alloc)
        return alloc

    probe = properties.strategy_proofness_probe(mechanism, W, m, user=0,
                                                n_trials=SP_TRIALS)
    out["sp"] = {"honest": probe.honest_throughput, "best_cheat": probe.best_cheat_throughput,
                 "gain": probe.gain, "solves": len(solves), "trials": SP_TRIALS}
    print(f"honest true throughput: {probe.honest_throughput:.4f}")
    print(f"best cheating true throughput: {probe.best_cheat_throughput:.4f}")
    print("gain from lying:", f"{probe.gain:+.2e}  (<= 0 up to solver tolerance)")
    print(f"device solves: {len(solves)} (the honest one and {SP_TRIALS} trials)")
    return out


def _compare(lp, tier) -> dict:
    return {"lp_X": lp.X, "X": tier.X, "throughput": tier.throughput,
            "max_diff": float(np.max(np.abs(lp.X - tier.X)))}


if __name__ == "__main__":
    main()
