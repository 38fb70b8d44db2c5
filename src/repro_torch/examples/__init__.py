"""Runnable examples of the port, twins of the JAX package's ``examples/``:

  - ``cluster_scheduler_e2e`` — the OEF scheduler allocating a simulated
    heterogeneous fleet across tenants that train real models;
  - ``serve_decode`` — prefill a batch of prompts, then batched greedy
    decode;
  - ``quickstart`` — OEF on the paper's 3x2 example: non-coop and coop by
    the LP and by the device tiers, the properties, a strategy-proofness
    probe;
  - ``online_service`` — a synthetic trace, its CSV round trip, a coop
    replay through the online scheduler and the cross-validation against
    the round simulator.

Run as ``python -m repro_torch.examples.<name> [--device cpu]``; the
default device is ``cuda``, which raises when torch sees no GPU.
"""
