"""Runnable examples of the port, twins of the JAX package's ``examples/``:

  - ``cluster_scheduler_e2e`` — the OEF scheduler allocating a simulated
    heterogeneous fleet across tenants that train real models;
  - ``serve_decode`` — prefill a batch of prompts, then batched greedy
    decode.

Run as ``python -m repro_torch.examples.<name> [--device cpu]``; the
default device is ``cuda``, which raises when torch sees no GPU.
"""
