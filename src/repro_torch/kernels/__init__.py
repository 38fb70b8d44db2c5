"""Hand-written CUDA kernels of the port, each beside its plain torch version.

  - waterfill — the water-filling feasibility mass of the non-cooperative
    OEF solve (``csrc/waterfill.cu``); replaces the JAX package's Pallas
    kernel ``kernels/waterfill.py``;
  - envy — the pairwise envy-gap matrix of the cooperative primal–dual
    solve (``csrc/envy.cu``); replaces the Pallas kernel ``kernels/envy.py``;
  - rglru_scan — the RG-LRU linear recurrence of the model's prefill
    (``csrc/rglru_scan.cu``); replaces the Pallas kernel
    ``kernels/rglru_scan.py``. Its public wrapper is ``ops.rglru_scan``.

A kernel that fails to build, load or launch raises :class:`KernelError`.
"""
from ._build import KernelError
from .envy import envy_gaps, envy_gaps_plain

__all__ = ["KernelError", "envy_gaps", "envy_gaps_plain"]
