"""Hand-written CUDA kernels of the port, each beside its plain torch version.

  - waterfill — the water-filling feasibility mass of the non-cooperative
    OEF solve (``csrc/waterfill.cu``); replaces the JAX package's Pallas
    kernel ``kernels/waterfill.py``.

A kernel that fails to build, load or launch raises :class:`KernelError`.
"""
from ._build import KernelError

__all__ = ["KernelError"]
