"""Public wrappers of the port's workload kernels, as ``repro.kernels.ops``.

  - :func:`rglru_scan` — the RG-LRU recurrence (``kernels/rglru_scan.py``,
    CUDA kernel ``csrc/rglru_scan.cu``). The JAX wrapper's ``block_d`` and
    ``interpret`` have no counterpart: the CUDA kernel masks a ragged
    feature edge instead of halving its tiles, and a CPU tensor runs the
    plain version.

Flash attention and the fused cross-entropy come with their kernels.
"""
from .rglru_scan import rglru_scan  # noqa: F401
