"""Public wrappers of the port's workload kernels, as ``repro.kernels.ops``.

  - :func:`flash_attention` and :func:`flash_attention_gqa` — forward
    attention, causal and/or sliding window (``kernels/flash_attention.py``,
    CUDA kernel ``csrc/flash_attention.cu``). ``block_q`` / ``block_k``
    only refuse the sequence lengths the JAX op refuses; the kernel picks
    its own tiles. The GQA form reads KV head ``h // (Hq // Hkv)`` for
    query head ``h`` instead of repeating the KV heads, and raises
    ``ValueError`` when ``Hq % Hkv != 0``.
  - :func:`rglru_scan` — the RG-LRU recurrence (``kernels/rglru_scan.py``,
    CUDA kernel ``csrc/rglru_scan.cu``). The JAX wrapper's ``block_d`` has
    no counterpart: the kernel masks a ragged feature edge instead of
    halving its tiles.
  - :func:`softmax_xent` — the fused per-token cross-entropy
    (``kernels/xent.py``, CUDA kernel ``csrc/xent.cu``). The JAX wrapper's
    ``block_n`` / ``block_v`` do not change the result and have no
    counterpart.

The JAX wrappers' ``interpret`` has no counterpart either: CUDA tensors
launch the kernel (or raise ``KernelError``), CPU tensors run the plain
version.
"""
from .flash_attention import flash_attention, flash_attention_gqa  # noqa: F401
from .rglru_scan import rglru_scan  # noqa: F401
from .xent import softmax_xent  # noqa: F401
