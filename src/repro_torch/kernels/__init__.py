"""Hand-written CUDA kernels of the port, each beside its plain torch version.

Every Pallas kernel of the JAX package has its counterpart here:

  - waterfill — the water-filling feasibility mass of the non-cooperative
    OEF solve (``csrc/waterfill.cu``); replaces the Pallas kernel
    ``kernels/waterfill.py``. The same source holds the fused solve
    (``waterfill_solve``): the whole multisection solve in one launch, which
    the solve tier runs on the card;
  - envy — the pairwise envy-gap matrix of the cooperative primal–dual
    solve (``csrc/envy.cu``); replaces the Pallas kernel ``kernels/envy.py``.
    The same source holds the fused PD segment (``pd_segment``): a whole
    segment of the primal–dual solve in one launch, which the coop tier runs
    on the card up to ``PD_FUSED_MAX_G`` groups;
  - rglru_scan — the RG-LRU linear recurrence of the model's prefill
    (``csrc/rglru_scan.cu``); replaces the Pallas kernel
    ``kernels/rglru_scan.py``;
  - flash_attention — forward online-softmax attention, causal and/or
    sliding window, GQA without copied KV heads
    (``csrc/flash_attention.cu``); replaces the Pallas kernel
    ``kernels/flash_attention.py``;
  - xent — the fused per-token softmax cross-entropy (``csrc/xent.cu``);
    replaces the Pallas kernel ``kernels/xent.py``.

The last three are the public ops of ``ops`` (``rglru_scan``,
``flash_attention``, ``flash_attention_gqa``, ``softmax_xent``), and
``ref`` holds the plain oracles they are held to. A kernel that fails to
build, load or launch raises :class:`KernelError`.
"""
from ._build import KernelError
from .envy import envy_gaps, envy_gaps_plain

__all__ = ["KernelError", "envy_gaps", "envy_gaps_plain"]
