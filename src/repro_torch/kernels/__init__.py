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

One more has no Pallas counterpart:

  - slstm — the sLSTM recurrence of xlstm-350m, forward and backward, each
    one cooperative launch (``csrc/slstm.cu``), at every (d, H) with H
    dividing d. A step is one exchange between the SMs (a per-block flag
    over a slice of the step's output). On the narrow route (a head of at
    most 256, at most twice the SMs in groups of 8 features) a block for
    each 8 features (one an SM at xlstm-350m's width) holds its share of
    ``r`` in registers, with the step-independent operands on their way
    ahead of it; on the wide route (wider heads, more groups: the xLSTM
    paper's 760M, 1.3B and 2.7B widths) a block an SM owns several groups,
    its share of ``r`` in shared memory and then device memory
    (``slstm.slstm_plan`` says which route a shape takes).
    On an NVIDIA H100 80GB HBM3 at 700.00 W a step at xlstm-350m's width
    takes ~3.0 us forward, ~3.4 us backward, against 1.76 us for the
    exchange alone (the chain's floor) and 0.25 us of products at the FP32
    rate; at 1.3B's width (d 2048, hd 512) ~8.2 and ~8.4 us.
    It replaces the JAX model's ``jax.lax.scan`` over time
    (``models/layers.py`` ``slstm_apply``, ``slstm_decode``), which XLA
    runs as one loop on the device. ``models.layers.SLSTM`` calls it in
    prefill, decode and training. Its CPU tests are
    ``tests/test_torch_slstm.py``; ``chip_smoke.py`` holds it to its plain
    version on the card in phase 51.

The last three are the public ops of ``ops`` (``rglru_scan``,
``flash_attention``, ``flash_attention_gqa``, ``softmax_xent``), and
``ref`` holds the plain oracles they are held to. A kernel that fails to
build, load or launch raises :class:`KernelError`. :func:`wrappers` names
every wrapper that launches a kernel, each with its ``launches`` counter;
:func:`launch_counts` reads them all.
"""
from typing import Callable, Dict

from ._build import KernelError
from .envy import envy_gaps, envy_gaps_plain

__all__ = ["KernelError", "envy_gaps", "envy_gaps_plain", "launch_counts", "wrappers"]


def wrappers() -> Dict[str, Callable]:
    """Every wrapper of a hand-written kernel, by name. Each adds one to
    its ``launches`` where it launches its kernel, and nowhere else."""
    from . import envy, flash_attention, rglru_scan, slstm, waterfill, xent

    return {"waterfill_masses": waterfill.waterfill_masses,
            "waterfill_solve": waterfill.waterfill_solve,
            "envy_gaps": envy.envy_gaps, "pd_segment": envy.pd_segment,
            "rglru_scan": rglru_scan.rglru_scan,
            "rglru_scan_backward": rglru_scan.rglru_scan_backward,
            "flash_attention": flash_attention.flash_attention,
            "softmax_xent": xent.softmax_xent,
            "slstm_scan": slstm.slstm_scan,
            "slstm_scan_backward": slstm.slstm_scan_backward}


def launch_counts() -> Dict[str, int]:
    """The ``launches`` of every kernel wrapper in this process, by name."""
    return {name: w.launches for name, w in wrappers().items()}
