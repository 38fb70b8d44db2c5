"""Fused softmax cross-entropy: the CUDA kernel and its plain version.

For (N, V) logits and (N,) integer targets, the per-token loss is

    loss[n] = logsumexp(logits[n]) - logits[n, targets[n]]

in float32, with the gold logit taken as 0 when a target lies outside
``[0, V)``, so such a row's loss is its logsumexp: what the JAX package's
Pallas kernel (``repro/kernels/xent.py``) computes, whose gold accumulator
never meets the target then. (The jnp oracle ``xent_ref`` instead wraps a
negative id and gives NaN for an id >= V.)

:func:`softmax_xent` takes float32 or bfloat16 logits of any (N, V) and
int32 or int64 targets. On a CUDA tensor it launches the hand-written
kernel of ``csrc/xent.cu`` (built with ``nvcc`` on first use, see
:mod:`repro_torch.kernels._build`), which reads each logit once; on a CPU
tensor it runs :func:`softmax_xent_plain`. There is no other route: a CUDA
tensor never falls back to the plain version, a failed build or launch
raises ``KernelError``, and logits that require grad raise ``RuntimeError``
on the card (the kernel has no backward yet). The two sum in different orders, so they agree to
float32 rounding (the JAX kernel test's atol 1e-4 / rtol 1e-5).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import KernelError

#: logits dtypes the kernel takes, and their codes in csrc/xent.cu.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: target dtypes the kernel takes, and their codes.
TARGET_DTYPES = {torch.int32: 0, torch.int64: 1}


def softmax_xent_plain(logits, targets):
    """Plain torch version: float32 logsumexp minus the gold logit, the gold
    logit masked to 0 for targets outside ``[0, V)``. Returns (N,) float32."""
    lf = logits.float()
    V = lf.shape[1]
    t = targets.long()
    inside = (t >= 0) & (t < V)
    gold = torch.gather(lf, 1, torch.where(inside, t, 0)[:, None])[:, 0]
    return torch.logsumexp(lf, dim=-1) - torch.where(inside, gold, 0.0)


_LIB = None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library, setting its C
    signatures once; raises :class:`~repro_torch.kernels.KernelError` when
    ``nvcc`` is missing or the build fails."""
    global _LIB
    if _LIB is None:
        lib = _build.load("xent")
        lib.softmax_xent.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.softmax_xent.restype = ctypes.c_int
        lib.xent_error_string.argtypes = [ctypes.c_int]
        lib.xent_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(logits, targets) -> torch.Tensor:
    """Launch the CUDA kernel on checked operands; returns (N,) float32."""
    _build.refuse_grad("softmax_xent", logits=logits)
    lib = load()
    N, V = logits.shape
    loss = torch.empty((N,), dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.softmax_xent(logits.data_ptr(), targets.data_ptr(), loss.data_ptr(),
                               N, V, DTYPES[logits.dtype],
                               TARGET_DTYPES[targets.dtype], stream)
    if err != 0:
        raise KernelError(
            f"softmax_xent kernel launch failed: "
            f"{lib.xent_error_string(err).decode()} (cuda error {err})")
    softmax_xent.launches += 1
    return loss


def softmax_xent(logits, targets):
    """Per-token cross-entropy losses (N,) in float32.

    logits: (N, V) float32 or bfloat16; targets: (N,) int32 or int64, on the
    same device. CUDA tensors go through the kernel
    (``softmax_xent.launches`` counts its launches) and ``logits`` must be
    contiguous; CPU tensors go through :func:`softmax_xent_plain`.
    """
    if logits.dim() != 2 or targets.dim() != 1 or targets.shape[0] != logits.shape[0]:
        raise ValueError(f"logits must be (N, V) and targets (N,), got "
                         f"{tuple(logits.shape)} and {tuple(targets.shape)}")
    N, V = logits.shape
    if min(N, V) < 1:
        raise ValueError(f"softmax_xent needs N, V >= 1, got {tuple(logits.shape)}")
    if logits.dtype not in DTYPES:
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if targets.dtype not in TARGET_DTYPES:
        raise TypeError(f"targets must be int32 or int64, got {targets.dtype}")
    dev = logits.device
    if targets.device != dev:
        raise ValueError(f"targets are on {targets.device}, logits on {dev}")
    if dev.type == "cuda":
        if not logits.is_contiguous():
            raise ValueError("logits must be contiguous for the kernel")
        if N > 2**31 - 1:
            raise ValueError(f"the softmax_xent kernel takes N < 2**31, got {N}")
        return _launch(logits, targets.contiguous())
    if dev.type == "cpu":
        return softmax_xent_plain(logits, targets)
    raise ValueError(f"softmax_xent runs on cuda or cpu, not {dev}")


#: launches of the CUDA kernel in this process (plain-version calls excluded).
softmax_xent.launches = 0
