"""Pairwise tenant envy-gap matrix: the CUDA kernel and its plain version.

The cooperative OEF program (Eq. 10) is an LP whose fairness constraints are
the pairwise envy gaps

    E[l, i] = W_l . x_i - W_l . x_l        (feasible iff E <= 0 for l != i)

and the primal–dual solver in :mod:`repro_torch.core.torch_coop` evaluates
the full (G, G) gap matrix once per iteration: it is both the dual-update
operand and the feasibility residual.

:func:`envy_gaps` takes ``(G, k)`` operands or a batch ``(B, G, k)``. On a
CUDA tensor it launches the hand-written kernel of ``csrc/envy.cu`` (built
with ``nvcc`` on first use, see :mod:`repro_torch.kernels._build`); on a CPU
tensor it runs :func:`envy_gaps_plain`, the same arithmetic in plain torch
ops. There is no other route: a CUDA tensor never falls back to the plain
version, and a failed build or launch raises ``KernelError``.

Both compute each sum over ``j = 0..k-1`` as separately rounded multiplies
and adds, then subtract the own term, so kernel and plain version agree to
the last bit. (The JAX package's reference forms ``W @ X.T``, whose
summation order is the BLAS's; it agrees to ~1e-15.)
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from ._build import KernelError

#: largest device-type count k the kernel takes (``kMaxK`` of csrc/envy.cu).
MAX_K = 32


def _batched(W, X) -> Tuple[bool, torch.Tensor, torch.Tensor]:
    """Check shapes and lift one instance to a batch of one."""
    if tuple(X.shape) != tuple(W.shape):
        raise ValueError(f"W and X must share (G, k) or (B, G, k); got "
                         f"{tuple(W.shape)} vs {tuple(X.shape)}")
    if W.dim() not in (2, 3) or W.shape[-1] < 1:
        raise ValueError(f"W must be (G, k) or (B, G, k) with k >= 1, got "
                         f"{tuple(W.shape)}")
    single = W.dim() == 2
    if single:
        W, X = W[None], X[None]
    return single, W, X


def envy_gaps_plain(W, X):
    """Plain torch version on batched ``(B, G, k)`` operands; returns
    ``(B, G, G)``. Each sum runs over ``j = 0..k-1`` as separate multiplies
    and adds, the kernel's order."""
    own = W[..., 0] * X[..., 0]
    cross = W[..., :, None, 0] * X[..., None, :, 0]
    for j in range(1, W.shape[-1]):
        own = own + W[..., j] * X[..., j]
        cross = cross + W[..., :, None, j] * X[..., None, :, j]
    return cross - own[..., :, None]


_LIB = None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library, setting its C
    signatures once; raises :class:`~repro_torch.kernels.KernelError` when
    ``nvcc`` is missing or the build fails."""
    global _LIB
    if _LIB is None:
        lib = _build.load("envy")
        lib.envy_gaps.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.envy_gaps.restype = ctypes.c_int
        lib.envy_error_string.argtypes = [ctypes.c_int]
        lib.envy_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(W, X) -> torch.Tensor:
    """Launch the CUDA kernel on batched, checked operands; returns (B, G, G)."""
    lib = load()
    B, G, k = W.shape
    E = torch.empty((B, G, G), dtype=torch.float64, device=W.device)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.envy_gaps(W.data_ptr(), X.data_ptr(), E.data_ptr(), B, G, k,
                            stream)
    if err != 0:
        raise KernelError(
            f"envy_gaps kernel launch failed: "
            f"{lib.envy_error_string(err).decode()} (cuda error {err})")
    envy_gaps.launches += 1
    return E


def envy_gaps(W, X):
    """Envy-gap matrix ``E[l, i] = W_l.x_i - W_l.x_l``.

    W: (G, k) speedup rows; X: (G, k) allocation bundles, same row order;
    or both (B, G, k). Returns (G, G) (or (B, G, G)); the diagonal is zero
    and the caller masks it. Operands are float64 on one device. CUDA
    tensors go through the kernel (``envy_gaps.launches`` counts its
    launches) and must be contiguous; CPU tensors go through
    :func:`envy_gaps_plain`.
    """
    single, W, X = _batched(W, X)
    dev = W.device
    for name, t in (("W", W), ("X", X)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
    if X.device != dev:
        raise ValueError(f"X is on {X.device}, W on {dev}")
    if dev.type == "cuda":
        for name, t in (("W", W), ("X", X)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous for the kernel")
        if W.shape[-1] > MAX_K:
            raise ValueError(f"the envy kernel takes k <= {MAX_K}, got {W.shape[-1]}")
        E = _launch(W, X)
    elif dev.type == "cpu":
        E = envy_gaps_plain(W, X)
    else:
        raise ValueError(f"envy_gaps runs on cuda or cpu, not {dev}")
    return E[0] if single else E


#: launches of the CUDA kernel in this process (plain-version calls excluded).
envy_gaps.launches = 0
