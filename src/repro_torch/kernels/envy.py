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

:func:`pd_segment` is the whole PD segment of the solver around the gaps
(``seg`` preconditioned PDHG steps and the restart to their average) as one
launch of the fused kernel ``pd_segment_kernel`` of the same source; on a
CPU tensor it runs :func:`pd_segment_plain`, the step as torch ops with one
:func:`envy_gaps` call per step. The route of a segment
(:func:`fused_segment`) goes by device and shape: a CUDA segment with
``G <= PD_FUSED_MAX_G`` launches the fused kernel once; a larger G runs
:func:`pd_segment_plain` on the card, one ``envy_gaps`` launch per step (the
fused kernel keeps its state in shared memory, which caps G); a CPU segment
runs :func:`pd_segment_plain` on the plain gaps. A fused launch that fails
raises ``KernelError`` and is never retried stepwise.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from ._build import KernelError

#: largest device-type count k the kernels take (``kMaxK`` of csrc/envy.cu).
MAX_K = 32
#: largest group count G the fused PD segment takes (``kPdMaxG`` of
#: csrc/envy.cu): its state lives in shared memory, 184 KB at G = 64, k = 32.
PD_FUSED_MAX_G = 64


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
        lib.pd_segment.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.pd_segment.restype = ctypes.c_int
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


# ---------------------------------------------------------------------------
# the PD segment of the cooperative solver
# ---------------------------------------------------------------------------

#: the segment's operands in order, with their shapes in (B, G, k).
_SEGMENT_OPERANDS = (("Wp", "BGk"), ("cnt", "BG"), ("m", "Bk"), ("pairm", "BGG"),
                     ("tau", "BGk"), ("sig_env", "BG"), ("sig_cap", "B1"),
                     ("x", "BGk"), ("p", "Bk"), ("L", "BGG"))


def fused_segment(device, G: int) -> bool:
    """The segment's route: True where it is one launch of the fused kernel
    (:func:`pd_segment`), a CUDA segment with ``G <= PD_FUSED_MAX_G``. Else
    :func:`pd_segment_plain` runs it: on the card one ``envy_gaps`` launch
    per step, on the CPU the plain gaps."""
    return torch.device(device).type == "cuda" and G <= PD_FUSED_MAX_G


def pd_segment_plain(Wp, cnt, m, pairm, tau, sig_env, sig_cap, x, p, L, *,
                     seg: int, envy_fn=None):
    """``seg`` preconditioned PDHG iterations + restart to the running average.

    Batched operands on one device, padded to the group bucket: ``Wp``
    (B, G, k) distinct speedup rows (padding rows have ``cnt = 0`` and
    ``tau = 0`` so their state is pinned at zero), ``cnt`` (B, G), ``m``
    (B, k), ``pairm`` (B, G, G) the envy pair mask (real x real, zero
    diagonal), ``tau`` (B, G, k), ``sig_env`` (B, G), ``sig_cap`` (B, 1),
    and the state ``x`` (B, G, k), ``p`` (B, k), ``L`` (B, G, G). Returns
    the averaged ``(x, p, L)``. Only tensor ops: nothing waits for the host.
    ``envy_fn`` forms the gaps each step (default :func:`envy_gaps`), as the
    JAX tier's segment takes its ``envy_fn``.
    """
    envy_fn = envy_gaps if envy_fn is None else envy_fn
    cnt3 = cnt[:, :, None]
    cvec = cnt3 * Wp
    sig3 = sig_env[:, :, None]
    xs, ps, Ls = torch.zeros_like(x), torch.zeros_like(p), torch.zeros_like(L)
    for _ in range(seg):
        AtY = (cnt3 * p[:, None, :] + L.transpose(1, 2) @ Wp
               - L.sum(dim=2)[:, :, None] * Wp)
        xn = torch.clamp_min(x + tau * (cvec - AtY), 0.0)
        xb = 2.0 * xn - x
        E = envy_fn(Wp, xb) * pairm
        p = torch.clamp_min(p + sig_cap * ((cnt3 * xb).sum(dim=1) - m), 0.0)
        L = torch.clamp_min(L + sig3 * E, 0.0) * pairm
        x = xn
        xs += x
        ps += p
        Ls += L
    inv = 1.0 / seg
    return xs * inv, ps * inv, Ls * inv


def _launch_segment(ops, seg: int):
    """Launch the fused kernel on checked operands; returns (x, p, L)."""
    _build.refuse_grad("pd_segment", **{n: t for (n, _), t in zip(_SEGMENT_OPERANDS, ops)})
    lib = load()
    Wp, x, p, L = ops[0], ops[7], ops[8], ops[9]
    B, G, k = Wp.shape
    outs = (torch.empty_like(x), torch.empty_like(p), torch.empty_like(L))
    with torch.cuda.device(Wp.device):
        stream = torch.cuda.current_stream(Wp.device).cuda_stream
        err = lib.pd_segment(*(t.data_ptr() for t in (*ops, *outs)), B, G, k, seg,
                             stream)
    if err != 0:
        raise KernelError(
            f"pd_segment kernel launch failed: "
            f"{lib.envy_error_string(err).decode()} (cuda error {err})")
    pd_segment.launches += 1
    return outs


def pd_segment(Wp, cnt, m, pairm, tau, sig_env, sig_cap, x, p, L, *, seg: int):
    """The PD segment of :func:`pd_segment_plain` as one fused launch.

    Operands as :func:`pd_segment_plain` takes them: float64, contiguous,
    on one device, with ``G <= PD_FUSED_MAX_G`` and ``k <= MAX_K``. CUDA
    tensors go through the fused kernel (``pd_segment.launches`` counts its
    launches; a failed build or launch raises ``KernelError``); CPU tensors
    go through :func:`pd_segment_plain`.
    """
    ops = (Wp, cnt, m, pairm, tau, sig_env, sig_cap, x, p, L)
    if Wp.dim() != 3:
        raise ValueError(f"Wp must be (B, G, k), got {tuple(Wp.shape)}")
    B, G, k = Wp.shape
    dims = {"B": B, "G": G, "k": k, "1": 1}
    dev = Wp.device
    for (name, spec), t in zip(_SEGMENT_OPERANDS, ops):
        want = tuple(dims[c] for c in spec)
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; with Wp "
                             f"{tuple(Wp.shape)} it must be {want}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Wp on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (1 <= G <= PD_FUSED_MAX_G and 1 <= k <= MAX_K and B >= 1):
        raise ValueError(f"the fused PD segment takes 1 <= G <= {PD_FUSED_MAX_G} "
                         f"and 1 <= k <= {MAX_K}, got G={G}, k={k}")
    if seg < 1:
        raise ValueError(f"seg must be >= 1, got {seg}")
    if dev.type == "cuda":
        return _launch_segment(ops, seg)
    if dev.type == "cpu":
        return pd_segment_plain(*ops, seg=seg)
    raise ValueError(f"pd_segment runs on cuda or cpu, not {dev}")


#: launches of the fused kernel in this process (plain-version calls excluded).
pd_segment.launches = 0
