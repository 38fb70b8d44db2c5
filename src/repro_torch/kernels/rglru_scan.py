"""RG-LRU linear-recurrence scan: the CUDA kernel and its plain version.

Every RG-LRU layer of a RecurrentGemma prefill runs the recurrence

    h_t = a_t * h_{t-1} + b_t        (t = 0..S-1, from h0)

over ``a``, ``b`` of shape (B, S, D), independently per feature, with the
state in float32 and each ``h_t`` stored in the inputs' dtype.

:func:`rglru_scan` takes float32 or bfloat16 ``a`` and ``b`` of any shape
(B, S, D). On a CUDA tensor it launches the hand-written kernel of
``csrc/rglru_scan.cu`` (built with ``nvcc`` on first use, see
:mod:`repro_torch.kernels._build`); on a CPU tensor it runs
:func:`rglru_scan_plain`, the same arithmetic in plain torch ops. There is
no other route: a CUDA tensor never falls back to the plain version, a
failed build or launch raises ``KernelError``, and an input that requires
grad raises ``RuntimeError`` on the card (the kernel has no backward yet).

Both round each step's multiply and add on their own, in the same order, so
kernel and plain version agree to the last bit. (The JAX package's oracle,
``rglru_scan_ref``, is a ``lax.scan`` of ``a_t * h + b_t``; it agrees to
~1e-7 relative.)
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import KernelError

#: operand dtypes the kernel takes, and their codes in csrc/rglru_scan.cu.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rglru_scan_plain(a, b, h0):
    """Plain torch version: a loop over t of ``h = a_t * h + b_t`` in
    float32, written as a separate multiply and add, each ``h`` stored in
    ``a``'s dtype. Returns (B, S, D)."""
    out = torch.empty_like(a)
    h = h0.float()
    for t in range(a.shape[1]):
        h = a[:, t].float() * h
        h = h + b[:, t].float()
        out[:, t] = h
    return out


_LIB = None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library, setting its C
    signatures once; raises :class:`~repro_torch.kernels.KernelError` when
    ``nvcc`` is missing or the build fails."""
    global _LIB
    if _LIB is None:
        lib = _build.load("rglru_scan")
        lib.rglru_scan.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                   + [ctypes.c_void_p])
        lib.rglru_scan.restype = ctypes.c_int
        lib.rglru_error_string.argtypes = [ctypes.c_int]
        lib.rglru_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(a, b, h0) -> torch.Tensor:
    """Launch the CUDA kernel on checked operands (``h0`` float32); returns
    (B, S, D) in ``a``'s dtype."""
    _build.refuse_grad("rglru_scan", a=a, b=b, h0=h0)
    lib = load()
    B, S, D = a.shape
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                             out.data_ptr(), B, S, D, DTYPES[a.dtype], stream)
    if err != 0:
        raise KernelError(
            f"rglru_scan kernel launch failed: "
            f"{lib.rglru_error_string(err).decode()} (cuda error {err})")
    rglru_scan.launches += 1
    return out


def rglru_scan(a, b, h0):
    """The recurrence ``h_t = a_t * h_{t-1} + b_t`` from ``h0``.

    a, b: (B, S, D), both float32 or both bfloat16; h0: (B, D), any float
    dtype (the state is float32). Returns (B, S, D) in ``a``'s dtype. All
    on one device. CUDA tensors go through the kernel
    (``rglru_scan.launches`` counts its launches) and must be contiguous;
    CPU tensors go through :func:`rglru_scan_plain`.
    """
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"a and b must share a (B, S, D) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, S, D = a.shape
    if min(B, S, D) < 1:
        raise ValueError(f"rglru_scan needs B, S, D >= 1, got {tuple(a.shape)}")
    if tuple(h0.shape) != (B, D):
        raise ValueError(f"h0 has shape {tuple(h0.shape)}; with a "
                         f"{tuple(a.shape)} it must be {(B, D)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must both be float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if not h0.is_floating_point():
        raise TypeError(f"h0 must be a float tensor, got {h0.dtype}")
    dev = a.device
    for name, t in (("b", b), ("h0", h0)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
    if dev.type == "cuda":
        for name, t in (("a", a), ("b", b)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous for the kernel")
        if B > 65535:
            raise ValueError(f"the rglru_scan kernel takes B <= 65535, got {B}")
        return _launch(a, b, h0.float().contiguous())
    if dev.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    raise ValueError(f"rglru_scan runs on cuda or cpu, not {dev}")


#: launches of the CUDA kernel in this process (plain-version calls excluded).
rglru_scan.launches = 0
