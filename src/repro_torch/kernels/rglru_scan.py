"""RG-LRU linear-recurrence scan: the CUDA kernels and their plain versions.

Every RG-LRU layer of a RecurrentGemma forward runs the recurrence

    h_t = a_t * h_{t-1} + b_t        (t = 0..S-1, from h0)

over ``a``, ``b`` of shape (B, S, D), independently per feature, with the
state in float32 and each ``h_t`` stored in the inputs' dtype.

:func:`rglru_scan` takes float32 or bfloat16 ``a`` and ``b`` of any shape
(B, S, D). On a CUDA tensor it launches a hand-written kernel of
``csrc/rglru_scan.cu`` (built with ``nvcc`` on first use, see
:mod:`repro_torch.kernels._build`); on a CPU tensor it runs
:func:`rglru_scan_plain`, the same arithmetic in plain torch ops. A CUDA
tensor never falls back to the plain version or to the other kernel: a
failed build, tensor-map encode or launch raises ``KernelError``.

Two kernels each way, chosen by :func:`_route` from the dtype, D and the
operands' addresses alone (never on failure):

  - ``"tma"``: rows of D elements a multiple of 16 bytes (D % 4 == 0 in
    float32, D % 8 == 0 in bfloat16) and every operand 16-byte aligned,
    what TMA needs. One warp walks 32 features of one batch row (64 in
    the backward, two chains a lane), fed by a ring of shared-memory tiles
    of 32 steps per operand that TMA fills while the lanes walk the tile
    that has landed (7 tiles a block in flight forward, 2 backward); the
    results leave through shared memory by TMA stores. Every shape the
    model runs takes it.
  - ``"direct"``: everything else (another D, a misaligned view). One
    thread per feature loads 16 steps, waits for them and walks them, so
    every 16 steps cost a round trip to memory. It bound the first design
    on an H100 at ~230 us at the training shape (2, 2048, 2560), 16% of
    its byte bound; the ring keeps the loads in flight instead.

Both walk each chain's steps in order, one after the other, so neither
re-associates the recurrence (a chunked or associative scan would).
``rglru_scan.launches`` counts the launches of both forward kernels,
``rglru_scan.launches_tma`` those of the TMA one; the backward's counters
are ``rglru_scan_backward.launches`` and ``.launches_tma``.

When grad is enabled and an input requires grad, the call goes through
:class:`RGLRUScan`, a ``torch.autograd.Function`` that saves ``a``, ``h``
and ``h0`` and whose backward is :func:`rglru_scan_backward`: the reverse
scan ``g_t = dh_t + a_{t+1} g_{t+1}``, ``da_t = g_t h_{t-1}``, ``db_t =
g_t``, ``dh0 = a_0 g_0``, again a CUDA kernel on the card (routed the same
way) and :func:`rglru_scan_backward_plain` on the CPU. Grad is taken in
float32 only (the model's ``a`` and ``b`` are float32): a bfloat16 input
that requires grad raises ``RuntimeError``, since its stored ``h`` is not
the float32 state the backward needs.

Both launches are custom ops, ``torch.ops.repro_torch.rglru_scan`` and
``torch.ops.repro_torch.rglru_scan_backward``, whose bodies are
:func:`_launch` and :func:`_launch_backward`. Their fake forms give the
outputs' shapes and dtypes and launch nothing, so a trace under
``FakeTensorMode`` (the dry-run, ``repro_torch.launch.dryrun``) runs the
card's path on fake CUDA tensors; ``rglru_scan.fake_calls`` and
``rglru_scan_backward.fake_calls`` count those calls apart from the
launches.

Kernels and plain versions round each multiply and add on their own, in the
same order, so they agree to the last bit. (The JAX package's oracle,
``rglru_scan_ref``, is an associative scan; it agrees to ~1e-7 relative.)
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import KernelError

#: operand dtypes the kernel takes, and their codes in csrc/rglru_scan.cu.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the two kernels of each direction, as :func:`_route` names them.
TMA, DIRECT = "tma", "direct"


def _route(dtype, D: int, ptrs) -> str:
    """The kernel for operands of ``dtype`` with ``D`` features at the
    addresses ``ptrs``: :data:`TMA` when a row of D elements is a multiple
    of 16 bytes and every address is 16-byte aligned (TMA's row stride and
    base), else :data:`DIRECT`."""
    row_bytes = D * (4 if dtype == torch.float32 else 2)
    if row_bytes % 16 == 0 and all(p % 16 == 0 for p in ptrs):
        return TMA
    return DIRECT


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


def rglru_scan_backward_plain(a, h, h0, dh):
    """Plain torch version of the backward, float32: a loop over t from
    S - 1 down to 0 of ``g = dh_t + a_{t+1} * g`` (a separate multiply and
    add, g = 0 past the end), ``da_t = g * h_{t-1}`` (``h_{-1} = h0``) and
    ``db_t = g``. Returns (da, db, dh0 = a_0 * g_0)."""
    S = a.shape[1]
    da, db = torch.empty_like(a), torch.empty_like(a)
    g = torch.zeros_like(h0)
    a_next = torch.zeros_like(h0)
    for t in range(S - 1, -1, -1):
        g = a_next * g
        g = dh[:, t] + g
        da[:, t] = g * (h[:, t - 1] if t > 0 else h0)
        db[:, t] = g
        a_next = a[:, t]
    return da, db, a_next * g


_LIB = None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, setting its C
    signatures once; raises :class:`~repro_torch.kernels.KernelError` when
    ``nvcc`` is missing or the build fails."""
    global _LIB
    if _LIB is None:
        lib = _build.load("rglru_scan")
        lib.rglru_scan.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                   + [ctypes.c_void_p])
        lib.rglru_scan_tma.argtypes = lib.rglru_scan.argtypes
        lib.rglru_scan_backward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                                            + [ctypes.c_void_p])
        lib.rglru_scan_backward_tma.argtypes = lib.rglru_scan_backward.argtypes
        for fn in (lib.rglru_scan, lib.rglru_scan_tma, lib.rglru_scan_backward,
                   lib.rglru_scan_backward_tma):
            fn.restype = ctypes.c_int
        lib.rglru_error_string.argtypes = [ctypes.c_int]
        lib.rglru_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise KernelError(f"{what} kernel launch failed: "
                          f"{lib.rglru_error_string(err).decode()} (error {err})")


def _launch(a, b, h0, route=None) -> torch.Tensor:
    """Launch the forward kernel of ``route`` (by default the one
    :func:`_route` names) on checked operands (``h0`` float32); returns
    (B, S, D) in ``a``'s dtype."""
    lib = load()
    B, S, D = a.shape
    out = torch.empty_like(a)
    route = route or _route(a.dtype, D, (a.data_ptr(), b.data_ptr(), out.data_ptr()))
    args = (a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), B, S, D,
            DTYPES[a.dtype])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if route == TMA:
            err = lib.rglru_scan_tma(*args, stream)
        else:
            err = lib.rglru_scan(*args, stream)
    _check(lib, err, f"rglru_scan {route}")
    rglru_scan.launches += 1
    rglru_scan.launches_tma += route == TMA
    return out


def _launch_backward(a, h, h0, dh, route=None):
    """Launch the backward kernel of ``route`` (by default the one
    :func:`_route` names) on checked float32 operands; returns (da, db,
    dh0)."""
    lib = load()
    B, S, D = a.shape
    da, db, dh0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
    ptrs = (a.data_ptr(), h.data_ptr(), h0.data_ptr(), dh.data_ptr(), da.data_ptr(),
            db.data_ptr(), dh0.data_ptr())
    route = route or _route(a.dtype, D, ptrs[:2] + ptrs[3:6])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if route == TMA:
            err = lib.rglru_scan_backward_tma(*ptrs, B, S, D, stream)
        else:
            err = lib.rglru_scan_backward(*ptrs, B, S, D, stream)
    _check(lib, err, f"rglru_scan_backward {route}")
    rglru_scan_backward.launches += 1
    rglru_scan_backward.launches_tma += route == TMA
    return da, db, dh0


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=(),
                         schema="(Tensor a, Tensor b, Tensor h0) -> Tensor")
def _op(a, b, h0):
    """The forward kernel's launch as an op: :func:`_launch`."""
    return _launch(a, b, h0)


@_op.register_fake
def _op_fake(a, b, h0):
    """The forward on fake tensors: the output's shape and dtype, no launch."""
    rglru_scan.fake_calls += 1
    return torch.empty_like(a)


@torch.library.custom_op("repro_torch::rglru_scan_backward", mutates_args=(),
                         schema="(Tensor a, Tensor h, Tensor h0, Tensor dh) "
                                "-> (Tensor, Tensor, Tensor)")
def _op_backward(a, h, h0, dh):
    """The backward kernel's launch as an op: :func:`_launch_backward`."""
    return _launch_backward(a, h, h0, dh)


@_op_backward.register_fake
def _op_backward_fake(a, h, h0, dh):
    """The backward on fake tensors: (da, db, dh0)'s shapes and dtypes, no
    launch."""
    rglru_scan_backward.fake_calls += 1
    return torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)


def _check_kernel_operands(op: str, **operands) -> None:
    """Raise ``ValueError`` on what the kernels of ``op`` take on neither
    route: an operand that is not contiguous, or more than 65,535 batch
    rows (the first operand's first dimension)."""
    for name, t in operands.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the {op} kernels")
    B = next(iter(operands.values())).shape[0]
    if B > 65535:
        raise ValueError(f"the {op} kernels take B <= 65535, got {B}")


def rglru_scan_backward(a, h, h0, dh):
    """The backward of the recurrence: given ``a``, the output ``h`` and
    ``h0`` of a forward and the incoming ``dh``, returns (da, db, dh0).

    a, h, dh: (B, S, D) float32; h0: (B, D) float32; all on one device.
    CUDA tensors go through the kernel :func:`_route` names
    (``rglru_scan_backward.launches`` counts the launches) and must be
    contiguous; CPU tensors go through :func:`rglru_scan_backward_plain`.
    """
    B, S, D = a.shape
    for name, t, shape in (("h", h, a.shape), ("dh", dh, a.shape), ("h0", h0, (B, D))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the backward "
                             f"takes float32 on {a.device}, as a is")
    if a.dtype != torch.float32:
        raise ValueError(f"the backward takes float32 a, got {a.dtype}")
    if a.device.type == "cuda":
        _check_kernel_operands("rglru_scan_backward", a=a, h=h, h0=h0, dh=dh)
        return _op_backward(a, h, h0, dh)
    if a.device.type == "cpu":
        return rglru_scan_backward_plain(a, h, h0, dh)
    raise ValueError(f"rglru_scan_backward runs on cuda or cpu, not {a.device}")


class RGLRUScan(torch.autograd.Function):
    """The scan with its backward: the forward kernel (or, with
    ``on_card`` False, the plain version), saving ``a``, ``h`` and ``h0``;
    the backward is :func:`rglru_scan_backward`."""

    @staticmethod
    def forward(ctx, a, b, h0, on_card: bool):
        h = _op(a, b, h0) if on_card else rglru_scan_plain(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_scan_backward(a, h, h0, dh.contiguous())
        return da, db, dh0 if ctx.needs_input_grad[2] else None, None


def _scan(a, b, h0, on_card: bool):
    """The forward on checked operands (``h0`` float32): through
    :class:`RGLRUScan` when grad is enabled and an input requires grad,
    else the kernel (on the card) or the plain version."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                    or h0.requires_grad):
        if a.dtype != torch.float32:
            raise RuntimeError(
                f"rglru_scan takes grad in float32 only, got {a.dtype} inputs: "
                f"the backward needs the float32 state h, and the stored "
                f"{a.dtype} h is not it")
        return RGLRUScan.apply(a, b, h0, on_card)
    return _op(a, b, h0) if on_card else rglru_scan_plain(a, b, h0)


def rglru_scan(a, b, h0):
    """The recurrence ``h_t = a_t * h_{t-1} + b_t`` from ``h0``.

    a, b: (B, S, D), both float32 or both bfloat16; h0: (B, D), any float
    dtype (the state is float32). Returns (B, S, D) in ``a``'s dtype. All
    on one device. CUDA tensors go through the kernel :func:`_route` names
    (``rglru_scan.launches`` counts the launches) and must be contiguous;
    CPU tensors go through :func:`rglru_scan_plain`. Differentiable in
    float32 (see :class:`RGLRUScan`).
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
        _check_kernel_operands("rglru_scan", a=a, b=b)
        return _scan(a, b, h0.float().contiguous(), True)
    if dev.type == "cpu":
        return _scan(a, b, h0.float(), False)
    raise ValueError(f"rglru_scan runs on cuda or cpu, not {dev}")


#: launches of the forward CUDA kernels in this process (plain-version calls
#: excluded), and of the TMA one among them.
rglru_scan.launches = 0
rglru_scan.launches_tma = 0
#: launches of the backward CUDA kernels in this process, and of the TMA one.
rglru_scan_backward.launches = 0
rglru_scan_backward.launches_tma = 0
#: calls of the forward's and the backward's fake forms (a trace on fake
#: tensors; no launch)
rglru_scan.fake_calls = 0
rglru_scan_backward.fake_calls = 0
