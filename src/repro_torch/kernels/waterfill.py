"""Water-filling feasibility reduction: the CUDA kernel and its plain version.

The exact non-cooperative OEF solver finds the common throughput level tau*
by bisection on a greedy feasibility check. The greedy consumes the capacity
"tape" (device types fastest->slowest, users fastest->slowest) strictly in
order, which makes the per-tau check expressible as k vectorized passes:
processing types fastest-first, the devices a user can still take from type
j is

    take[u, j] = clip(m_j - cumsum_excl_u(r / w_j), 0, r_u / w_{u,j})

where ``r`` is the per-user remaining throughput need (initially tau) and the
exclusive cumsum runs over users sorted fastest-first. After the k passes the
*feasibility mass* ``sum_u r_u`` is ~0 iff tau is achievable.

:func:`waterfill_masses` evaluates a tile of candidate taus per call. On a
CUDA tensor it launches the hand-written kernel of ``csrc/waterfill.cu``
(built with ``nvcc`` on first use, see :mod:`repro_torch.kernels._build`);
on a CPU tensor it runs :func:`waterfill_masses_plain`, the same arithmetic
in plain torch ops with the op order of the JAX package's reference. There
is no other route: a CUDA tensor never falls back to the plain version.

:func:`waterfill_allocate` recovers the allocation at the converged tau with
one more greedy pass in plain torch ops, on whichever device its inputs lie.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from ._build import KernelError

# Guard against division blow-up for degenerate speedups, same constant as
# the numpy greedy in core/oef.py.
_W_FLOOR = 1e-300


def _batched(taus, Wf, m, mask) -> Tuple[bool, torch.Tensor, torch.Tensor,
                                           torch.Tensor, torch.Tensor]:
    """Check shapes and lift one instance to a batch of one.

    Accepts taus (T,), Wf (n, k), m (k,), mask (n,) or the same with a
    leading batch dimension B on every operand.
    """
    single = Wf.dim() == 2
    if single:
        taus, Wf, m, mask = taus[None], Wf[None], m[None], mask[None]
    if Wf.dim() != 3:
        raise ValueError(f"Wf must be (n, k) or (B, n, k), got {tuple(Wf.shape)}")
    B, n, k = Wf.shape
    for name, t, shape in (("taus", taus, (B, taus.shape[-1])),
                           ("m", m, (B, k)), ("mask", mask, (B, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; with Wf "
                             f"{tuple(Wf.shape)} it must be {shape}")
    return single, taus, Wf, m, mask


def waterfill_masses_plain(taus, Wf, m, mask):
    """Plain torch version: k passes of ``torch.cumsum`` over users.

    Batched operands (see :func:`_batched`); returns (B, T). Same math and
    op order as ``waterfill_masses_ref`` of the JAX package.
    """
    k = Wf.shape[-1]
    r = taus[:, :, None] * mask[:, None, :]
    for j in range(k - 1, -1, -1):
        w = torch.clamp_min(Wf[:, :, j], _W_FLOOR)[:, None, :]
        dev = r / w
        cum_excl = torch.cumsum(dev, dim=-1) - dev
        take = torch.minimum(torch.clamp_min(m[:, j, None, None] - cum_excl, 0.0), dev)
        r = r - take * w
    return r.sum(dim=-1)


_LIB = None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library, setting its C
    signatures once; raises :class:`~repro_torch.kernels.KernelError` when
    ``nvcc`` is missing or the build fails."""
    global _LIB
    if _LIB is None:
        lib = _build.load("waterfill")
        lib.waterfill_masses.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                         + [ctypes.c_void_p])
        lib.waterfill_masses.restype = ctypes.c_int
        lib.waterfill_error_string.argtypes = [ctypes.c_int]
        lib.waterfill_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(taus, Wf, m, mask) -> torch.Tensor:
    """Launch the CUDA kernel on batched, checked operands; returns (B, T)."""
    lib = load()
    B, T = taus.shape
    n, k = Wf.shape[1:]
    mass = torch.empty((B, T), dtype=torch.float64, device=taus.device)
    r_buf = torch.empty((B, T, n), dtype=torch.float64, device=taus.device)
    with torch.cuda.device(taus.device):
        stream = torch.cuda.current_stream(taus.device).cuda_stream
        err = lib.waterfill_masses(taus.data_ptr(), Wf.data_ptr(), m.data_ptr(),
                                   mask.data_ptr(), r_buf.data_ptr(),
                                   mass.data_ptr(), B, T, n, k, stream)
    if err != 0:
        raise KernelError(
            f"waterfill_masses kernel launch failed: "
            f"{lib.waterfill_error_string(err).decode()} (cuda error {err})")
    waterfill_masses.launches += 1
    return mass


def waterfill_masses(taus, Wf, m, mask):
    """Leftover feasibility mass per candidate tau.

    taus: (T,) candidate equal-throughput levels;
    Wf:   (n, k) speedup rows sorted FASTEST USER FIRST;
    m:    (k,) per-type capacity, types ascending slow->fast;
    mask: (n,) 1.0 for real users, 0.0 for padding rows;
    or the same with a leading batch dimension B on every operand.

    Returns (T,) (or (B, T)) ``sum_u r_u`` after the k greedy passes; ~0 =>
    tau feasible. All operands are float64 on one device. CUDA tensors go
    through the kernel (``waterfill_masses.launches`` counts its launches)
    and a failed build or launch raises ``KernelError``; CPU tensors go
    through :func:`waterfill_masses_plain`.
    """
    single, taus, Wf, m, mask = _batched(taus, Wf, m, mask)
    ops = (taus, Wf, m, mask)
    dev = taus.device
    for name, t in zip(("taus", "Wf", "m", "mask"), ops):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, taus on {dev}")
    if dev.type == "cuda":
        for name, t in zip(("taus", "Wf", "m", "mask"), ops):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous for the kernel")
        mass = _launch(*ops)
    elif dev.type == "cpu":
        mass = waterfill_masses_plain(*ops)
    else:
        raise ValueError(f"waterfill_masses runs on cuda or cpu, not {dev}")
    return mass[0] if single else mass


#: launches of the CUDA kernel in this process (plain-version calls excluded).
waterfill_masses.launches = 0


def waterfill_allocate(tau, Wf, m, mask):
    """Materialize the staircase allocation X at throughput ``tau``.

    One extra greedy pass at the converged tau, emitting the per-type takes
    instead of only the leftover mass. ``tau`` is a scalar (with Wf (n, k),
    m (k,), mask (n,)) or (B,) with batched operands; returns (n, k) or
    (B, n, k). Row order matches ``Wf`` (fastest user first); padded rows
    receive zero.
    """
    k = Wf.shape[-1]
    r = tau[..., None] * mask
    cols = [None] * k
    for j in range(k - 1, -1, -1):
        w = torch.clamp_min(Wf[..., j], _W_FLOOR)
        dev = r / w
        cum_excl = torch.cumsum(dev, dim=-1) - dev
        take = torch.minimum(torch.clamp_min(m[..., j, None] - cum_excl, 0.0), dev)
        cols[j] = take
        r = r - take * w
    return torch.stack(cols, dim=-1)
