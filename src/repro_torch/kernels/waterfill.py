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

:func:`waterfill_solve` is the whole solve around the feasibility mass (the
bracket, the optional hint probe, the fixed-trip multisection and the
allocation pass) as one launch of the fused kernel ``waterfill_solve_kernel``
of the same source; on a CPU tensor it runs :func:`waterfill_solve_plain`,
the solve as torch ops with one :func:`waterfill_masses` call per probe.
The route of a solve (:func:`fused_solve`) goes by device and shape: a CUDA
solve of at most ``MAX_LANES`` lanes is one launch of the fused kernel; more
lanes run :func:`waterfill_solve_plain` on the card, one ``waterfill_masses``
launch per probe (the fused kernel carries its lanes in registers); a CPU
solve runs :func:`waterfill_solve_plain` on the plain masses.
On the card the fused kernel finds the tau that :func:`waterfill_solve_plain`
finds there, bit for bit (its probes' masses are the masses kernel's, and it
forms the taus and the bracket in the same order); X differs by the order
of torch's cumsum, ~1e-13 relative. A fused launch that fails raises
``KernelError``; nothing falls back to the unfused path.
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
#: most candidate taus a multisection step of the fused solve probes
#: (``kLanes`` of csrc/waterfill.cu).
MAX_LANES = 8
#: largest n_pad whose users the fused solve holds one per thread, with
#: their remaining needs in shared memory (``kMaxThreads``); larger n_pad
#: go through a (B, n_pad, MAX_LANES) scratch buffer.
MAX_THREADS = 1024


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
        lib.waterfill_solve.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
        lib.waterfill_solve.restype = ctypes.c_int
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


# ---------------------------------------------------------------------------
# the whole solve
# ---------------------------------------------------------------------------


def _feasible(masses_fn, taus, Wf, m, mask, n_active):
    mass = masses_fn(taus, Wf, m, mask)
    # The mass decays linearly in (tau - tau*) above the optimum; the
    # tolerance only needs to absorb the ~1e-13-relative cumsum noise, and
    # shifts the recovered tau by tol/n — far inside the 1e-9 parity budget.
    return mass <= 1e-12 * (1.0 + n_active[:, None] * taus)


def waterfill_solve_plain(Wf, m, mask, tau_hint, *, lanes: int, iters: int,
                          use_hint: bool, masses_fn=None):
    """Multisection + allocation recovery on padded, batched instances.

    Wf (B, n_pad, k) sorted fastest user first with padding rows masked
    out, m (B, k), mask (B, n_pad), tau_hint (B,); returns tau (B,) and X
    (B, n_pad, k) in the same (padded, reversed) row order. Runs entirely
    on the operands' device with no host sync. ``masses_fn`` is the probe
    (default :func:`waterfill_masses`), as the JAX tier's solve takes its
    ``masses_fn``.
    """
    masses_fn = waterfill_masses if masses_fn is None else masses_fn
    n_active = mask.sum(dim=-1)
    # Tight bracket: n*tau <= sum_j m_j max_u w_uj (every device at most at
    # its best active user's speed); the sum runs over j in order, as the
    # fused kernel forms it.
    top = (Wf * mask[:, :, None]).amax(dim=1)
    cap = top[:, 0] * m[:, 0]
    for j in range(1, Wf.shape[-1]):
        cap = cap + top[:, j] * m[:, j]
    hi_cap = cap / n_active + 1.0
    lo = torch.zeros_like(hi_cap)
    hi = hi_cap
    if use_hint:
        # One probe decides which side of the hint the bracket keeps — the
        # fixed-trip multisection below stays correct for any hint quality.
        h = torch.minimum(torch.clamp_min(tau_hint, 0.0), hi_cap)
        ok = _feasible(masses_fn, h[:, None], Wf, m, mask, n_active)[:, 0]
        lo = torch.where(ok, h, lo)
        hi = torch.where(ok, hi, h)
    # (t + 1) times the step, as the kernel forms it: torch on the card
    # divides by a scalar that way, on the CPU it divides
    frac = torch.arange(1, lanes + 1, dtype=torch.float64,
                        device=Wf.device) * (1.0 / (lanes + 1.0))
    for _ in range(iters):
        taus = lo[:, None] + (hi - lo)[:, None] * frac
        feas = _feasible(masses_fn, taus, Wf, m, mask, n_active)
        i = feas.sum(dim=-1)  # feasibility is monotone: lanes form a true-prefix
        at_lo = taus.gather(1, (i - 1).clamp_min(0)[:, None])[:, 0]
        at_hi = taus.gather(1, i.clamp_max(lanes - 1)[:, None])[:, 0]
        lo, hi = torch.where(i > 0, at_lo, lo), torch.where(i < lanes, at_hi, hi)
    return lo, waterfill_allocate(lo, Wf, m, mask)


def fused_solve(device, lanes: int) -> bool:
    """The solve's route: True where it is one launch of the fused kernel
    (:func:`waterfill_solve`), a CUDA solve of ``lanes <= MAX_LANES``. Else
    :func:`waterfill_solve_plain` runs it: on the card one
    ``waterfill_masses`` launch per probe, on the CPU the plain masses."""
    return torch.device(device).type == "cuda" and lanes <= MAX_LANES


def _launch_solve(Wf, m, mask, tau_hint, lanes: int, iters: int, use_hint: bool):
    """Launch the fused kernel on checked operands; returns (tau, X)."""
    _build.refuse_grad("waterfill_solve", Wf=Wf, m=m, mask=mask, tau_hint=tau_hint)
    lib = load()
    B, n_pad, k = Wf.shape
    tau = torch.empty((B,), dtype=torch.float64, device=Wf.device)
    X = torch.empty_like(Wf)
    r_buf = torch.empty((B, n_pad, MAX_LANES) if n_pad > MAX_THREADS else (0,),
                        dtype=torch.float64, device=Wf.device)
    with torch.cuda.device(Wf.device):
        stream = torch.cuda.current_stream(Wf.device).cuda_stream
        err = lib.waterfill_solve(Wf.data_ptr(), m.data_ptr(), mask.data_ptr(),
                                  tau_hint.data_ptr(), r_buf.data_ptr(), tau.data_ptr(),
                                  X.data_ptr(), B, n_pad, k, lanes, iters,
                                  int(bool(use_hint)), stream)
    if err != 0:
        raise KernelError(
            f"waterfill_solve kernel launch failed: "
            f"{lib.waterfill_error_string(err).decode()} (cuda error {err})")
    waterfill_solve.launches += 1
    return tau, X


def waterfill_solve(Wf, m, mask, tau_hint, *, lanes: int, iters: int,
                    use_hint: bool):
    """The solve of :func:`waterfill_solve_plain` as one fused launch.

    Wf (B, n_pad, k), m (B, k), mask (B, n_pad), tau_hint (B,): float64,
    contiguous, on one device, with ``1 <= lanes <= MAX_LANES`` (any k).
    Returns tau (B,) and X (B, n_pad, k). CUDA tensors go through the
    fused kernel (``waterfill_solve.launches`` counts its launches; a failed
    build or launch raises ``KernelError``); CPU tensors go through
    :func:`waterfill_solve_plain`.
    """
    if Wf.dim() != 3:
        raise ValueError(f"Wf must be (B, n_pad, k), got {tuple(Wf.shape)}")
    B, n_pad, k = Wf.shape
    ops = {"Wf": Wf, "m": m, "mask": mask, "tau_hint": tau_hint}
    shapes = {"Wf": (B, n_pad, k), "m": (B, k), "mask": (B, n_pad), "tau_hint": (B,)}
    for name, t in ops.items():
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; with Wf "
                             f"{tuple(Wf.shape)} it must be {shapes[name]}")
        if t.device != Wf.device:
            raise ValueError(f"{name} is on {t.device}, Wf on {Wf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (B >= 1 and n_pad >= 1 and k >= 1):
        raise ValueError(f"the fused solve takes B, n_pad, k >= 1, got {tuple(Wf.shape)}")
    if not 1 <= lanes <= MAX_LANES or iters < 0:
        raise ValueError(f"the fused solve takes 1 <= lanes <= {MAX_LANES} and "
                         f"iters >= 0, got lanes={lanes}, iters={iters}")
    if Wf.device.type == "cuda":
        return _launch_solve(Wf, m, mask, tau_hint, lanes, iters, use_hint)
    if Wf.device.type == "cpu":
        return waterfill_solve_plain(Wf, m, mask, tau_hint, lanes=lanes, iters=iters,
                                     use_hint=use_hint)
    raise ValueError(f"waterfill_solve runs on cuda or cpu, not {Wf.device}")


#: launches of the fused kernel in this process (plain-version calls excluded).
waterfill_solve.launches = 0
