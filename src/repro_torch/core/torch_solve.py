"""Batched water-filling solve tier for non-cooperative OEF, on the GPU.

The numpy greedy in :func:`repro_torch.core.oef.solve_noncoop_waterfill` is
exact but sequential: a Python loop over users per bisection probe. This
module runs the same exact water-filling on a torch device:

  - the per-tau feasibility check is the k-pass reduction of
    :func:`repro_torch.kernels.waterfill.waterfill_masses`: the hand-written
    CUDA kernel on the card, its plain torch version on the CPU;
  - the bisection is a fixed-iteration multisection: every step probes
    ``LANES`` equally spaced candidate taus at once (one kernel launch) and
    keeps the bracket between the last feasible and first infeasible lane,
    shrinking it by ``LANES+1`` per step. The trip count is fixed and the
    bracket stays on the device, so the loop never waits for the host: a
    cold solve is exactly ``ITERS`` launches, a warm-started one (a usable
    ``tau_hint``) exactly ``ITERS + 1``;
  - the allocation at the converged tau is one more greedy pass in plain
    torch ops (:func:`~repro_torch.kernels.waterfill.waterfill_allocate`);
  - scenario batches go through :func:`solve_noncoop_fast_batch`, the same
    core with a leading batch dimension.

Instances are padded to power-of-two user-count buckets (min ``MIN_PAD``),
the same buckets as the JAX tier; :func:`prewarm` builds the kernel and runs
every bucket once. Every tensor is float64, stated on each tensor: the
process-wide default dtype is never touched.

This tier only covers the (piecewise-)Monge staircase class of
``oef.classify_staircase``. Callers go through the backend registry
(``backends.dispatch("oef-noncoop", ..., backend="torch")``), which falls
back to the scipy LP for anything else; the standalone entry points here
raise ``ValueError`` instead so a silent wrong answer is impossible.

``device`` defaults to ``"cuda"``; asking for CUDA where torch sees no GPU
raises instead of running on the CPU. A failure on the card (a kernel that
does not build or launch, or a CUDA fault surfacing at the copy back to the
host) raises ``KernelError``, which the service's guardrails never absorb.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import KernelError
from ..kernels.waterfill import waterfill_allocate, waterfill_masses
from ..obs import trace as obs_trace
from .oef import classify_staircase

Array = np.ndarray

#: multisection lanes per step; bracket shrinks by LANES+1 each iteration.
LANES = 8
#: fixed trip count: 9**14 ~ 2e13 bracket reduction. The cold bracket starts
#: at the tight capacity bound sum_j m_j max_u w_uj / n (a true upper bound
#: on tau), so tau lands ~1e-11 absolute from the optimum — inside the 1e-9
#: parity budget with two decades of margin.
ITERS = 14
#: smallest padding bucket (power-of-two buckets above).
MIN_PAD = 8


def resolve_device(device=None) -> torch.device:
    """The torch device for a solve: ``"cuda"`` unless the caller says.

    Raises when CUDA is asked for and torch sees no GPU: the port never
    carries on on the CPU in place of the card.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but torch sees no CUDA device; "
            f"pass device='cpu' to run the plain version on the CPU")
    return dev


@contextlib.contextmanager
def _card_errors(dev: torch.device) -> Iterator[None]:
    """Raise a failure of work on the card as ``KernelError``.

    A CUDA fault is reported at the next synchronizing call, usually the
    copy back to the host, as a plain ``RuntimeError``; naming it
    ``KernelError`` keeps the solver dispatch from treating it as a solver
    crash that the LP may answer in its place.
    """
    try:
        yield
    except RuntimeError as e:
        if dev.type != "cuda" or isinstance(e, KernelError):
            raise
        raise KernelError(f"solve on {dev} failed: {e}") from e


def bucket(n: int) -> int:
    """Padded user count: next power of two >= n (min MIN_PAD)."""
    if n <= MIN_PAD:
        return MIN_PAD
    return 1 << (n - 1).bit_length()


def hint_usable(tau_hint: Optional[float], W: Array, m: Array) -> bool:
    """Does a solve probe ``tau_hint``? (Else it starts cold.)"""
    hi_cap = float(np.max(W) * np.sum(m)) + 1.0
    return tau_hint is not None and 0.0 < float(tau_hint) < hi_cap


def _feasible(taus, Wf, m, mask, n_active):
    mass = waterfill_masses(taus, Wf, m, mask)
    # The mass decays linearly in (tau - tau*) above the optimum; the
    # tolerance only needs to absorb the ~1e-13-relative cumsum noise, and
    # shifts the recovered tau by tol/n — far inside the 1e-9 parity budget.
    return mass <= 1e-12 * (1.0 + n_active[:, None] * taus)


def _solve_padded(Wf, m, mask, tau_hint, *, lanes: int, iters: int,
                  use_hint: bool):
    """Multisection + allocation recovery on padded, batched instances.

    Wf (B, n_pad, k) sorted fastest user first with padding rows masked
    out, m (B, k), mask (B, n_pad), tau_hint (B,); returns tau (B,) and X
    (B, n_pad, k) in the same (padded, reversed) row order. Runs entirely
    on the operands' device with no host sync.
    """
    n_active = mask.sum(dim=-1)
    # Tight bracket: n*tau <= sum_j m_j max_u w_uj (every device at most at
    # its best active user's speed).
    hi_cap = ((Wf * mask[:, :, None]).amax(dim=1) * m).sum(dim=-1) / n_active + 1.0
    lo = torch.zeros_like(hi_cap)
    hi = hi_cap
    if use_hint:
        # One probe decides which side of the hint the bracket keeps — the
        # fixed-trip multisection below stays correct for any hint quality.
        h = torch.minimum(torch.clamp_min(tau_hint, 0.0), hi_cap)
        ok = _feasible(h[:, None], Wf, m, mask, n_active)[:, 0]
        lo = torch.where(ok, h, lo)
        hi = torch.where(ok, hi, h)
    frac = torch.arange(1, lanes + 1, dtype=torch.float64,
                        device=Wf.device) / (lanes + 1.0)
    for _ in range(iters):
        taus = lo[:, None] + (hi - lo)[:, None] * frac
        feas = _feasible(taus, Wf, m, mask, n_active)
        i = feas.sum(dim=-1)  # feasibility is monotone: lanes form a true-prefix
        at_lo = taus.gather(1, (i - 1).clamp_min(0)[:, None])[:, 0]
        at_hi = taus.gather(1, i.clamp_max(lanes - 1)[:, None])[:, 0]
        lo, hi = torch.where(i > 0, at_lo, lo), torch.where(i < lanes, at_hi, hi)
    return lo, waterfill_allocate(lo, Wf, m, mask)


def _pad_sorted(Ws: Array, k: int) -> Tuple[Array, Array]:
    """Pad a slowest-first sorted matrix to its bucket; fastest user first."""
    n = Ws.shape[0]
    n_pad = bucket(n)
    Wf = np.ones((n_pad, k), dtype=np.float64)
    Wf[:n] = Ws[::-1]  # fastest user first, as the greedy consumes the tape
    mask = np.zeros(n_pad, dtype=np.float64)
    mask[:n] = 1.0
    return Wf, mask


def _prepare(
    W: Array, m: Array, presorted: Optional[Tuple[Array, Array]] = None
) -> Tuple[Array, Array, Array, Array]:
    """Validate + sort + pad one instance; returns (order, Wf, m64, mask).

    ``presorted`` is the (order, Ws) pair a caller that already classified
    the instance (``oef.solve_noncoop_waterfill_torch``) passes down so the
    argsort and class checks are not repeated on the hot path.
    """
    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    if W.ndim != 2 or W.shape[0] < 1:
        raise ValueError(f"need a (n>=1, k) speedup matrix, got {W.shape}")
    if presorted is not None:
        order, Ws = presorted
    else:
        cls = classify_staircase(W)
        if cls is None:
            raise ValueError(
                "instance is neither consistently ordered (Monge) nor "
                "piecewise-Monge; the closed-form water-filling does not "
                "apply — solve via the LP instead (the oef-noncoop backend "
                "chain handles this fallback automatically)")
        _, order, Ws = cls
    Wf, mask = _pad_sorted(Ws, W.shape[1])
    return order, Wf, m, mask


def _to_device(dev: torch.device, *arrays: Array) -> List[torch.Tensor]:
    """Move float64 arrays to ``dev`` in one host-to-device copy."""
    flat = np.concatenate([np.ascontiguousarray(a, dtype=np.float64).ravel()
                           for a in arrays])
    buf = torch.from_numpy(flat).to(dev)
    out, at = [], 0
    for a in arrays:
        out.append(buf[at:at + a.size].view(a.shape))
        at += a.size
    return out


def _to_host(tau: torch.Tensor, Xf: torch.Tensor) -> Tuple[Array, Array]:
    """Copy (tau (B,), X (B, n, k)) back in one device-to-host copy."""
    B = tau.shape[0]
    flat = torch.cat([tau[:, None], Xf.reshape(B, -1)], dim=1).cpu().numpy()
    return flat[:, 0], flat[:, 1:].reshape(Xf.shape)


def solve_noncoop_fast_torch(
    W: Array,
    m: Array,
    *,
    tau_hint: Optional[float] = None,
    lanes: int = LANES,
    iters: int = ITERS,
    device=None,
    _presorted: Optional[Tuple[Array, Array]] = None,
) -> Tuple[float, Array]:
    """Exact water-filling solve of one instance on ``device``.

    Returns ``(tau, X)`` in the original row order. Raises ``ValueError``
    for instances outside the consistently-ordered class (callers that want
    the automatic LP fallback go through ``backends.dispatch``).
    """
    dev = resolve_device(device)
    with obs_trace.span("prepare", "torch", tier="noncoop"):
        order, Wf, m, mask = _prepare(W, m, _presorted)
    n, k = np.asarray(W).shape
    use_hint = hint_usable(tau_hint, W, m)
    hint = np.array([float(tau_hint) if use_hint else -1.0])
    with obs_trace.span("execute", "torch", tier="noncoop", bucket=Wf.shape[0]), \
            _card_errors(dev):
        Wf_d, m_d, mask_d, hint_d = _to_device(dev, Wf[None], m[None],
                                               mask[None], hint)
        tau, Xf = _to_host(*_solve_padded(Wf_d, m_d, mask_d, hint_d,
                                          lanes=lanes, iters=iters,
                                          use_hint=use_hint))
    X = np.zeros((n, k), dtype=np.float64)
    X[order] = Xf[0, :n][::-1]
    return float(tau[0]), X


def solve_noncoop_fast_batch(
    Ws: Array, ms: Array, *, lanes: int = LANES, iters: int = ITERS, device=None
) -> Tuple[Array, Array]:
    """Batched solve of (B, n, k) instances sharing a user count.

    ``ms`` is (B, k) or a single (k,) capacity broadcast to the batch.
    Every instance must be consistently ordered (ValueError otherwise).
    Returns ``(taus (B,), Xs (B, n, k))`` in each instance's original row
    order; the whole batch shares each of the ``iters`` kernel launches.
    """
    dev = resolve_device(device)
    Ws = np.asarray(Ws, dtype=np.float64)
    if Ws.ndim != 3:
        raise ValueError(f"need (B, n, k) stacked instances, got {Ws.shape}")
    B, n, k = Ws.shape
    ms = np.asarray(ms, dtype=np.float64)
    if ms.ndim == 1:
        ms = np.broadcast_to(ms, (B, k))
    orders = []
    Wfs = np.ones((B, bucket(n), k), dtype=np.float64)
    masks = np.zeros((B, bucket(n)), dtype=np.float64)
    for b in range(B):
        order, Wf, _, mask = _prepare(Ws[b], ms[b])
        orders.append(order)
        Wfs[b], masks[b] = Wf, mask
    with _card_errors(dev):
        Wf_d, m_d, mask_d, hint_d = _to_device(dev, Wfs, ms, masks,
                                               np.full(B, -1.0))
        taus, Xfs = _to_host(*_solve_padded(Wf_d, m_d, mask_d, hint_d, lanes=lanes,
                                            iters=iters, use_hint=False))
    Xs = np.zeros((B, n, k), dtype=np.float64)
    for b, order in enumerate(orders):
        Xs[b][order] = Xfs[b, :n][::-1]
    return taus, Xs


def prewarm(n_max: int, k: int, *, lanes: int = LANES, iters: int = ITERS,
            device=None) -> List[int]:
    """Build the kernel and run each padded bucket up to ``bucket(n_max)``.

    The first launch builds the CUDA kernel with ``nvcc``; running every
    bucket once, cold and warm-started, also warms torch's allocator, so
    neither lands inside a measured re-solve. Returns the bucket sizes.
    """
    dev = resolve_device(device)
    sizes = []
    s = MIN_PAD
    while s < bucket(n_max):
        sizes.append(s)
        s *= 2
    sizes.append(bucket(n_max))
    with obs_trace.span("prewarm", "torch", tier="noncoop", buckets=len(sizes)), \
            _card_errors(dev):
        for n_pad in sizes:
            Wf, m, mask = _to_device(dev, np.ones((1, n_pad, k)),
                                     np.full((1, k), 2.0), np.ones((1, n_pad)))
            for use_hint in (False, True):
                tau, _ = _solve_padded(
                    Wf, m, mask, torch.full((1,), 0.5, dtype=torch.float64,
                                            device=dev),
                    lanes=lanes, iters=iters, use_hint=use_hint)
                tau.cpu()
    return sizes
