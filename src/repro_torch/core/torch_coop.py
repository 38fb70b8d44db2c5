"""Primal–dual solve tier for cooperative OEF, on the GPU.

The cooperative program (Eq. 10) is an LP with n(n-1) envy-freeness rows —
scipy-HiGHS stops scaling around 16 tenants. This module solves the same LP
with a first-order method whose iterations run on a torch device:

  - **exact row deduplication** first: tenants sharing a speedup profile are
    one *group* (the online service draws tenants from a small job-type
    catalog, so n=256 tenants collapse to a handful of groups). A symmetric
    optimum — identical bundles within a group — always exists because the
    program is invariant under permuting identical rows, so the reduced
    instance over (distinct rows, counts) is equivalent and the envy
    constraints shrink from n(n-1) to g(g-1);
  - **preconditioned PDHG** (Chambolle–Pock with Pock–Chambolle diagonal
    scaling) on the reduced LP, with the pairwise envy-gap matrix computed
    once per step. Each segment runs a fixed trip count of ``SEG_ITERS``
    steps on the device with no host sync and *restarts to the running
    average* (the PDLP acceleration). The route of a segment goes by device
    and group bucket (:func:`repro_torch.kernels.envy.fused_segment`): on
    the card a segment with ``G <= PD_FUSED_MAX_G`` (64) is **one** launch
    of the hand-written fused kernel (:func:`repro_torch.kernels.envy.
    pd_segment`); a larger G runs the steps as torch ops with one launch of
    the envy-gap kernel (:func:`repro_torch.kernels.envy.envy_gaps`) per
    step; on the CPU the steps run as torch ops on the gaps' plain version;
  - **certified active-set crossover** between segments, on the host: the
    averaged iterate is copied back once, the primal support and dual tight
    set are read off it, both sides are polished by least squares, small
    dual infeasibility is repaired by an exact capacity-price shift, and the
    candidate is accepted only under the resulting weak-duality certificate
    — primal feasible, dual feasible, ``gap <= tol``. When the segment map
    reproduces its own state, or a small instance (``g <= RESCUE_MAX_G``)
    has used its PD budget, the *reduced* LP is solved exactly instead;
  - **automatic LP fallback**: an instance that does not certify within the
    iteration budget raises :class:`~repro_torch.core.backends.BackendError`
    and the backend registry falls through to the scipy LP.

Instances are padded to power-of-two group buckets (``torch_solve.bucket``,
the JAX tier's buckets; :func:`prewarm` builds the kernel and runs each
bucket once), and re-solves warm-start from the previous solve's certified
reduced primal/dual state carried in ``meta["pd_state"]``. Every tensor is
float64, stated on each tensor.

``device`` defaults to ``"cuda"``; asking for CUDA where torch sees no GPU
raises. A failure on the card raises ``KernelError``, which the service's
guardrails never absorb. This module registers itself as the ``"torch"``
backend of ``oef-coop`` (LP fallback) when imported, which
``repro_torch.core`` does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.envy import envy_gaps, fused_segment, pd_segment, pd_segment_plain
from ..obs import trace as obs_trace
from . import backends
from .lp import solve_lp
from .properties import audited_solver
from .torch_solve import _card_errors, _to_device, bucket, resolve_device
from .types import Allocation, default_rows, validate_speedup_matrix

Array = np.ndarray

#: iterations per segment (one restart-to-average per segment).
SEG_ITERS = 250
#: default total iteration budget before the LP fallback fires.
MAX_ITERS = 20_000
#: certificate tolerance, relative to the objective scale.
DEFAULT_TOL = 1e-7
#: largest group count for which the reduced-LP rescue is cheaper than the
#: full-LP fallback by construction (g(g-1) envy rows stay tiny).
RESCUE_MAX_G = 16
#: PD iterations granted to a rescue-eligible instance before crossing over
#: to the reduced LP: grinding segments past this point costs more wall time
#: than the tiny exact solve, so it caps the re-solve tail latency.
RESCUE_AFTER_ITERS = SEG_ITERS
_W_FLOOR = 1e-300


# ---------------------------------------------------------------------------
# PD segment on the device
# ---------------------------------------------------------------------------


def _pd_segment(Wp, cnt, m, pairm, tau, sig_env, sig_cap, x, p, L, *,
                seg: int = SEG_ITERS):
    """``seg`` preconditioned PDHG iterations + restart to the running average
    (operands and result as :func:`~repro_torch.kernels.envy.pd_segment_plain`
    takes and returns them), routed by :func:`~repro_torch.kernels.envy.
    fused_segment`: one launch of the fused kernel for a CUDA segment with
    ``G <= PD_FUSED_MAX_G``, else the stepwise loop, whose gaps come from
    this module's ``envy_gaps``."""
    ops = (Wp, cnt, m, pairm, tau, sig_env, sig_cap, x, p, L)
    if fused_segment(Wp.device, Wp.shape[1]):
        return pd_segment(*ops, seg=seg)
    return pd_segment_plain(*ops, seg=seg, envy_fn=envy_gaps)


def _to_host(x: torch.Tensor, p: torch.Tensor,
             L: torch.Tensor) -> Tuple[Array, Array, Array]:
    """Copy the batched state ``(x, p, L)`` back in one device-to-host copy."""
    B = x.shape[0]
    flat = torch.cat([x.reshape(B, -1), p.reshape(B, -1), L.reshape(B, -1)],
                     dim=1).cpu().numpy()
    a, b = x[0].numel(), x[0].numel() + p[0].numel()
    return (flat[:, :a].reshape(x.shape), flat[:, a:b].reshape(p.shape),
            flat[:, b:].reshape(L.shape))


# ---------------------------------------------------------------------------
# certified active-set crossover (host side, between segments)
# ---------------------------------------------------------------------------


def _dual_columns(W: Array, cnt: Array, sup_l: Array, sup_j: Array,
                  cap_idx: Array, pair_l: Array, pair_i: Array) -> Array:
    """Constraint-matrix block ``A[rows][:, sup].T`` without materializing A.

    Rows are (selected capacity rows) + (selected envy pairs); columns are
    the primal support entries ``(sup_l, sup_j)``. Used both transposed (the
    dual stationarity system) and untransposed (the primal tightening
    system), so the full ``(g*k + g(g-1)) x g*k`` matrix never exists.
    """
    cap_cols = cnt[sup_l][:, None] * (sup_j[:, None] == cap_idx[None, :])
    sign = ((sup_l[:, None] == pair_i[None, :]).astype(np.float64)
            - (sup_l[:, None] == pair_l[None, :]))
    pair_cols = W[pair_l][:, sup_j].T * sign
    return np.concatenate([cap_cols, pair_cols], axis=1)  # (n_sup, n_rows)


def _polish_once(W: Array, cnt: Array, m: Array, c: Array, xf: Array,
                 sup: Array, cap_idx: Array, pl: Array, pi: Array,
                 scale: float, feas_tol: float,
                 tol: float) -> Optional[Tuple[Array, float, float]]:
    """One active-set polish attempt from a (support, pinned-rows) guess."""
    g, k = W.shape
    sup_l, sup_j = np.divmod(np.where(sup)[0], k)
    cap_idx = np.asarray(cap_idx, dtype=np.intp)
    pl = np.asarray(pl, dtype=np.intp)
    pi = np.asarray(pi, dtype=np.intp)

    # -- primal: least squares against the pinned rows; an inconsistent pin
    # set (degenerate vertices over-determine the support) sheds its
    # worst-fit row and retries --
    x_sup = None
    for _ in range(12):
        if cap_idx.size + pl.size == 0:
            return None
        A_sup = _dual_columns(W, cnt, sup_l, sup_j, cap_idx, pl, pi).T
        b_act = np.concatenate([m[cap_idx], np.zeros(pl.size)])
        d, *_ = np.linalg.lstsq(A_sup, b_act - A_sup @ xf[sup], rcond=None)
        cand = xf[sup] + d
        resid = A_sup @ cand - b_act
        if resid.size == 0 or np.abs(resid).max() <= feas_tol:
            x_sup = cand
            break
        worst = int(np.abs(resid).argmax())
        if worst < cap_idx.size:
            cap_idx = np.delete(cap_idx, worst)
        else:
            worst -= cap_idx.size
            pl = np.delete(pl, worst)
            pi = np.delete(pi, worst)
    if x_sup is None:
        return None
    xpol = np.zeros_like(xf)
    xpol[sup] = x_sup
    if xpol.min(initial=0.0) < -feas_tol:
        return None
    xpol = np.maximum(xpol, 0.0).reshape(g, k)
    own = np.einsum("lk,lk->l", W, xpol)
    E = W @ xpol.T - own[:, None]
    np.fill_diagonal(E, 0.0)
    cap_slack = m - (cnt[:, None] * xpol).sum(axis=0)
    if E.max(initial=0.0) > feas_tol or cap_slack.min(initial=0.0) < -feas_tol:
        return None
    lb = float((c * xpol).sum())

    # -- dual: support = rows tight at the polished primal, then prune the
    # lstsq negatives (bounded active-set loop) --
    cap_t = np.where(cap_slack <= 1e-7 * scale)[0]
    tl, ti = np.where((E >= -1e-7 * scale) & ~np.eye(g, dtype=bool))
    for _ in range(12):
        if cap_t.size + tl.size == 0:
            return None
        M = _dual_columns(W, cnt, sup_l, sup_j, cap_t, tl, ti)
        y, *_ = np.linalg.lstsq(M, c.ravel()[sup], rcond=None)
        neg = y < -feas_tol
        if not neg.any():
            break
        keep = ~neg
        nc = cap_t.size
        cap_t = cap_t[keep[:nc]]
        tl, ti = tl[keep[nc:]], ti[keep[nc:]]
    else:
        return None
    y = np.maximum(y, 0.0)
    p_y = np.zeros(k)
    p_y[cap_t] = y[:cap_t.size]
    L_y = np.zeros((g, g))
    L_y[tl, ti] = y[cap_t.size:]
    AtY = (cnt[:, None] * p_y[None, :] + L_y.T @ W
           - L_y.sum(axis=1)[:, None] * W)
    # exact dual repair: every column has capacity coefficient cnt_l >= 1, so
    # shifting the capacity prices up closes any remaining infeasibility
    delta = np.maximum((c - AtY) / np.maximum(cnt[:, None], 1.0), 0.0).max(axis=0)
    ub = float(m @ (p_y + delta))
    if ub - lb > tol * scale:
        return None
    return xpol, lb, ub, p_y + delta, L_y


def _certified_polish(
    W: Array, cnt: Array, m: Array, x: Array, p: Array, L: Array, tol: float,
) -> Optional[Tuple[Array, float, float, Array, Array]]:
    """Active-set polish of the reduced iterate; certified or ``None``.

    Returns ``(x_opt (g, k), lower_bound, upper_bound, p_dual, L_dual)``
    when a polished primal is feasible, the repaired dual
    ``(p_dual, L_dual)`` is feasible, and the weak-duality gap is below
    ``tol`` (relative); ``None`` keeps the PD loop running. The certified
    pair is what warm starts should carry — it sits on the exact saddle,
    where a drifted re-solve's polish re-certifies without any PD segment.

    The active set is guessed two ways — from the PD dual magnitudes and
    from the constraints tight at the iterate itself — and the primal
    support at two thresholds; degenerate instances routinely stall the PD
    iterate at a point where exactly one of those guesses polishes clean.
    """
    g, k = W.shape
    c = cnt[:, None] * W
    xf = x.ravel()
    scale = max(abs(float((c * x).sum())), 1.0)
    feas_tol = 1e-9 * scale
    xmax = max(float(xf.max(initial=0.0)), 1e-12)

    sup_cands: List[Array] = []
    for thr in (1e-6, 1e-9):
        sup = xf > thr * xmax
        if sup.any() and not any(np.array_equal(sup, s) for s in sup_cands):
            sup_cands.append(sup)

    own = np.einsum("lk,lk->l", W, x)
    E_it = W @ x.T - own[:, None]
    np.fill_diagonal(E_it, -np.inf)
    cap_slack_it = m - (cnt[:, None] * x).sum(axis=0)
    # iterate-tight rows first: near convergence they are the reliable (and
    # cheap) guess; the PD dual magnitudes are the better signal mid-run
    row_cands = [
        (np.where(cap_slack_it <= 1e-6 * max(float(m.max()), 1.0))[0],
         *np.where(E_it >= -1e-6 * scale)),
        (np.where(p > 1e-6 * max(float(p.max(initial=0.0)), 1e-12))[0],
         *np.where(L > 1e-6 * max(float(L.max(initial=0.0)), 1e-12))),
    ]

    for sup in sup_cands:
        for cap_idx, pl, pi in row_cands:
            got = _polish_once(W, cnt, m, c, xf, sup, cap_idx, pl, pi,
                               scale, feas_tol, tol)
            if got is not None:
                return got
    return None


def _reduced_lp_rescue(
    Wd: Array, cnt: Array, m: Array, tol: float = DEFAULT_TOL,
) -> Optional[Tuple[Array, float, float, Array, Array]]:
    """Exact crossover for a stalled small-``g`` instance: solve the reduced
    LP (``g`` distinct rows, ``g(g-1)`` envy rows) outright.

    Degenerate catalog instances can park the PD iterate on a periodic orbit
    whose running average reproduces itself while staying slightly
    envy-infeasible — no amount of further iteration helps. After dedup the
    instance is tiny (the service's catalog regime has ``g`` in the single
    digits), so the exact LP on the *reduced* rows costs ~1 ms where the
    full-LP fallback at n=256 would pay for n(n-1) envy rows.
    """
    g, k = Wd.shape
    c = (cnt[:, None] * Wd).ravel()
    A_cap = np.zeros((k, g * k))
    for j in range(k):
        A_cap[j, j::k] = cnt
    rows = []
    for l in range(g):
        for i in range(g):
            if i == l:
                continue
            row = np.zeros(g * k)
            row[l * k:(l + 1) * k] = -Wd[l]
            row[i * k:(i + 1) * k] += Wd[l]
            rows.append(row)
    if rows:
        A_ub = np.vstack([A_cap, np.vstack(rows)])
        b_ub = np.concatenate([m, np.zeros(len(rows))])
    else:
        A_ub, b_ub = A_cap, m
    res = solve_lp(c, A_ub, b_ub)
    if not res.ok:
        return None
    xpol = res.x.reshape(g, k)
    obj = float(c @ res.x)
    # recover a certified dual from the LP vertex so warm starts carry the
    # full saddle point; fall back to the bare primal if the vertex is too
    # degenerate to polish (the bounds are then HiGHS's word, as for the
    # lp backend itself)
    pol = _certified_polish(Wd, cnt, m, xpol, np.zeros(k), np.zeros((g, g)), tol)
    if pol is not None:
        return pol
    return xpol, obj, obj, np.zeros(k), np.zeros((g, g))


# ---------------------------------------------------------------------------
# instance plumbing: dedup, padding, warm state
# ---------------------------------------------------------------------------


def _reduce(W: Array) -> Tuple[Array, Array, Array]:
    """Group identical rows: (distinct W (g, k), inverse (n,), counts (g,))."""
    Wd, inv, cnt = np.unique(W, axis=0, return_inverse=True, return_counts=True)
    return Wd, inv.reshape(-1), cnt.astype(np.float64)


def _padded_operands(Wd: Array, cnt: Array, k: int):
    """Pad the reduced instance to its pow2 bucket + build preconditioners."""
    g = Wd.shape[0]
    G = bucket(g)
    Wp = np.ones((G, k), dtype=np.float64)
    Wp[:g] = Wd
    cntp = np.zeros(G, dtype=np.float64)
    cntp[:g] = cnt
    mask = np.zeros(G, dtype=np.float64)
    mask[:g] = 1.0
    pairm = np.outer(mask, mask)
    np.fill_diagonal(pairm, 0.0)
    # Pock–Chambolle diagonal preconditioning: 1 / sum_i |A_ij| per primal
    # column, 1 / sum_j |A_ij| per dual row (padding entries pinned to zero).
    colsum = (Wp * mask[:, None]).sum(axis=0)
    denom = cntp[:, None] + colsum[None, :] - Wp + (g - 1) * Wp
    tau = mask[:, None] / np.maximum(denom, _W_FLOOR)
    sig_env = mask / np.maximum(2.0 * Wp.sum(axis=1), _W_FLOOR)
    sig_cap = 1.0 / max(float(cnt.sum()), 1e-12)
    return G, Wp, cntp, mask, pairm, tau, sig_env, sig_cap


def _init_state(G: int, k: int, Wd: Array,
                prev_state: Optional[Dict[str, Array]]):
    """Zero state, or the previous solve's reduced state for every distinct
    row that persists across the re-solve.

    The service's populations drift one tenant at a time: a profile appears
    or disappears, but most groups survive the re-solve. Rows of ``Wd`` that
    match a previous row exactly inherit that row's primal bundle and envy
    duals (capacity prices always carry over); only genuinely new groups
    start cold. ``warm`` (full match, same row order) gates the zero-PD-iter
    polish shortcut; ``matched`` counts the reused rows either way.
    """
    x = np.zeros((G, k))
    p = np.zeros(k)
    L = np.zeros((G, G))
    g = Wd.shape[0]
    warm = False
    matched = 0
    prev_Wd = None if prev_state is None else prev_state.get("Wd")
    if prev_Wd is not None and prev_state["x"].shape == (prev_Wd.shape[0], k):
        if np.array_equal(prev_Wd, Wd):
            x[:g] = prev_state["x"]
            p[:] = prev_state["p"]
            L[:g, :g] = prev_state["L"]
            return x, p, L, True, g
        if prev_Wd.shape[1] == k:
            lut = {prev_Wd[j].tobytes(): j for j in range(prev_Wd.shape[0])}
            hits = [(i, lut[Wd[i].tobytes()]) for i in range(g)
                    if Wd[i].tobytes() in lut]
            if hits:
                p[:] = prev_state["p"]
                for i, j in hits:
                    x[i] = prev_state["x"][j]
                for i, j in hits:
                    for i2, j2 in hits:
                        L[i, i2] = prev_state["L"][j, j2]
                matched = len(hits)
    return x, p, L, warm, matched


def _device_operands(dev: torch.device, ops, x: Array, p: Array, L: Array):
    """Batched padded operands (stacked ``_padded_operands`` outputs) and the
    starting state on ``dev``, in one host-to-device copy."""
    Wp, cntp, m, pairm, tau, sig_env, sig_cap = ops
    return _to_device(dev, Wp, cntp, m, pairm, tau, sig_env,
                      np.asarray(sig_cap, dtype=np.float64).reshape(-1, 1),
                      x, p, L)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@audited_solver
def solve_coop_pd(
    W: Array,
    m: Array,
    *,
    tol: float = DEFAULT_TOL,
    max_iters: int = MAX_ITERS,
    seg: int = SEG_ITERS,
    prev_state: Optional[Dict[str, Array]] = None,
    device=None,
) -> Allocation:
    """Cooperative OEF (Eq. 10) on the torch primal–dual tier.

    Exact in the certified sense: the answer is accepted only with a matching
    primal/dual pair whose weak-duality gap is below ``tol`` (relative), so
    parity with the LP is a theorem, not an iteration-count hope. Raises
    :class:`~repro_torch.core.backends.BackendError` when the budget runs
    out — callers going through ``backends.dispatch`` get the scipy-LP
    fallback automatically; direct callers see the error.

    ``prev_state`` warm-starts from a previous allocation's
    ``meta["pd_state"]``; the online service passes it on every re-solve, so
    steady-state instances certify within a segment or two, often with no
    PD iteration at all. ``device`` (default ``"cuda"``) is where the PD
    segments run; on the card each segment is one fused launch up to
    ``PD_FUSED_MAX_G`` groups and ``seg`` envy-kernel launches above.
    """
    dev = resolve_device(device)
    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    validate_speedup_matrix(W, normalized=False)
    n, k = W.shape
    if n == 1:
        # one tenant envies nobody: the EF program degenerates to "take all"
        X = m.reshape(1, k).copy()
        return Allocation(X=X, rows=default_rows(1), W=W, m=m,
                          meta={"policy": "oef-coop", "pd_iters": 0,
                                "warm_started": False,
                                "pd_state": {"Wd": W.copy(), "x": X.copy(),
                                             "p": np.zeros(k),
                                             "L": np.zeros((1, 1))}})

    Wd, inv, cnt = _reduce(W)
    g = Wd.shape[0]
    G, Wp, cntp, mask, pairm, tau, sig_env, sig_cap = _padded_operands(Wd, cnt, k)
    x, p, L, warm, matched = _init_state(G, k, Wd, prev_state)

    def _emit(xpol, lb, ub, p_d, L_d, iters, crossover):
        # pd_state carries the *certified* primal/dual pair, not the raw PD
        # iterate: warm starts then resume from the exact saddle, where the
        # next re-solve's polish re-certifies with zero PD iterations
        return Allocation(
            X=xpol[inv], rows=default_rows(n), W=W, m=m,
            meta={"policy": "oef-coop", "pd_iters": iters,
                  "warm_started": warm, "warm_rows": matched,
                  "crossover": crossover,
                  "objective_bounds": (lb, ub),
                  "pd_state": {"Wd": Wd, "x": xpol.copy(), "p": p_d.copy(),
                               "L": L_d.copy()}})

    if warm:
        # a small capacity/profile drift rarely moves the optimal active
        # set: polishing the carried-over state against the *new* m often
        # certifies outright, making the steady-state re-solve one host-side
        # least-squares pass with no PD segment at all
        with obs_trace.span("certify", "torch", tier="coop", warm=True):
            got = _certified_polish(Wd, cnt, m, x[:g], p, L[:g, :g], tol)
        if got is not None:
            return _emit(*got, 0, "active-set")

    iters = 0
    prev = (x, p, L)
    with _card_errors(dev):
        ops = _device_operands(
            dev, (Wp[None], cntp[None], m[None], pairm[None], tau[None],
                  sig_env[None], sig_cap), x[None], p[None], L[None])
    consts, state = ops[:7], ops[7:]
    while iters < max_iters:
        with obs_trace.span("execute", "torch", tier="coop", bucket=G), \
                _card_errors(dev):
            state = _pd_segment(*consts, *state, seg=seg)
            iters += seg
            xh, ph, Lh = (a[0] for a in _to_host(*state))
        with obs_trace.span("certify", "torch", tier="coop", warm=False):
            got = _certified_polish(Wd, cnt, m, xh[:g], ph, Lh[:g, :g], tol)
        if got is not None:
            return _emit(*got, iters, "active-set")
        # cross over to the exact reduced LP when further PD segments
        # cannot pay for themselves: either the segment map reproduced
        # its own starting state (a periodic orbit — further iteration
        # is a no-op) or a small-g instance has used up its PD budget
        moved = max(np.abs(xh - prev[0]).max(), np.abs(ph - prev[1]).max(),
                    np.abs(Lh - prev[2]).max())
        if g <= RESCUE_MAX_G and (moved <= 1e-12
                                  or iters >= RESCUE_AFTER_ITERS):
            with obs_trace.span("rescue", "torch", tier="coop", g=g):
                got = _reduced_lp_rescue(Wd, cnt, m, tol)
            if got is not None:
                return _emit(*got, iters, "reduced-lp")
        prev = (xh, ph, Lh)
    if g <= RESCUE_MAX_G:
        with obs_trace.span("rescue", "torch", tier="coop", g=g):
            got = _reduced_lp_rescue(Wd, cnt, m, tol)
        if got is not None:
            return _emit(*got, iters, "reduced-lp")
    raise backends.BackendError(
        f"coop primal-dual did not certify within {max_iters} iterations "
        f"(n={n}, {g} distinct rows); instance falls back to the LP")


def solve_coop_batch(
    Ws: Array,
    ms: Array,
    *,
    tol: float = DEFAULT_TOL,
    max_iters: int = MAX_ITERS,
    seg: int = SEG_ITERS,
    device=None,
) -> Array:
    """Batched cooperative solve of (B, n, k) stacked instances.

    Scenario sweeps (capacity what-ifs, profiling-noise ensembles) share
    every segment across the batch: on the card a segment is one fused
    launch for all B instances (one envy launch per step above
    ``PD_FUSED_MAX_G``). Rows are taken as-is (no dedup —
    sweeps perturb rows, so grouping would differ per instance).
    Certification is per instance between segments; instances that certify
    early stop paying the polish. Returns ``Xs (B, n, k)``; raises
    :class:`~repro_torch.core.backends.BackendError` if any instance
    exhausts the budget.
    """
    dev = resolve_device(device)
    Ws = np.asarray(Ws, dtype=np.float64)
    if Ws.ndim != 3:
        raise ValueError(f"need (B, n, k) stacked instances, got {Ws.shape}")
    B, n, k = Ws.shape
    ms = np.asarray(ms, dtype=np.float64)
    if ms.ndim == 1:
        ms = np.broadcast_to(ms, (B, k)).copy()
    cnt = np.ones(n)
    ops = [_padded_operands(Ws[b], cnt, k) for b in range(B)]
    G = ops[0][0]
    stacked = (np.stack([o[1] for o in ops]), np.stack([o[2] for o in ops]), ms,
               np.stack([o[4] for o in ops]), np.stack([o[5] for o in ops]),
               np.stack([o[6] for o in ops]), np.asarray([o[7] for o in ops]))
    with _card_errors(dev):
        dev_ops = _device_operands(dev, stacked, np.zeros((B, G, k)),
                                   np.zeros((B, k)), np.zeros((B, G, G)))
    consts, state = dev_ops[:7], dev_ops[7:]
    done: Dict[int, Array] = {}
    iters = 0
    while iters < max_iters and len(done) < B:
        with obs_trace.span("execute", "torch", tier="coop", bucket=G, batch=B), \
                _card_errors(dev):
            state = _pd_segment(*consts, *state, seg=seg)
            iters += seg
            x, p, L = _to_host(*state)
        for b in range(B):
            if b in done:
                continue
            got = _certified_polish(Ws[b], cnt, ms[b], x[b, :n], p[b],
                                    L[b, :n, :n], tol)
            if got is not None:
                done[b] = got[0]
    if len(done) < B and n <= RESCUE_MAX_G:
        for b in sorted(set(range(B)) - set(done)):
            got = _reduced_lp_rescue(Ws[b], cnt, ms[b])
            if got is not None:
                done[b] = got[0]
    if len(done) < B:
        missing = sorted(set(range(B)) - set(done))
        raise backends.BackendError(
            f"coop primal-dual batch: instances {missing} did not certify "
            f"within {max_iters} iterations")
    return np.stack([done[b] for b in range(B)])


def prewarm(n_max: int, k: int, *, seg: int = SEG_ITERS, device=None) -> List[int]:
    """Build the kernels and run one segment of each group bucket up to
    ``bucket(n_max)``, each on its route (the fused kernel up to
    ``PD_FUSED_MAX_G``, which also asks for its shared memory before any
    CUDA-graph capture).

    The first launch builds the CUDA library with ``nvcc``; running every
    bucket once also warms torch's allocator, so neither lands inside a
    measured re-solve. Returns the bucket sizes.
    """
    dev = resolve_device(device)
    sizes = []
    s = bucket(1)
    while s < bucket(n_max):
        sizes.append(s)
        s *= 2
    sizes.append(bucket(n_max))
    with obs_trace.span("prewarm", "torch", tier="coop", buckets=len(sizes)), \
            _card_errors(dev):
        for G in sizes:
            ops = _device_operands(
                dev, (np.ones((1, G, k)), np.ones((1, G)), np.full((1, k), 2.0),
                      (1.0 - np.eye(G))[None], np.full((1, G, k), 0.1),
                      np.full((1, G), 0.1), 0.1),
                np.zeros((1, G, k)), np.zeros((1, k)), np.zeros((1, G, G)))
            _to_host(*_pd_segment(*ops, seg=seg))
    return sizes


backends.register_backend(
    "oef-coop", "torch", solve_coop_pd, instance_class="any", fallback="lp")
