"""Baseline schedulers the paper compares against (§2.4, §6.1.3).

  - ``solve_maxmin``       — classic max-min fairness: equal split of every
    device type (the starting point of Gandiva_fair's trading).
  - ``solve_gavel``        — Gavel's heterogeneity-aware max-min policy
    [OSDI'20]: maximize the minimum (throughput / max-min-fair-share
    throughput) ratio, then maximize total efficiency as the second stage.
  - ``solve_gandiva_fair`` — Gandiva_fair [EuroSys'20] as described in §2.4:
    equal split followed by greedy second-price trading of slow-type shares
    for fast-type shares, "always trading between shares with the greatest
    speedup gap".

The Gandiva_fair trading rule is reconstructed to match the paper's worked
examples *exactly* (Eq. (1): X=[[1,.09],[0,.47],[0,.44]], the 2.5->2.9 price
shift under cheating, and X^f=[[1,.11],[0,.45],[0,.44]]): with users sorted by
descending speedup-ratio bid b_(1) >= b_(2) >= ..., the i-th buyer trades all
its slow-type share at price
    p_1 = b_(2),      p_i = (b_(i+1) + p_(i-1)) / 2   (i >= 2),
buying from the lowest-bid holders of fast shares, and a trade executes only
while mutually beneficial (seller bid < p_i < buyer bid). See
tests/test_baselines.py for the digit-level reproduction of §2.4.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import backends
from .lp import LPError, solve_lp
from .oef import _capacity_constraints, _solve, allocation_reusable, mark_reused
from .properties import audited_solver
from .types import Allocation, default_rows

Array = np.ndarray


@audited_solver
def solve_maxmin(W: Array, m: Array) -> Allocation:
    """Max-min fairness for interchangeable devices: equal split per type."""
    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n, k = W.shape
    X = np.tile(m / n, (n, 1))
    return Allocation(X=X, rows=default_rows(n), W=W, m=m,
                      meta={"policy": "max-min"})


@audited_solver
def solve_gavel(W: Array, m: Array, *, method: str = "highs") -> Allocation:
    """Gavel's max-min-over-fair-share policy (as portrayed in the paper).

    Stage 1: maximize t s.t. capacity and W_l.x_l >= t * (W_l . m/n).
    Stage 2: pin every user to exactly t* x their fair-share throughput
    (the paper's worked example (3) shows all ratios equalized: 1.09/1.08/
    1.08) and minimize device usage — Gavel does not run an efficiency
    maximization above the equalized ratio.
    """
    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n, k = W.shape
    fair = W @ (m / n)  # throughput of a 1/n cluster slice per user
    nv = n * k + 1  # x variables + t
    A_cap, b_cap = _capacity_constraints(n, k, m)
    A_cap = np.hstack([A_cap, np.zeros((k, 1))])
    # -W_l.x_l + fair_l * t <= 0
    rows = []
    for l in range(n):
        row = np.zeros(nv)
        row[l * k : (l + 1) * k] = -W[l]
        row[-1] = fair[l]
        rows.append(row)
    A_ub = np.vstack([A_cap] + [np.vstack(rows)])
    b_ub = np.concatenate([b_cap, np.zeros(n)])
    c1 = np.zeros(nv)
    c1[-1] = 1.0
    res1 = _solve(c1, A_ub, b_ub, None, None, method)
    t_star = float(res1.x[-1])

    # Stage 2: equalize — W_l.x_l == t* fair_l for all l; minimize total
    # device usage as the tie-break (work-conserving round-robin fills idle
    # capacity separately in Gavel's system; the policy itself stops here).
    c2 = -np.ones(n * k)
    A_cap2, b_cap2 = _capacity_constraints(n, k, m)
    A_eq = np.zeros((n, n * k))
    for l in range(n):
        A_eq[l, l * k : (l + 1) * k] = W[l]
    b_eq = t_star * fair * (1 - 1e-12)
    res2 = _solve(c2, A_cap2, b_cap2, A_eq, b_eq, method)
    X = res2.x.reshape(n, k)
    return Allocation(X=X, rows=default_rows(n), W=W, m=m,
                      meta={"policy": "gavel", "t_star": t_star})


@audited_solver
def solve_gandiva_fair(W: Array, m: Array) -> Allocation:
    """Gandiva_fair: equal split + greedy second-price pairwise trading."""
    W = np.asarray(W, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n, k = W.shape
    X = np.tile(m / n, (n, 1))
    if n < 2 or k < 2:
        return Allocation(X=X, rows=default_rows(n), W=W, m=m,
                          meta={"policy": "gandiva-fair", "trades": 0})
    trades = 0
    # Pairs of (slow type lo, fast type hi), widest gap first — "always trades
    # between shares with the greatest speedup gap" (§6.1.3).
    pairs = sorted(
        [(lo, hi) for hi in range(k) for lo in range(hi)],
        key=lambda p: p[1] - p[0],
        reverse=True,
    )
    for lo, hi in pairs:
        trades += _trade_pair(W, X, lo, hi)
    return Allocation(X=X, rows=default_rows(n), W=W, m=m,
                      meta={"policy": "gandiva-fair", "trades": trades})


def _trade_pair(W: Array, X: Array, lo: int, hi: int) -> int:
    """One trading pass between type ``lo`` (slow) and ``hi`` (fast)."""
    n = W.shape[0]
    bids = W[:, hi] / W[:, lo]  # fast-type valuation in slow-type units
    order = np.argsort(-bids, kind="stable")  # buyers: highest bid first
    b = bids[order]
    # Second-price schedule reconstructed from the paper's worked example.
    prices = np.zeros(n)
    if n >= 2:
        prices[0] = b[1]
        for i in range(1, n - 1):
            prices[i] = 0.5 * (b[i + 1] + prices[i - 1])
        prices[n - 1] = np.inf  # the slowest user never buys
    trades = 0
    seller_ptr = n - 1  # sellers: lowest bid first
    for i in range(n - 1):
        buyer = order[i]
        p = prices[i]
        if not (b[i] > p * (1 + 1e-12)):
            continue  # not beneficial for the buyer
        sell_amount = X[buyer, lo]
        want_fast = sell_amount / p
        while want_fast > 1e-15 and seller_ptr > i:
            seller = order[seller_ptr]
            if not (bids[seller] < p * (1 - 1e-12)):
                break  # not beneficial for the seller
            avail = X[seller, hi]
            got = min(avail, want_fast)
            if got > 0:
                paid_slow = got * p
                X[buyer, hi] += got
                X[buyer, lo] -= paid_slow
                X[seller, hi] -= got
                X[seller, lo] += paid_slow
                want_fast -= got
                trades += 1
            if X[seller, hi] <= 1e-15:
                seller_ptr -= 1
            else:
                break
    return trades


ALL_POLICIES = {
    "max-min": solve_maxmin,
    "gavel": solve_gavel,
    "gandiva-fair": solve_gandiva_fair,
}

# Registry wiring: each baseline is the sole backend of its own program —
# max-min and Gandiva_fair are closed-form/combinatorial ("numpy"), Gavel is
# a two-stage LP ("lp"). No fallbacks: every baseline covers all instances.
backends.register_backend("max-min", "numpy", solve_maxmin, default=True)
backends.register_backend("gavel", "lp", solve_gavel, default=True)
backends.register_backend("gandiva-fair", "numpy", solve_gandiva_fair,
                          default=True)


@audited_solver
def solve_incremental(
    W: Array,
    m: Array,
    *,
    policy: str,
    prev: Optional[Allocation] = None,
    method: str = "highs",
) -> Allocation:
    """Incremental-solve hook for the baseline policies (online service).

    The baselines have no warm-startable internal state, so the hook only
    short-circuits the unchanged-instance case; a dirty instance is re-solved
    from scratch exactly as in the round simulator.
    """
    if allocation_reusable(prev, W, m, policy=policy):
        return mark_reused(prev)
    if policy not in ALL_POLICIES:
        raise ValueError(f"unknown baseline policy: {policy}")
    return backends.dispatch(policy, W, m, method=method)
