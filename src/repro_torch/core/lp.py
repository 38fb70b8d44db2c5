"""Linear-programming layer for the OEF fair-share evaluator.

The paper implements the evaluator with cvxpy + ECOS (§4.5). ECOS is not
available offline, and the problems are pure LPs, so we provide:

  - ``method="highs"``   — scipy.optimize.linprog (HiGHS dual simplex), the
    production path used by the scalability benchmark (Fig 10a);
  - ``method="simplex"`` — a self-contained dense two-phase primal simplex
    (numpy only, Bland's rule), used to cross-check HiGHS in property tests
    and as a zero-dependency fallback.

All entry points solve
    maximize    c . x
    subject to  A_ub x <= b_ub,  A_eq x == b_eq,  x >= 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

try:  # scipy is present in this environment; guard anyway.
    from scipy.optimize import linprog as _scipy_linprog

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False

Array = np.ndarray


@dataclasses.dataclass
class LPResult:
    x: Array
    fun: float  # value of the *maximization* objective
    status: int  # 0 = optimal
    message: str
    nit: int = 0

    @property
    def ok(self) -> bool:
        return self.status == 0


class LPError(RuntimeError):
    pass


def solve_lp(
    c: Array,
    A_ub: Optional[Array] = None,
    b_ub: Optional[Array] = None,
    A_eq: Optional[Array] = None,
    b_eq: Optional[Array] = None,
    *,
    method: str = "highs",
) -> LPResult:
    """Maximize ``c @ x`` subject to the given constraints and ``x >= 0``.

    Raises ``ValueError`` on malformed inputs (mismatched shapes, a matrix
    without its right-hand side) — explicit raises rather than asserts so the
    checks survive ``python -O`` on the evaluator hot path.
    """
    c = np.asarray(c, dtype=np.float64)
    if c.ndim != 1:
        raise ValueError(f"objective c must be 1-D, got shape {c.shape}")
    _validate_constraint_block("A_ub/b_ub", A_ub, b_ub, c.shape[0])
    _validate_constraint_block("A_eq/b_eq", A_eq, b_eq, c.shape[0])
    if method == "highs":
        if not _HAVE_SCIPY:  # pragma: no cover
            method = "simplex"
        else:
            res = _scipy_linprog(
                -c,
                A_ub=A_ub,
                b_ub=b_ub,
                A_eq=A_eq,
                b_eq=b_eq,
                bounds=(0, None),
                method="highs",
            )
            return LPResult(
                x=np.asarray(res.x) if res.x is not None else np.zeros_like(c),
                fun=-float(res.fun) if res.fun is not None else float("nan"),
                status=int(res.status),
                message=str(res.message),
                nit=int(getattr(res, "nit", 0)),
            )
    if method == "simplex":
        return _two_phase_simplex(c, A_ub, b_ub, A_eq, b_eq)
    raise ValueError(f"unknown LP method: {method}")


def _validate_constraint_block(name: str, A: Optional[Array], b: Optional[Array],
                               n_vars: int) -> None:
    if (A is None) != (b is None):
        raise ValueError(f"{name}: constraint matrix and rhs must be given together")
    if A is None:
        return
    A2 = np.atleast_2d(np.asarray(A, dtype=np.float64))
    b1 = np.asarray(b, dtype=np.float64).ravel()
    if A2.size and A2.shape[1] != n_vars:
        raise ValueError(
            f"{name}: matrix has {A2.shape[1]} columns but the objective has "
            f"{n_vars} variables"
        )
    if A2.shape[0] != b1.shape[0] and A2.size:
        raise ValueError(
            f"{name}: {A2.shape[0]} constraint rows but {b1.shape[0]} rhs entries"
        )


# ---------------------------------------------------------------------------
# Self-contained dense two-phase simplex (maximization, x >= 0).
# ---------------------------------------------------------------------------


def _two_phase_simplex(
    c: Array,
    A_ub: Optional[Array],
    b_ub: Optional[Array],
    A_eq: Optional[Array],
    b_eq: Optional[Array],
    max_iter: int = 100_000,
) -> LPResult:
    n = c.shape[0]
    rows = []
    rhs = []
    n_slack = 0
    if A_ub is not None and len(A_ub):
        A_ub = np.atleast_2d(np.asarray(A_ub, dtype=np.float64))
        b_ub = np.asarray(b_ub, dtype=np.float64).ravel()
        n_slack = A_ub.shape[0]
        for i in range(A_ub.shape[0]):
            row = np.zeros(n + n_slack)
            row[:n] = A_ub[i]
            row[n + i] = 1.0
            rows.append(row)
            rhs.append(b_ub[i])
    if A_eq is not None and len(A_eq):
        A_eq = np.atleast_2d(np.asarray(A_eq, dtype=np.float64))
        b_eq = np.asarray(b_eq, dtype=np.float64).ravel()
        for i in range(A_eq.shape[0]):
            row = np.zeros(n + n_slack)
            row[:n] = A_eq[i]
            rows.append(row)
            rhs.append(b_eq[i])
    if not rows:
        # Unbounded unless c <= 0; x = 0 is optimal for c <= 0.
        if np.any(c > 0):
            return LPResult(np.zeros(n), float("inf"), 3, "unbounded (no constraints)")
        return LPResult(np.zeros(n), 0.0, 0, "optimal (trivial)")

    A = np.vstack(rows)
    b = np.asarray(rhs, dtype=np.float64)
    # Ensure b >= 0 for phase-1 artificial basis.
    neg = b < 0
    A[neg] *= -1.0
    b[neg] *= -1.0

    m_rows, n_tot = A.shape
    # Phase 1: artificial variables, minimize their sum.
    T = np.zeros((m_rows + 1, n_tot + m_rows + 1))
    T[:m_rows, :n_tot] = A
    T[:m_rows, n_tot : n_tot + m_rows] = np.eye(m_rows)
    T[:m_rows, -1] = b
    basis = list(range(n_tot, n_tot + m_rows))
    # Phase-1 objective row (maximize -sum(artificials)).
    T[-1, :] = -T[:m_rows, :].sum(axis=0)
    T[-1, n_tot : n_tot + m_rows] = 0.0

    nit = _simplex_iterate(T, basis, n_tot + m_rows, max_iter)
    if T[-1, -1] < -1e-7:
        return LPResult(np.zeros(n), float("nan"), 2, "infeasible", nit)

    # Drive remaining artificials out of the basis where possible.
    for r, bv in enumerate(basis):
        if bv >= n_tot:
            piv = np.where(np.abs(T[r, :n_tot]) > 1e-9)[0]
            if len(piv):
                _pivot(T, r, int(piv[0]))
                basis[r] = int(piv[0])

    # Phase 2 tableau: drop artificial columns.
    keep = list(range(n_tot)) + [n_tot + m_rows]
    T2 = T[:, keep].copy()
    obj = np.zeros(n_tot + 1)
    obj[:n] = -np.asarray(c, dtype=np.float64)  # maximize c.x == minimize -c.x
    T2[-1, :] = obj
    for r, bv in enumerate(basis):
        if bv < n_tot and abs(T2[-1, bv]) > 0:
            T2[-1, :] -= T2[-1, bv] * T2[r, :]

    nit2 = _simplex_iterate(T2, basis, n_tot, max_iter)
    if nit2 < 0:
        return LPResult(np.zeros(n), float("inf"), 3, "unbounded", nit - nit2)

    x = np.zeros(n_tot)
    for r, bv in enumerate(basis):
        if bv < n_tot:
            x[bv] = T2[r, -1]
    return LPResult(x[:n], float(np.dot(c, x[:n])), 0, "optimal", nit + nit2)


def _pivot(T: Array, r: int, col: int) -> None:
    T[r, :] /= T[r, col]
    for i in range(T.shape[0]):
        if i != r and abs(T[i, col]) > 0:
            T[i, :] -= T[i, col] * T[r, :]


def _simplex_iterate(T: Array, basis: list, n_cols: int, max_iter: int) -> int:
    """Run primal simplex on tableau T (last row = objective, maximize).

    Returns iteration count, or negative count if unbounded.
    """
    nit = 0
    while nit < max_iter:
        # Bland's rule: first column with negative reduced cost.
        red = T[-1, :n_cols]
        enter_candidates = np.where(red < -1e-9)[0]
        if len(enter_candidates) == 0:
            return nit
        col = int(enter_candidates[0])
        ratios = np.full(T.shape[0] - 1, np.inf)
        pos = T[:-1, col] > 1e-9
        ratios[pos] = T[:-1, -1][pos] / T[:-1, col][pos]
        if not np.any(np.isfinite(ratios)):
            return -nit - 1  # unbounded
        r = int(np.argmin(ratios))
        _pivot(T, r, col)
        basis[r] = col
        nit += 1
    raise LPError("simplex iteration limit exceeded")
