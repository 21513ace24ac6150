"""LP-based task -> node-type mapping (paper §V).

Variables: x(u,B) in [0,1] for every task/node-type pair, and alpha_B >= 0
per node-type.  The LP (relaxation of the paper's IP, Eq. 4-7):

    min  sum_B cost(B) * alpha_B
    s.t. sum_B x(u,B) = 1                                  (each task mapped)
         sum_{u ~ t} x(u,B) * dem(u,d)/cap(B,d) <= alpha_B  for all (B,t,d)
         0 <= x <= 1,  alpha >= 0

The optimal objective lower-bounds cost(opt) (§V-B); the solution is
near-integral (Lemma 4: at most n + mTD fractional variables at an extreme
point), so the rounding pi(u) = argmax_B x*(u,B) is effective.

The timeline is trimmed before constraint construction (congestion only
changes at task starts), so the constraint count is m * T' * D with
T' <= n.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog

from .problem import (Problem, active_mask, feasible_types,
                      require_lowered, trim_timeline)

__all__ = ["LPResult", "solve_lp", "lp_map"]


@dataclasses.dataclass
class LPResult:
    x: np.ndarray          # (n, m) fractional assignment
    alpha: np.ndarray      # (m,) per-type congestion
    objective: float       # lower bound on cost(opt)
    mapping: np.ndarray    # (n,) argmax-rounded node-type
    x_max: np.ndarray      # (n,) max_B x(u,B) — near-integrality diagnostic
    solver: str = "highs"


def _select_slots(problem: Problem, max_slots: int) -> np.ndarray:
    """Pick <= max_slots trimmed-slot indices: the top-congestion slots (by
    the cheap Lemma-1 penalty congestion) plus a uniform stride cover.

    Dropping constraint rows *relaxes* the LP, so the objective remains a
    valid lower bound on cost(opt); only the mapping gets coarser.
    """
    from .penalty import min_penalty

    act = active_mask(problem)  # (n, T')
    per_slot = min_penalty(problem, "avg") @ act
    top = np.argsort(-per_slot)[: max_slots // 2]
    stride = np.linspace(0, problem.T - 1, max_slots - len(top)).astype(int)
    return np.unique(np.concatenate([top, stride]))


def _build_constraints(problem: Problem, max_slots: int | None = None):
    """Sparse A_ub for the congestion constraints, plus A_eq.

    Column layout: [x(0,0..m-1), x(1,0..m-1), ..., x(n-1,0..m-1), alpha_0..m-1]
    Row layout for A_ub: for B in range(m) for t in range(T') for d in range(D).
    """
    n, m, D = problem.n, problem.m, problem.D
    trimmed, _ = trim_timeline(problem)
    if max_slots is not None and trimmed.T > max_slots:
        slots = _select_slots(trimmed, max_slots)
        act_full = active_mask(trimmed)[:, slots]
        Tp = len(slots)
        act = act_full
    else:
        Tp = trimmed.T
        act = active_mask(trimmed)  # (n, T')
    u_idx, t_idx = np.nonzero(act)  # active (task, slot) pairs
    nnz_per_bd = len(u_idx)

    # weight w(u, B, d) = dem(u, d) / cap(B, d)
    rows, cols, vals = [], [], []
    for B in range(m):
        w = problem.dem / problem.node_types.cap[B][None, :]  # (n, D)
        for d in range(D):
            r = (B * Tp + t_idx) * D + d
            rows.append(r)
            cols.append(u_idx * m + B)
            vals.append(w[u_idx, d])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    # -alpha_B on each row
    arow = np.arange(m * Tp * D)
    acol = n * m + arow // (Tp * D)
    rows = np.concatenate([rows, arow])
    cols = np.concatenate([cols, acol])
    vals = np.concatenate([vals, -np.ones(m * Tp * D)])
    A_ub = sp.coo_matrix(
        (vals, (rows, cols)), shape=(m * Tp * D, n * m + m)
    ).tocsr()
    b_ub = np.zeros(m * Tp * D)

    # sum_B x(u, B) = 1
    erow = np.repeat(np.arange(n), m)
    ecol = np.arange(n * m)
    A_eq = sp.coo_matrix(
        (np.ones(n * m), (erow, ecol)), shape=(n, n * m + m)
    ).tocsr()
    b_eq = np.ones(n)
    return A_ub, b_ub, A_eq, b_eq, nnz_per_bd


def solve_lp(
    problem: Problem,
    method: str = "auto",
    max_slots: int | None = None,
) -> LPResult:
    """Solve the mapping LP exactly with HiGHS (paper used CBC via python-mip;
    HiGHS is the offline-available exact equivalent).

    method='auto' uses dual simplex for small LPs and interior-point (with
    crossover) for large ones — ~4x faster at GCT scale, measured.
    ``max_slots`` optionally subsamples constraint slots (sound relaxation).

    Constrained instances must be lowered first: lowered virtual
    dimensions become ordinary congestion rows here.
    """
    require_lowered(problem, "solve_lp")
    n, m = problem.n, problem.m
    if n == 0:
        return LPResult(
            x=np.zeros((0, m)), alpha=np.zeros(m), objective=0.0,
            mapping=np.zeros(0, dtype=np.int64), x_max=np.zeros(0),
        )
    A_ub, b_ub, A_eq, b_eq, _ = _build_constraints(problem, max_slots=max_slots)
    if method == "auto":
        method = "highs-ipm" if A_ub.shape[0] > 6000 else "highs"
    c = np.concatenate([np.zeros(n * m), problem.node_types.cost])
    # x(u,B) is pinned to 0 when u cannot fit an empty B node: opt can only
    # use feasible placements, so this keeps the LP a valid (tighter)
    # relaxation and keeps the rounded mapping placeable.
    feas = feasible_types(problem).reshape(-1)  # (n*m,)
    bounds = [(0.0, 1.0 if f else 0.0) for f in feas] + [(0.0, None)] * m
    res = linprog(
        c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq, bounds=bounds,
        method=method,
    )
    if res.status != 0:
        raise RuntimeError(f"LP solve failed: status={res.status} {res.message}")
    x = res.x[: n * m].reshape(n, m)
    alpha = res.x[n * m :]
    mapping = x.argmax(axis=1)
    return LPResult(
        x=x,
        alpha=alpha,
        objective=float(res.fun),
        mapping=mapping,
        x_max=x.max(axis=1),
        solver=f"linprog/{method}",
    )


def lp_map(problem: Problem, **kw) -> np.ndarray:
    """(n,) argmax-rounded LP mapping (paper §V-C)."""
    return solve_lp(problem, **kw).mapping
