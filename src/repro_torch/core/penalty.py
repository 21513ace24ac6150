"""Penalty-based task -> node-type mapping (paper §III, PenaltyMap phase 1).

Relative demand ("height") of task u w.r.t. node-type B:

    h_avg(u|B) = (1/D) sum_d dem(u,d) / cap(B,d)
    h_max(u|B) = max_d  dem(u,d) / cap(B,d)

Penalty p(u|B) = cost(B) * h(u|B); each task maps to argmin_B p(u|B).
"""

from __future__ import annotations

import numpy as np

from .problem import Problem, feasible_types

__all__ = [
    "relative_demand",
    "penalty_matrix",
    "penalty_map",
    "min_penalty",
]


def relative_demand(problem: Problem, kind: str = "avg") -> np.ndarray:
    """(n, m) matrix of h(u|B)."""
    # ratios: (n, m, D) = dem[u, d] / cap[B, d]
    ratios = problem.dem[:, None, :] / problem.node_types.cap[None, :, :]
    if kind == "avg":
        return ratios.mean(axis=2)
    if kind == "max":
        return ratios.max(axis=2)
    raise ValueError(f"unknown relative-demand kind {kind!r} (want 'avg'|'max')")


def penalty_matrix(problem: Problem, kind: str = "avg") -> np.ndarray:
    """(n, m) matrix of p(u|B) = cost(B) * h(u|B)."""
    return relative_demand(problem, kind) * problem.node_types.cost[None, :]


def _masked_penalty(problem: Problem, kind: str) -> np.ndarray:
    """Penalty matrix with +inf on (task, type) pairs the task cannot fit
    even on an empty node (the paper's traces have only small tasks, so it
    never states this guard; it is required for general instances)."""
    p = penalty_matrix(problem, kind)
    return np.where(feasible_types(problem), p, np.inf)


def penalty_map(problem: Problem, kind: str = "avg") -> np.ndarray:
    """(n,) array mapping each task to its least-penalty *feasible* node-type."""
    return _masked_penalty(problem, kind).argmin(axis=1)


def min_penalty(problem: Problem, kind: str = "avg") -> np.ndarray:
    """(n,) array of p*(u) = min_B p(u|B) over feasible types — used by the
    congestion lower bound (restricting to feasible types only tightens it:
    opt can only place u on feasible types)."""
    return _masked_penalty(problem, kind).min(axis=1)
