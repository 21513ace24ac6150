"""Congestion-aware concentration rounding (beyond-paper).

Plain argmax rounding pays ~half a node of ceiling waste per node-type
when the LP spreads mass (degenerate homogeneous pricing).  This rounding assigns tasks sequentially (descending
LP-confidence last, so confident tasks anchor first... empirically:
descending size first) to the type minimizing *marginal ceiling cost*:

    marginal(u, B) = cost(B) * (ceil(new_peak_B) - ceil(peak_B))
                     - lam * x_lp(u, B)

ties broken toward the LP's fractional preference.  The result feeds the
same placement phase as any other mapping.  Host numpy, ported from
``repro.core.rounding`` unchanged.
"""

from __future__ import annotations

import numpy as np

from .problem import Problem, active_mask, feasible_types

__all__ = ["concentration_rounding"]


def concentration_rounding(problem: Problem, x_lp: np.ndarray,
                           lam: float = 0.05) -> np.ndarray:
    """(n,) mapping from the fractional LP solution x_lp (n, m)."""
    n, m, D = problem.n, problem.m, problem.D
    act = active_mask(problem)                      # (n, T')
    Tp = act.shape[1]
    w = problem.dem[:, None, :] / problem.node_types.cap[None, :, :]
    feas = feasible_types(problem)
    cost = problem.node_types.cost

    cong = np.zeros((m, Tp, D))
    peak = np.zeros(m)
    mapping = np.full(n, -1, np.int64)
    # big, long tasks first: they dominate the peaks
    size = w.mean(axis=(1, 2)) * (problem.end - problem.start + 1)
    order = np.argsort(-size)
    for u in order:
        span = act[u]                               # (T',)
        best, best_score = -1, np.inf
        for B in range(m):
            if not feas[u, B]:
                continue
            new = cong[B][span] + w[u, B][None, :]
            new_peak = max(peak[B], float(new.max()) if new.size else 0.0)
            marginal = cost[B] * (np.ceil(new_peak - 1e-9)
                                  - np.ceil(peak[B] - 1e-9))
            score = marginal - lam * cost[B] * x_lp[u, B]
            if score < best_score - 1e-12:
                best, best_score = B, score
        mapping[u] = best
        cong[best][span] += w[u, best][None, :]
        peak[best] = max(peak[best], float(cong[best][span].max())
                         if span.any() else peak[best])
    return mapping
