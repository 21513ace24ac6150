"""Lower bounds on cost(opt).

* ``lp_lowerbound``        — the LP objective (paper §V-B / §VI-A); the bound
                             all reported costs are normalized by.
* ``congestion_lowerbound``— Lemma 1: max_t sum_{u ~ t} p*(u); cheap,
                             solver-free, used for sanity cross-checks
                             (always <= the LP bound's quality, never above
                             cost(opt)).
* ``no_timeline_lowerbound``— the §VI-F comparator: the same LP bound after
                             making every task perpetually active (T = 1),
                             i.e. the cost floor a timeline-agnostic
                             rightsizer cannot beat.

Host numpy (and HiGHS for the LP), ported from ``repro.core.lowerbound``.
"""

from __future__ import annotations

import numpy as np

from .penalty import min_penalty
from .problem import Problem, active_mask, trim_timeline

__all__ = [
    "congestion_lowerbound",
    "lp_lowerbound",
    "no_timeline_lowerbound",
]


def congestion_lowerbound(problem: Problem) -> float:
    """Lemma 1: cost(opt) >= max_t sum_{u ~ t} p_avg*(u)."""
    if problem.n == 0:
        return 0.0
    p_star = min_penalty(problem, "avg")  # (n,)
    trimmed, _ = trim_timeline(problem)
    act = active_mask(trimmed)  # (n, T')
    per_slot = p_star @ act  # (T',)
    return float(per_slot.max())


def lp_lowerbound(problem: Problem) -> float:
    from .lp_map import solve_lp

    return solve_lp(problem).objective


def no_timeline_lowerbound(problem: Problem) -> float:
    """LP lower bound of the always-active (T=1) relaxation-to-Rightsizing."""
    flat = Problem(
        dem=problem.dem,
        start=np.zeros(problem.n, dtype=np.int64),
        end=np.zeros(problem.n, dtype=np.int64),
        node_types=problem.node_types,
        T=1,
    )
    return lp_lowerbound(flat)
