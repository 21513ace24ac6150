"""Node-elimination local search (beyond-paper post-pass).

The GCT diagnosis (EXPERIMENTS.md §Paper note) shows most of LP-map's gap
is per-type ceiling waste: many types own a nearly-empty last node.  This
pass tries to *empty* nodes — lowest utilization first — by relocating
their tasks into the remaining nodes (any type, feasibility-checked over
the full timeline); an emptied node is removed from the purchase.  Cost
never increases; applies to any algorithm's output.
"""

from __future__ import annotations

import numpy as np

from .problem import Problem
from .solution import EPS, Solution

__all__ = ["eliminate_nodes"]


def _usage(problem: Problem, solution: Solution) -> np.ndarray:
    """(num_nodes, T, D) aggregate demand."""
    usage = np.zeros((solution.num_nodes, problem.T, problem.D))
    for u in range(problem.n):
        usage[solution.assign[u],
              problem.start[u]: problem.end[u] + 1] += problem.dem[u]
    return usage


def eliminate_nodes(problem: Problem, solution: Solution,
                    passes: int = 2) -> Solution:
    """Returns a solution with cost <= the input's."""
    assign = solution.assign.copy()
    node_type = solution.node_type.copy()
    usage = _usage(problem, solution)
    cap = problem.node_types.cap[node_type]          # (nodes, D)
    cost = problem.node_types.cost[node_type]
    alive = np.ones(len(node_type), bool)

    tasks_of: list[list[int]] = [[] for _ in range(len(node_type))]
    for u in range(problem.n):
        tasks_of[assign[u]].append(u)

    for _ in range(passes):
        # utilization = peak fraction of capacity used (cost-weighted order)
        util = (usage / np.maximum(cap[:, None, :], 1e-12)).max(axis=(1, 2))
        order = np.argsort(util / np.maximum(cost, 1e-12))
        improved = False
        for b in order:
            if not alive[b] or not tasks_of[b]:
                if alive[b] and not tasks_of[b]:
                    alive[b] = False
                    improved = True
                continue
            # try to relocate every task of b elsewhere (largest first)
            moves: list[tuple[int, int]] = []
            trial_usage = usage.copy()
            ok = True
            tasks_sorted = sorted(
                tasks_of[b],
                key=lambda u: -float(problem.dem[u].max()))
            for u in tasks_sorted:
                s, e = problem.start[u], problem.end[u]
                dem = problem.dem[u]
                trial_usage[b, s:e + 1] -= dem
                placed = False
                for nb in range(len(node_type)):
                    if nb == b or not alive[nb]:
                        continue
                    fits = (
                        trial_usage[nb, s:e + 1] + dem[None, :]
                        <= problem.node_types.cap[node_type[nb]][None, :]
                        + EPS).all()
                    if fits:
                        trial_usage[nb, s:e + 1] += dem
                        moves.append((u, nb))
                        placed = True
                        break
                if not placed:
                    ok = False
                    break
            if ok:
                usage = trial_usage
                for u, nb in moves:
                    assign[u] = nb
                    tasks_of[nb].append(u)
                tasks_of[b] = []
                alive[b] = False
                improved = True
        if not improved:
            break

    # compact node ids
    remap = -np.ones(len(node_type), np.int64)
    remap[alive] = np.arange(int(alive.sum()))
    return Solution(
        node_type=node_type[alive],
        assign=remap[assign],
        meta=dict(solution.meta, local_search=True),
    )
