"""Solution representation, cost accounting and feasibility verification."""

from __future__ import annotations

import dataclasses

import numpy as np

from .problem import Problem

__all__ = ["Solution", "verify", "EPS"]

# Feasibility slack for float accumulation; demands/capacities are O(1).
EPS = 1e-7


@dataclasses.dataclass
class Solution:
    """A purchased cluster plus a placement of every task.

    node_type: (num_nodes,) node-type index of each purchased node, in
               purchase order (node ids are purchase ranks *within the whole
               solution*; first-fit's "earliest purchased" == lowest id).
    assign:    (n,) node id for each task.
    meta:      free-form provenance (algorithm, mapper, fit policy, ...).
    """

    node_type: np.ndarray
    assign: np.ndarray
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return int(len(self.node_type))

    def cost(self, problem: Problem) -> float:
        return float(problem.node_types.cost[self.node_type].sum())

    def nodes_per_type(self, problem: Problem) -> np.ndarray:
        return np.bincount(self.node_type, minlength=problem.m)


def verify(problem: Problem, solution: Solution, eps: float = EPS) -> None:
    """Raise AssertionError unless the solution satisfies the capacity
    constraint at every (node, timeslot, dimension) and every task is placed.

    This is the ground-truth checker used by every test and benchmark; it is
    intentionally direct (dense usage tensor) rather than clever.
    """
    n, T, D = problem.n, problem.T, problem.D
    assert solution.assign.shape == (n,), "every task must be placed"
    if n == 0:
        return
    assert (solution.assign >= 0).all() and (
        solution.assign < solution.num_nodes
    ).all(), "assignments must reference purchased nodes"

    num_nodes = solution.num_nodes
    usage = np.zeros((num_nodes, T, D))
    for u in range(n):
        b = solution.assign[u]
        usage[b, problem.start[u] : problem.end[u] + 1, :] += problem.dem[u]
    cap = problem.node_types.cap[solution.node_type]  # (num_nodes, D)
    excess = usage - cap[:, None, :]
    worst = excess.max()
    assert worst <= eps, (
        f"capacity violated: max excess {worst:.3e} at "
        f"{np.unravel_index(excess.argmax(), excess.shape)}"
    )
