"""Constraint lowering — the identity path of ``repro.core.constraints``.

The engines solve plain instances only.  ``lower_constraints`` passes an
instance without constraints, or with vacuous ones, through unchanged (the
reference's identity fast path, which keeps unconstrained results
bit-stable); an instance with active constraints (deadlines, affinity,
anti-affinity, exclusivity, malleable width) raises ``NotImplementedError``:
lowering them is ROADMAP Queue 1, item 8.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .problem import Problem

__all__ = ["Lowering", "lower_constraints", "expand_solution"]


@dataclasses.dataclass(frozen=True)
class Lowering:
    """The result of ``lower_constraints``.

    original: the input ``Problem``; lowered: the plain ``Problem`` the
    engines solve; row_of: (n,) lowered row of each original task;
    widths: (n,) resolved widths (all 1); end_eff: (n,) finish slots;
    identity: always True in this port.
    """

    original: Problem
    lowered: Problem
    row_of: np.ndarray
    widths: np.ndarray
    end_eff: np.ndarray
    identity: bool


def lower_constraints(problem: Problem) -> Lowering:
    """Identity lowering of an unconstrained (or vacuously constrained)
    instance; ``NotImplementedError`` for active constraints."""
    c = problem.constraints
    n = problem.n
    if c is not None and n and not c.is_vacuous():
        raise NotImplementedError(
            "instances with active constraints need constraint lowering, "
            "which is not ported yet (ROADMAP Queue 1, item 8)")
    lowered = problem if c is None else dataclasses.replace(
        problem, constraints=None)
    return Lowering(
        original=problem, lowered=lowered,
        row_of=np.arange(n, dtype=np.int64),
        widths=np.ones(n, dtype=np.int64),
        end_eff=problem.end.copy(), identity=True)


def expand_solution(lowering: Lowering, solution):
    """Map a solution of ``lowering.lowered`` back to the original tasks:
    the identity, as every lowering of this port is one."""
    return solution
