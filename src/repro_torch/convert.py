"""Carry instances and solver state into the port.

``problem_from_arrays`` builds the port's ``Problem`` from plain arrays, or
from any object that has them as attributes (``dem``, ``start``, ``end``,
``T`` and ``node_types.cap``/``node_types.cost``, such as a reference
``repro.core.Problem``), without importing the reference package.
``state_from_numpy`` builds a ``PDHGState`` from numpy iterates.  The tests
use both to feed identical instances and iterates to the reference and to
the port.
"""

from __future__ import annotations

import numpy as np

from .core.lp_pdhg import PDHGState
from .core.problem import NodeTypes, Problem

__all__ = ["problem_from_arrays", "state_from_numpy"]


def problem_from_arrays(dem, start=None, end=None, cap=None, cost=None,
                        T=None) -> Problem:
    """The port's ``Problem`` for (n, D) ``dem``, (n,) ``start``/``end``,
    (m, D) ``cap``, (m,) ``cost`` and ``T`` slots.

    When ``dem`` is an object with those attributes (a problem of another
    package), the other arguments are read from it.  Its constraints are
    carried over only when absent or vacuous; active ones raise
    ``NotImplementedError``, as the port cannot solve them yet.
    """
    if hasattr(dem, "node_types"):
        src = dem
        constraints = getattr(src, "constraints", None)
        if constraints is not None and not constraints.is_vacuous():
            raise NotImplementedError(
                "instances with active constraints are not ported yet "
                "(ROADMAP Queue 1, item 8)")
        names = tuple(getattr(src.node_types, "names", ()))
        return Problem(
            dem=np.array(src.dem, np.float64),
            start=np.array(src.start, np.int64),
            end=np.array(src.end, np.int64),
            node_types=NodeTypes(cap=np.array(src.node_types.cap, np.float64),
                                 cost=np.array(src.node_types.cost,
                                               np.float64),
                                 names=names),
            T=int(src.T))
    return Problem(dem=np.array(dem, np.float64),
                   start=np.array(start, np.int64),
                   end=np.array(end, np.int64),
                   node_types=NodeTypes(cap=np.array(cap, np.float64),
                                        cost=np.array(cost, np.float64)),
                   T=int(T))


def state_from_numpy(x, y, eta=None, omega=None) -> PDHGState:
    """``PDHGState`` from (B, n, m) primal and (B, T', m, D) dual iterates
    (stored as float32, the solver's iterate type)."""
    return PDHGState(
        x=np.asarray(x, np.float32), y=np.asarray(y, np.float32),
        eta=None if eta is None else np.asarray(eta, np.float32),
        omega=None if omega is None else np.asarray(omega, np.float32))
