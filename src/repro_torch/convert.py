"""Carry instances and solver state into the port.

``problem_from_arrays`` builds the port's ``Problem`` from plain arrays, or
from any object that has them as attributes (``dem``, ``start``, ``end``,
``T``, ``node_types.cap``/``node_types.cost`` and optional ``constraints``,
such as a reference ``repro.core.Problem``), without importing the reference
package; constraints come across as the port's own ``TaskConstraints``.
``state_from_numpy`` builds a ``PDHGState`` from numpy iterates.  The tests
use both to feed identical instances and iterates to the reference and to
the port.

A live serving loop needs no helper here: ``serve.snapshot`` reads and
writes the reference's snapshot format (the same manifest, arrays, version
and checksum), so a reference ``RightsizingService.snapshot(path)`` restores
in the port with ``repro_torch.serve.RightsizingService.restore(path)``,
warm states bit for bit, and the other way round.
"""

from __future__ import annotations

import numpy as np

from .core.constraints import TaskConstraints
from .core.lp_pdhg import PDHGState
from .core.problem import NodeTypes, Problem

__all__ = ["problem_from_arrays", "constraints_from", "state_from_numpy"]


def problem_from_arrays(dem, start=None, end=None, cap=None, cost=None,
                        T=None) -> Problem:
    """The port's ``Problem`` for (n, D) ``dem``, (n,) ``start``/``end``,
    (m, D) ``cap``, (m,) ``cost`` and ``T`` slots.

    When ``dem`` is an object with those attributes (a problem of another
    package), the other arguments are read from it, and its constraints,
    when present, are carried across by ``constraints_from``.
    """
    if hasattr(dem, "node_types"):
        src = dem
        names = tuple(getattr(src.node_types, "names", ()))
        return Problem(
            dem=np.array(src.dem, np.float64),
            start=np.array(src.start, np.int64),
            end=np.array(src.end, np.int64),
            node_types=NodeTypes(cap=np.array(src.node_types.cap, np.float64),
                                 cost=np.array(src.node_types.cost,
                                               np.float64),
                                 names=names),
            T=int(src.T),
            constraints=constraints_from(getattr(src, "constraints", None)))
    return Problem(dem=np.array(dem, np.float64),
                   start=np.array(start, np.int64),
                   end=np.array(end, np.int64),
                   node_types=NodeTypes(cap=np.array(cap, np.float64),
                                        cost=np.array(cost, np.float64)),
                   T=int(T))


def constraints_from(c) -> TaskConstraints | None:
    """The port's ``TaskConstraints`` holding the six per-task arrays and
    the two group-name tuples of ``c`` (any object with those attributes,
    such as a reference ``repro.core.TaskConstraints``); None for None."""
    if c is None:
        return None
    return TaskConstraints(
        deadline=np.array(c.deadline, np.int64),
        affinity=np.array(c.affinity, np.int64),
        anti_affinity=np.array(c.anti_affinity, np.int64),
        exclusive=np.array(c.exclusive, bool),
        max_width=np.array(c.max_width, np.int64),
        serial_frac=np.array(c.serial_frac, np.float64),
        affinity_names=tuple(c.affinity_names),
        anti_names=tuple(c.anti_names))


def state_from_numpy(x, y, eta=None, omega=None) -> PDHGState:
    """``PDHGState`` from (B, n, m) primal and (B, T', m, D) dual iterates
    (stored as float32, the solver's iterate type)."""
    return PDHGState(
        x=np.asarray(x, np.float32), y=np.asarray(y, np.float32),
        eta=None if eta is None else np.asarray(eta, np.float32),
        omega=None if omega is None else np.asarray(omega, np.float32))
