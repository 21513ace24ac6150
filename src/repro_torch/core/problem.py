"""TL-Rightsizing problem definition (paper §II), ported from
``repro.core.problem`` (numpy, unchanged in substance).

An instance consists of ``n`` tasks, each with a ``D``-dimensional demand
vector and an active interval ``[start, end]`` (inclusive, 0-based) on a
discrete timeline of ``T`` slots, plus ``m`` node-types with capacity
vectors and prices.  A feasible solution purchases nodes (replicas of
node-types) and places every task on a node such that at every timeslot and
along every dimension the aggregate demand of active co-located tasks does
not exceed the node capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "NodeTypes",
    "Problem",
    "trim_timeline",
    "active_mask",
    "feasible_types",
    "require_lowered",
]


@dataclasses.dataclass(frozen=True)
class NodeTypes:
    """The catalogue of purchasable node-types.

    cap:  (m, D) capacities, cap[B, d] > 0.
    cost: (m,)   prices, cost[B] > 0.
    names: optional display names.
    """

    cap: np.ndarray
    cost: np.ndarray
    names: tuple[str, ...] = ()

    def __post_init__(self):
        cap = np.asarray(self.cap, dtype=np.float64)
        cost = np.asarray(self.cost, dtype=np.float64)
        object.__setattr__(self, "cap", cap)
        object.__setattr__(self, "cost", cost)
        if cap.ndim != 2:
            raise ValueError(f"cap must be (m, D), got {cap.shape}")
        if cost.shape != (cap.shape[0],):
            raise ValueError(f"cost must be (m,), got {cost.shape}")
        if not (cap > 0).all():
            raise ValueError("all capacities must be positive")
        if not (cost > 0).all():
            raise ValueError("all costs must be positive")
        if not self.names:
            object.__setattr__(
                self, "names", tuple(f"type{i}" for i in range(cap.shape[0]))
            )

    @property
    def m(self) -> int:
        return self.cap.shape[0]

    @property
    def D(self) -> int:
        return self.cap.shape[1]

    def capacity_per_cost(self) -> np.ndarray:
        """sum_d cap(B, d) / cost(B) — the cross-fill ordering key (§V-D)."""
        return self.cap.sum(axis=1) / self.cost


@dataclasses.dataclass(frozen=True)
class Problem:
    """A TL-Rightsizing instance.

    dem:   (n, D) demands, dem[u, d] >= 0.
    start: (n,)   0-based inclusive start slots.
    end:   (n,)   0-based inclusive end slots, end >= start.
    node_types: the catalogue.
    T: number of timeslots (end < T).
    constraints: optional ``repro_torch.core.constraints.TaskConstraints``
        (deadlines, affinity groups, exclusivity, malleable width).
        The LP/placement stack consumes only *lowered* instances —
        ``lower_constraints`` turns a constrained Problem into a plain
        one; ``require_lowered`` guards the solver entry points.
    """

    dem: np.ndarray
    start: np.ndarray
    end: np.ndarray
    node_types: NodeTypes
    T: int
    constraints: object | None = None

    def __post_init__(self):
        dem = np.asarray(self.dem, dtype=np.float64)
        start = np.asarray(self.start, dtype=np.int64)
        end = np.asarray(self.end, dtype=np.int64)
        object.__setattr__(self, "dem", dem)
        object.__setattr__(self, "start", start)
        object.__setattr__(self, "end", end)
        n = dem.shape[0]
        if dem.ndim != 2 or dem.shape[1] != self.node_types.D:
            raise ValueError(
                f"dem must be (n, {self.node_types.D}), got {dem.shape}"
            )
        if start.shape != (n,) or end.shape != (n,):
            raise ValueError("start/end must be (n,)")
        if n and ((start < 0).any() or (end >= self.T).any()):
            raise ValueError("spans must lie in [0, T)")
        if n and (end < start).any():
            raise ValueError("end must be >= start")
        if (dem < 0).any():
            raise ValueError("demands must be non-negative")
        if self.constraints is not None and self.constraints.n != n:
            raise ValueError(
                f"constraints cover {self.constraints.n} tasks but the "
                f"instance has {n}"
            )

    @property
    def n(self) -> int:
        return self.dem.shape[0]

    @property
    def m(self) -> int:
        return self.node_types.m

    @property
    def D(self) -> int:
        return self.node_types.D

    def spans(self) -> np.ndarray:
        return np.stack([self.start, self.end], axis=1)


def feasible_types(problem: Problem) -> np.ndarray:
    """(n, m) bool: task u fits an *empty* node of type B along every
    dimension.  Mappings must only use feasible pairs; an instance where
    some task fits no type at all has no feasible solution."""
    ok = (
        problem.dem[:, None, :] <= problem.node_types.cap[None, :, :] + 1e-12
    ).all(axis=2)
    bad = ~ok.any(axis=1)
    if bad.any():
        raise ValueError(
            f"infeasible instance: tasks {np.flatnonzero(bad)[:5]}... fit no node-type"
        )
    return ok


def active_mask(problem: Problem, slots: Sequence[int] | None = None) -> np.ndarray:
    """Boolean (n, |slots|) mask: task u active at slot t (paper's ``u ~ t``)."""
    t = np.arange(problem.T) if slots is None else np.asarray(slots)
    return (problem.start[:, None] <= t[None, :]) & (t[None, :] <= problem.end[:, None])


def require_lowered(problem: Problem, where: str) -> None:
    """Reject instances carrying *active* constraints (``ValueError``).

    The LP and placement stack understands only plain instances; a
    constrained ``Problem`` must go through ``lower_constraints`` first
    (the public entry points — ``rightsize``, ``evaluate``,
    ``FleetEngine`` — all do).  Vacuous constraints are harmless and pass
    through.
    """
    c = problem.constraints
    if c is not None and not c.is_vacuous():
        raise ValueError(
            f"{where} received a Problem with active constraints; lower "
            f"it first with lower_constraints (the rightsize/evaluate/"
            f"FleetEngine entry points do this automatically)"
        )


def trim_timeline(problem: Problem) -> tuple[Problem, np.ndarray]:
    """Timeline trimming (paper §II): keep only task start slots.

    Congestion on a node can only increase at a task start, so checking
    capacity at start slots is equivalent to checking everywhere.  Returns
    the trimmed problem (T' <= n slots) and the array of original slot ids
    (one per trimmed slot) for mapping back.

    Task spans are remapped to trimmed coordinates: the new start is the
    rank of the old start (which is always a kept slot) and the new end is
    the rank of the last kept slot <= old end.

    Active constraints must be lowered before trimming (ValueError
    otherwise); vacuous constraints are silently dropped — the trimmed
    instance is plain either way.
    """
    require_lowered(problem, "trim_timeline")
    if problem.n == 0:
        return problem, np.zeros(0, dtype=np.int64)
    kept = np.unique(problem.start)
    # rank of each original start slot
    new_start = np.searchsorted(kept, problem.start)
    # last kept slot <= end  ->  searchsorted(side='right') - 1
    new_end = np.searchsorted(kept, problem.end, side="right") - 1
    # every task is active at its own start, so new_end >= new_start always
    trimmed = Problem(
        dem=problem.dem,
        start=new_start,
        end=new_end,
        node_types=problem.node_types,
        T=len(kept),
    )
    return trimmed, kept
