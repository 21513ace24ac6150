"""Synthetic benchmark generator (paper §VI-A, Table I).

Each of the D components of demand and capacity is uniform i.i.d. in its
interval; each task's span [s, e] is uniform over [1, T] (we draw two
uniform slots and order them).  Defaults follow Table I:

    n=1000, m=10, T=24, D=5, capacity ~ U[0.2, 1.0], demand ~ U[0.01, 0.1].
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from ..core.problem import NodeTypes, Problem
from .cost_models import heterogeneous_cost, homogeneous_cost

__all__ = ["SyntheticSpec", "synthetic_instance", "sweep_specs",
           "synthetic_batch"]


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    n: int = 1000
    m: int = 10
    D: int = 5
    T: int = 24
    demand: tuple[float, float] = (0.01, 0.1)
    capacity: tuple[float, float] = (0.2, 1.0)
    cost_model: str = "homogeneous"  # 'homogeneous' | 'heterogeneous'
    e: float = 1.0                   # heterogeneous cost exponent
    seed: int = 0


def synthetic_instance(spec: SyntheticSpec = SyntheticSpec(),
                       rng: np.random.Generator | None = None) -> Problem:
    """Draw one Table-I instance from ``spec``.

    Bit-reproducible seed plumbing: every draw (capacities, the
    heterogeneous cost coefficients, demands, spans) comes from ONE
    explicit generator — ``rng`` when given, else a fresh
    ``np.random.default_rng(spec.seed)`` — so the same spec always
    yields the same instance and global NumPy state is never touched.
    Pass ``rng`` to draw several instances from one stream.
    """
    if rng is None:
        rng = np.random.default_rng(spec.seed)
    cap = rng.uniform(*spec.capacity, size=(spec.m, spec.D))
    if spec.cost_model == "homogeneous":
        cost = homogeneous_cost(cap)
    elif spec.cost_model == "heterogeneous":
        cost = heterogeneous_cost(cap, e=spec.e, rng=rng)
    else:
        raise ValueError(f"unknown cost model {spec.cost_model!r}")
    dem = rng.uniform(*spec.demand, size=(spec.n, spec.D))
    a = rng.integers(0, spec.T, size=spec.n)
    b = rng.integers(0, spec.T, size=spec.n)
    start, end = np.minimum(a, b), np.maximum(a, b)
    return Problem(
        dem=dem, start=start, end=end,
        node_types=NodeTypes(cap=cap, cost=cost), T=spec.T,
    )


def sweep_specs(base: SyntheticSpec = SyntheticSpec(), seeds: int = 1,
                **axes) -> list[SyntheticSpec]:
    """Cartesian sweep grid over spec fields x seeds (paper Table I).

    Each keyword names a ``SyntheticSpec`` field and gives the values to
    sweep; every combination is replicated over ``seeds`` consecutive
    seeds.  The grid order is row-major over the axes (in keyword order)
    with the seed innermost, e.g.::

        sweep_specs(SyntheticSpec(n=200), seeds=2, D=(2, 5, 7))

    yields 6 specs: (D=2, s=0), (D=2, s=1), (D=5, s=0), ...
    """
    for name in axes:
        if not any(f.name == name for f in dataclasses.fields(base)):
            raise ValueError(f"unknown SyntheticSpec field {name!r}")
    out = []
    for combo in itertools.product(*axes.values()):
        overrides = dict(zip(axes.keys(), combo))
        for s in range(seeds):
            out.append(dataclasses.replace(base, seed=s, **overrides))
    return out


def synthetic_batch(specs) -> list[Problem]:
    """Instantiate a sweep grid — the input to ``core.FleetEngine.evaluate`` /
    ``core.solve_lp_many`` (one batched LP solve for the whole grid)."""
    return [synthetic_instance(spec) for spec in specs]
