"""The paper's §VI protocol for one trimmed instance: every algorithm's
placement passes and its cheapest plan over its mappings and both fit
policies.

``penalty-map`` maps by the avg and max penalties, ``lp-map`` by the
rounding of an LP primal; the ``-f`` variants place with cross-fill.  Of
an algorithm's passes (mappings outer, fits inner) the first strictly
cheapest plan is kept.
"""

from __future__ import annotations

import numpy as np

from ..gen import Instance
from .instance import penalty_map
from .lp import rounding
from .place import FITS, place, plan_cost

ALGORITHMS = ("penalty-map", "penalty-map-f", "lp-map", "lp-map-f")


def passes(inst: Instance, x: np.ndarray | None, algos=ALGORITHMS,
           dtype=np.float64) -> dict:
    """{algo: [(node types bought, node of every task, price), ...]}, one
    entry per placement pass in the protocol's order; ``x`` is the LP
    primal the lp-map algorithms round."""
    out = {}
    for algo in algos:
        if algo.startswith("penalty-map"):
            maps = [penalty_map(inst, kind) for kind in ("avg", "max")]
        else:
            maps = [rounding(inst, x)]
        out[algo] = []
        for mapping in maps:
            for fit in FITS:
                bought, assign = place(inst, mapping, fit,
                                       algo.endswith("-f"), dtype)
                out[algo].append((bought, assign,
                                  plan_cost(inst, bought, dtype)))
    return out


def best(inst: Instance, plans: list) -> tuple[float, np.ndarray]:
    """(price, node counts per type) of the first strictly cheapest of an
    algorithm's passes."""
    top = (np.inf, None)
    for bought, _, c in plans:
        if c < top[0]:
            top = (c, np.bincount(bought, minlength=inst.m))
    return top


def best_plans(inst: Instance, x: np.ndarray | None, algos=ALGORITHMS,
               dtype=np.float64) -> dict:
    """{algo: (cost, node counts per type)} of the cheapest plan of each
    algorithm."""
    return {a: best(inst, p) for a, p in passes(inst, x, algos,
                                                 dtype).items()}
