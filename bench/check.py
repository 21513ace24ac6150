"""The comparisons that decide ``correct``: each number compared with the
reference's, beside its limit."""

from __future__ import annotations

import numpy as np

from .gen import Instance
from .reference import lp as rlp
from .reference.place import overload


def lp_numbers(inst: Instance, x: np.ndarray, y: np.ndarray,
               lb: float) -> dict:
    """The mapping LP's numbers for one trimmed instance, from the primal
    x, the dual y (cropped to the instance) and the lower bound the program
    returned:

    * ``lp_cert``: how far the lower bound lies above the bound its own
      dual certifies, in units of that dual's float32 rounding slack;
    * ``lp_gap``: the normalized gap (F(x) - lb) / (1 + |F| + |lb|) that
      the solver's tolerance bounds.
    """
    g, slack = rlp.dual_bound(inst, y)
    f = rlp.primal_bound(inst, x)
    return {"lp_cert": (lb - g) / slack,
            "lp_gap": (f - lb) / (1.0 + abs(f) + abs(lb))}


def plan_numbers(inst: Instance, got: dict, want: dict) -> dict:
    """The placement's numbers for one trimmed instance, from its passes
    (``{algo: [(node types bought, node of every task, ...), ...]}`` in the
    protocol's order) as the program made them and as the reference makes
    them:

    * ``plan_err``: 1 where any pass bought other nodes, in another order,
      or put a task on another node, else 0;
    * ``overload``: the largest load above capacity of any of the
      program's plans over every node, slot and dimension.
    """
    same = got.keys() == want.keys() and all(
        len(got[a]) == len(want[a]) and all(
            np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
            for g, w in zip(got[a], want[a])) for a in want)
    return {"plan_err": 0.0 if same else 1.0,
            "overload": max(overload(inst, g[0], g[1])
                            for p in got.values() for g in p)}


def rel_err(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}).  A number
    that was not read, or reads NaN, fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit}
        ok = ok and bool(value <= limit)
    return ok, out


def worst(rows: list[dict]) -> dict:
    """Per number, the largest reading over the sampled answers."""
    names = {k for r in rows for k in r}
    return {k: max(r[k] for r in rows if k in r) for k in sorted(names)}
