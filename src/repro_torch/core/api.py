"""High-level TL-Rightsizing API: single-instance calls.

``rightsize(problem, algo)`` runs one named algorithm; ``evaluate(problem)``
reproduces the paper's §VI protocol:

  * PenaltyMap    — min cost over {h_avg, h_max} x {first, similarity}
  * PenaltyMap-F  — same four combos with cross-node-type filling
  * LP-map        — LP mapping, min over {first, similarity}
  * LP-map-F      — LP mapping + filling, min over {first, similarity}

The fleet-scale surface is ``core.engine.FleetEngine``.  All problems are
timeline-trimmed internally; solutions are expressed (and verified) in
trimmed coordinates, which keeps feasibility and cost exactly (paper §II).
``device`` (None = the CUDA card) is where the PDHG solver runs and where
``backend='kernel'`` scores placements.
"""

from __future__ import annotations

import time

from ..device import resolve_device
from .constraints import expand_solution, lower_constraints
from .lp_map import solve_lp as _solve_lp
from .penalty import penalty_map
from .placement import FIT_POLICIES, two_phase
from .problem import Problem, trim_timeline
from .solution import Solution, verify

__all__ = ["rightsize", "evaluate", "ALGORITHMS", "EXTENDED_ALGORITHMS"]

ALGORITHMS = ("penalty-map", "penalty-map-f", "lp-map", "lp-map-f")
# beyond-paper: any algorithm + node-elimination local search ("+ls")
EXTENDED_ALGORITHMS = ALGORITHMS + ("lp-map-f+ls", "penalty-map-f+ls")


def _penalty_solutions(problem: Problem, filling: bool, backend: str,
                       device):
    for kind in ("avg", "max"):
        mapping = penalty_map(problem, kind)
        for fit in FIT_POLICIES:
            yield two_phase(
                problem, mapping, fit=fit, filling=filling, backend=backend,
                meta={"algo": "penalty-map" + ("-f" if filling else ""),
                      "h": kind}, device=device,
            )


def _lp_solutions(problem: Problem, filling: bool, backend: str, device,
                  lp_result=None):
    res = lp_result if lp_result is not None else _solve_lp(problem)
    for fit in FIT_POLICIES:
        yield two_phase(
            problem, res.mapping, fit=fit, filling=filling, backend=backend,
            meta={"algo": "lp-map" + ("-f" if filling else ""),
                  "lp_objective": res.objective}, device=device,
        )


def rightsize(problem: Problem, algo: str = "lp-map-f",
              backend: str = "numpy", check: bool = True, lp_result=None,
              device=None) -> Solution:
    """Solve one instance with one algorithm, taking the best fit policy
    (and, for PenaltyMap, the best relative-demand kind) per the paper.

    ``lp_result`` supplies the LP mapping (a ``PDHGResult`` or
    ``LPResult``); without it the LP algorithms solve the LP exactly with
    HiGHS.  Instances with active constraints raise
    ``NotImplementedError`` (ROADMAP Queue 1, item 8)."""
    dev = resolve_device(device)
    low = lower_constraints(problem)
    trimmed, _ = trim_timeline(low.lowered)
    t0 = time.perf_counter()
    local_search = algo.endswith("+ls")
    if local_search:
        algo = algo[: -len("+ls")]
    if algo == "penalty-map":
        sols = _penalty_solutions(trimmed, False, backend, dev)
    elif algo == "penalty-map-f":
        sols = _penalty_solutions(trimmed, True, backend, dev)
    elif algo == "lp-map":
        sols = _lp_solutions(trimmed, False, backend, dev, lp_result)
    elif algo == "lp-map-f":
        sols = _lp_solutions(trimmed, True, backend, dev, lp_result)
    else:
        raise ValueError(f"unknown algo {algo!r}; want one of {ALGORITHMS}")
    best = min(sols, key=lambda s: s.cost(trimmed))
    if local_search:
        from .local_search import eliminate_nodes

        best = eliminate_nodes(trimmed, best)
    best.meta["wall_s"] = time.perf_counter() - t0
    if check:
        verify(trimmed, best)
    return expand_solution(low, best)


def _solve_lp_for(problem: Problem, lp_solver: str, lp_iters: int, device,
                  lp_tol: float | None = None):
    """(lp_result, certified lower bound) for one instance."""
    if lp_solver == "highs":
        res = _solve_lp(problem)
        return res, res.objective
    if lp_solver == "pdhg":
        from .lp_pdhg import solve_lp_pdhg

        res = solve_lp_pdhg(problem, iters=lp_iters, tol=lp_tol,
                            device=device)
        return res, res.lower_bound
    raise ValueError(f"unknown lp_solver {lp_solver!r}; want 'highs'|'pdhg'")


def _protocol_entry(trimmed: Problem, lp_result, lb: float, algos,
                    backend: str, device) -> dict:
    out: dict = {"lb": lb, "costs": {}, "normalized": {}, "wall_s": {}}
    for algo in algos:
        sol = rightsize(trimmed, algo, backend=backend, lp_result=lp_result,
                        device=device)
        cost = sol.cost(trimmed)
        out["costs"][algo] = cost
        out["normalized"][algo] = cost / max(lb, 1e-12)
        out["wall_s"][algo] = sol.meta["wall_s"]
    return out


def evaluate(problem: Problem, algos=ALGORITHMS, backend: str = "numpy",
             lp_solver: str = "highs", lp_iters: int = 2000,
             lp_tol: float | None = None, device=None) -> dict:
    """Paper §VI protocol: per-algorithm best cost + the LP lower bound.

    ``lp_solver='highs'`` solves the mapping LP exactly (the paper's
    setup); ``'pdhg'`` runs the PDHG solver on ``device`` and normalizes
    by its certified dual lower bound.  ``lp_tol`` switches that solve to
    tolerance stopping (the adaptive restarted engine; ``lp_iters`` caps
    the worst case).

    Returns {'lb', 'costs': {algo: cost}, 'normalized': {algo: cost/lb},
    'wall_s': {algo: s}}.
    """
    dev = resolve_device(device)
    low = lower_constraints(problem)
    trimmed, _ = trim_timeline(low.lowered)
    lp_result, lb = _solve_lp_for(trimmed, lp_solver, lp_iters, dev, lp_tol)
    return _protocol_entry(trimmed, lp_result, lb, algos, backend, dev)
