"""High-level TL-Rightsizing API: single-instance calls + the legacy shim.

``rightsize(problem, algo)`` runs one named algorithm; ``evaluate(problem)``
reproduces the paper's §VI protocol:

  * PenaltyMap    — min cost over {h_avg, h_max} x {first, similarity}
  * PenaltyMap-F  — same four combos with cross-node-type filling
  * LP-map        — LP mapping, min over {first, similarity}
  * LP-map-F      — LP mapping + filling, min over {first, similarity}

The fleet-scale surface is ``core.engine.FleetEngine``; ``evaluate_many``
here is the deprecated kwarg shim over it, which maps the legacy keyword
arguments onto the typed configs one-to-one, always runs single-bucket and
returns the legacy list of entry dicts.  All problems are timeline-trimmed
internally; solutions are expressed (and verified) in trimmed coordinates,
which keeps feasibility and cost exactly (paper §II).  ``device`` (None =
the CUDA card) is where the PDHG solver runs and where ``backend='kernel'``
scores placements.
"""

from __future__ import annotations

import time
import warnings

from ..device import resolve_device
from .constraints import expand_solution, lower_constraints
from .lp_map import solve_lp as _solve_lp
from .penalty import penalty_map
from .placement import FIT_POLICIES, two_phase
from .problem import Problem, trim_timeline
from .solution import Solution, verify

__all__ = ["rightsize", "evaluate", "evaluate_many", "ALGORITHMS",
           "EXTENDED_ALGORITHMS"]

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
    ``LPResult``, of the lowered instance); without it the LP algorithms
    solve the LP exactly with HiGHS.

    Constrained instances (``problem.constraints``) are lowered first
    (``core.constraints``); the returned solution is expanded back to
    original task rows, and under ``check=True`` it is also validated
    against the ORIGINAL constraint semantics by the independent
    ``core.checker`` oracle."""
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
    best = expand_solution(low, best)
    if check and not low.identity:
        from .checker import assert_feasible

        assert_feasible(problem, best)
    return best


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

    Constrained instances are lowered first; costs (and the lower bound)
    are those of the lowered instance, whose affinity rows reserve
    peak-over-hull demand — a conservative relaxation, so the reported
    ``lb`` may exceed the true constrained optimum's LP bound.
    """
    dev = resolve_device(device)
    low = lower_constraints(problem)
    trimmed, _ = trim_timeline(low.lowered)
    lp_result, lb = _solve_lp_for(trimmed, lp_solver, lp_iters, dev, lp_tol)
    return _protocol_entry(trimmed, lp_result, lb, algos, backend, dev)


_UNSET = object()  # sentinel: distinguishes "kwarg passed" from default

# legacy kwarg -> the typed-config equivalent named in the deprecation
# warning (behavior is bit-stable either way; only the spelling moves)
_LEGACY_KWARGS = {
    "backend": "PlacementConfig(backend=...)",
    "lp_iters": "SolverConfig(iters=...)",
    "operator": "SolverConfig(operator=...)",
    "placement": "PlacementConfig(engine=...)",
    "lp_tol": "SolverConfig(tol=...)",
    "lp_adaptive": "SolverConfig(adaptive=...)",
    "lp_restart": "SolverConfig(restart=...)",
    "warm_start": "SweepConfig(warm_start=...)",
    "return_stats": "FleetEngine.evaluate(...).stats on the FleetResult",
}

_LEGACY_DEFAULTS = {
    "backend": "numpy", "lp_iters": 2000, "operator": "auto",
    "placement": "batched", "lp_tol": None, "lp_adaptive": True,
    "lp_restart": True, "warm_start": None, "return_stats": False,
}


def evaluate_many(problems, algos=ALGORITHMS, backend=_UNSET,
                  lp_iters=_UNSET, operator=_UNSET, placement=_UNSET,
                  lp_tol=_UNSET, lp_adaptive=_UNSET, lp_restart=_UNSET,
                  warm_start=_UNSET, return_stats=_UNSET, device=None):
    """§VI protocol over a grid of instances, batched: the **legacy kwarg
    shim** over ``core.engine.FleetEngine`` on ``device`` (None = the CUDA
    card, ``"cpu"`` on request).

    .. deprecated::
        Passing any of the legacy keywords emits a ``DeprecationWarning``
        naming its typed-config equivalent (``SolverConfig`` /
        ``PlacementConfig`` / ``SweepConfig``); only the spelling moves to
        ``FleetEngine``.  ``device`` is not a legacy keyword and warns
        nothing.

    ``lp_iters/operator/lp_tol/lp_adaptive/lp_restart`` map onto
    ``SolverConfig``, ``placement/backend`` onto ``PlacementConfig`` and
    ``warm_start`` onto ``SweepConfig``; the shim always runs single-bucket
    (``SweepConfig``'s default ``max_buckets=1``).  ``lp_tol=None`` keeps the
    fixed-``lp_iters`` solve; with ``lp_tol`` each entry carries a
    ``'solver'`` telemetry dict.  ``warm_start=k`` chains the grid's
    consecutive groups of k (it requires ``lp_tol``; a non-positive k raises
    ``ValueError``).  ``return_stats=True`` also returns the ``SolveStats``
    list, one per batched solve or warm-started group.

    >>> from repro_torch.workload import SyntheticSpec, synthetic_instance
    >>> grid = [synthetic_instance(SyntheticSpec(n=8, m=2, D=2, T=5,
    ...                                          seed=s))
    ...         for s in (0, 1)]
    >>> entries = evaluate_many(grid, algos=("penalty-map",), device="cpu")
    >>> sorted(entries[0])
    ['costs', 'lb', 'normalized', 'wall_s']
    >>> list(entries[1]["costs"])
    ['penalty-map']
    """
    from .engine import (FleetEngine, PlacementConfig, SolverConfig,
                         SweepConfig)

    passed = {name: val for name, val in [
        ("backend", backend), ("lp_iters", lp_iters),
        ("operator", operator), ("placement", placement),
        ("lp_tol", lp_tol), ("lp_adaptive", lp_adaptive),
        ("lp_restart", lp_restart), ("warm_start", warm_start),
        ("return_stats", return_stats)] if val is not _UNSET}
    if passed:
        hints = "; ".join(f"{k} -> {_LEGACY_KWARGS[k]}" for k in passed)
        warnings.warn(
            f"the evaluate_many kwarg surface is deprecated; build a "
            f"FleetEngine with the typed configs instead ({hints})",
            DeprecationWarning, stacklevel=2)
    resolved = dict(_LEGACY_DEFAULTS, **passed)
    sweep = SweepConfig(warm_start=resolved["warm_start"])  # rejects k <= 0
    if resolved["warm_start"] is not None and resolved["lp_tol"] is None:
        raise ValueError("warm_start requires lp_tol (tolerance-stopped "
                         "solves); fixed-iteration solves gain nothing "
                         "from a warm start")
    engine = FleetEngine(
        solver=SolverConfig(tol=resolved["lp_tol"],
                            iters=resolved["lp_iters"],
                            adaptive=resolved["lp_adaptive"],
                            restart=resolved["lp_restart"],
                            operator=resolved["operator"]),
        placement=PlacementConfig(engine=resolved["placement"],
                                  backend=resolved["backend"]),
        sweep=sweep, algos=algos, device=resolve_device(device))
    result = engine.evaluate(problems)
    if resolved["return_stats"]:
        return result.entries, result.stats
    return result.entries
