"""TL-Rightsizing core, ported to PyTorch (mirrors ``repro.core``).

Public API of this slice:
    Problem, NodeTypes, Solution        — data model (numpy)
    rightsize, evaluate                 — single-instance solve / §VI protocol
    FleetEngine, SolverConfig,
    PlacementConfig, SweepConfig        — typed-config fleet session API
    FleetResult, PackPlan, plan_buckets — structured results + bucketing
    solve_lp_many, pack_problems,
    solve_lp_sweep                      — batched PDHG LP engine (legacy and
                                          tolerance mode), warm sweeps
    place_many                          — lockstep placement engine
    two_phase, TypePool                 — per-instance placement engine
    penalty_map, lp_map, solve_lp       — mapping strategies
    concentration_rounding              — congestion-aware LP rounding
    lp_lowerbound, congestion_lowerbound,
    no_timeline_lowerbound              — lower bounds on cost(opt)
"""

from .problem import (
    Problem,
    NodeTypes,
    trim_timeline,
    active_mask,
    feasible_types,
    require_lowered,
)
from .constraints import Lowering, lower_constraints, expand_solution
from .solution import Solution, verify, EPS
from .penalty import penalty_map, penalty_matrix, relative_demand, min_penalty
from .placement import two_phase, TypePool, FIT_POLICIES
from .lp_map import solve_lp, lp_map, LPResult
from .lowerbound import (
    lp_lowerbound,
    congestion_lowerbound,
    no_timeline_lowerbound,
)
from .api import rightsize, evaluate, ALGORITHMS, EXTENDED_ALGORITHMS
from .local_search import eliminate_nodes
from .rounding import concentration_rounding
from .lp_pdhg import solve_lp_pdhg, PDHGResult, PDHGState, SolveStats
from .batch import (ProblemBatch, pack_problems, solve_lp_many,
                    solve_lp_sweep, dispatch_count)
from .place_batch import place_many
from .engine import (
    Bucket,
    FleetEngine,
    FleetResult,
    PackPlan,
    PlacementConfig,
    SolverConfig,
    SweepConfig,
    plan_buckets,
)

__all__ = [
    "Problem", "NodeTypes", "Solution", "trim_timeline", "active_mask",
    "feasible_types", "require_lowered", "verify", "EPS",
    "penalty_map", "penalty_matrix", "relative_demand", "min_penalty",
    "two_phase", "TypePool", "FIT_POLICIES", "solve_lp", "lp_map",
    "LPResult", "lp_lowerbound", "congestion_lowerbound",
    "no_timeline_lowerbound", "rightsize", "evaluate", "ALGORITHMS",
    "EXTENDED_ALGORITHMS", "eliminate_nodes", "concentration_rounding",
    "solve_lp_pdhg", "PDHGResult", "PDHGState",
    "SolveStats", "ProblemBatch", "pack_problems", "solve_lp_many",
    "solve_lp_sweep", "dispatch_count", "place_many",
    "Bucket", "FleetEngine", "FleetResult", "PackPlan", "PlacementConfig",
    "SolverConfig", "SweepConfig", "plan_buckets", "Lowering",
    "lower_constraints", "expand_solution",
]
