"""CVaR fleet selection over a solved scenario fan-out.

One batched solve gives every scenario its own minimum-cost fleet
``R_s`` (node counts per type).  A *robust* fleet ``F`` must then be
chosen once, before knowing which scenario arrives.  Selection works
on two cost channels:

  * **purchase** — ``fleet_cost(F) = sum_B F[B] * cost[B]``;
  * **overload** — ``ov(s, F) = sum_B max(0, R_s[B] - F[B]) * cost[B]``,
    the cost-weighted node shortfall of running scenario ``s`` on
    ``F``: the price of the on-demand capacity you would have to rent
    (or the demand you would shed) when the scenario outgrows the
    fleet — the rent-vs-own trade of Renting Servers for
    Multi-Parameter Jobs (arXiv 2404.15444) collapsed to its
    first-order term.

The objective per candidate fleet is

    E_s[cost] + lambda * CVaR_alpha(overload) + reconfiguration

where ``E_s[cost] = fleet_cost + premium * mean_s ov(s, F)`` (the
expected bill including top-ups), ``CVaR_alpha`` is the mean of the
worst ``ceil((1-alpha) * K)`` scenario overloads (tail risk — what
expected-cost selection is blind to), and the reconfiguration term is
Eva-style (arXiv 2503.07437): ``recfg_weight * sum_B |F[B] -
current[B]| * cost[B]`` prices node churn relative to a currently
deployed fleet, so re-planning under new forecasts does not thrash.

Candidates are the per-scenario fleets, their pairwise elementwise
maxes (unions covering two scenarios at once, which per-type
quantiles cannot express), the elementwise per-type quantile chain
across scenarios (q = 0..1, inclusive of the elementwise max, which
has zero overload by construction) and the current fleet — a small
menu whose extremes bracket the cost/risk frontier.

``plan_stochastic`` is the end-to-end entry: fan out, solve all K in
ONE batched dispatch (``FleetEngine.solve_scenarios``), place, select,
and emit a structured ``StochasticResult`` with the frontier rows the
CLI and benchmarks print.

Ported from ``repro.stochastic.select``.  Selection is float64 numpy on the
host, as in the reference; the K-lane solve (``FleetEngine.solve_scenarios``)
and every placement run through the engine on its device.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from .. import obs
from ..core import (FleetEngine, SolverConfig, pack_problems,
                    trim_timeline)
from ..core.batch import dispatch_count
from ..core.lp_pdhg import SolveStats
from ..core.placement import FIT_POLICIES

from .forecast import DemandForecast
from .scenarios import ScenarioSet, fan_out

__all__ = ["StochasticConfig", "StochasticResult", "cvar",
           "candidate_fleets", "overload_costs", "plan_stochastic"]

_STOCHASTIC_ALGOS = ("lp-map", "lp-map-f", "penalty-map",
                     "penalty-map-f")


def cvar(x: np.ndarray, alpha: float) -> float:
    """Conditional value-at-risk of a discrete equal-weight sample:
    the mean of the worst ``ceil((1 - alpha) * K)`` values.

    Non-decreasing in ``alpha`` for fixed ``x`` (shrinking the
    averaged tail can only raise its mean): ``cvar(x, 0) == mean`` and
    ``cvar(x, alpha -> 1) == max``.

    >>> cvar(np.array([0.0, 1.0, 2.0, 3.0]), 0.0)
    1.5
    >>> cvar(np.array([0.0, 1.0, 2.0, 3.0]), 0.5)
    2.5
    >>> cvar(np.array([0.0, 1.0, 2.0, 3.0]), 0.9)
    3.0
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim != 1 or len(x) == 0:
        raise ValueError(f"cvar needs a non-empty 1-D sample, got "
                         f"shape {x.shape}")
    if not 0.0 <= alpha < 1.0:
        raise ValueError(f"alpha must be in [0, 1), got {alpha!r}")
    k = max(1, math.ceil((1.0 - alpha) * len(x)))
    return float(np.mean(np.sort(x)[len(x) - k:]))


@dataclasses.dataclass(frozen=True)
class StochasticConfig:
    """Stochastic-rightsizing knobs (fan-out size + CVaR objective).

    scenarios: K, the Monte-Carlo fan-out size (one batched dispatch).
    seed: fan-out seed (scenario k is a pure function of (forecast,
        seed, k) — see ``scenarios.fan_out``).
    cvar_alpha: tail level of the CVaR term (0.9 = average of the
        worst 10% of scenarios).
    cvar_lambda: weight of the CVaR term; 0 recovers expected-cost-
        only selection (the comparison column every frontier prints).
    overload_premium: price multiplier of the expected shortfall in
        the E[cost] term (renting capacity on demand costs more than
        owning it).
    recfg_weight: Eva-style reconfiguration weight on |F - current|
        node churn (0 = plan from scratch).
    quantiles: resolution of the per-type quantile candidate chain.
    algo: which mapping algorithm prices the per-scenario fleets.

    >>> StochasticConfig().cvar_alpha
    0.9
    >>> StochasticConfig(cvar_alpha=1.0)
    Traceback (most recent call last):
        ...
    ValueError: cvar_alpha must be in [0, 1), got 1.0
    """

    scenarios: int = 64
    seed: int = 0
    cvar_alpha: float = 0.9
    cvar_lambda: float = 1.0
    overload_premium: float = 3.0
    recfg_weight: float = 0.0
    quantiles: int = 9
    algo: str = "lp-map-f"
    frontier_alphas: tuple[float, ...] = (0.5, 0.75, 0.9, 0.95, 0.99)

    def __post_init__(self):
        if self.scenarios < 1:
            raise ValueError(
                f"scenarios must be >= 1, got {self.scenarios!r}")
        if not 0.0 <= self.cvar_alpha < 1.0:
            raise ValueError(
                f"cvar_alpha must be in [0, 1), got {self.cvar_alpha!r}")
        if self.cvar_lambda < 0:
            raise ValueError(
                f"cvar_lambda must be >= 0, got {self.cvar_lambda!r}")
        if self.overload_premium < 0:
            raise ValueError(
                f"overload_premium must be >= 0, got "
                f"{self.overload_premium!r}")
        if self.recfg_weight < 0:
            raise ValueError(
                f"recfg_weight must be >= 0, got {self.recfg_weight!r}")
        if self.quantiles < 2:
            raise ValueError(
                f"quantiles must be >= 2 (the chain needs both "
                f"extremes), got {self.quantiles!r}")
        if self.algo not in _STOCHASTIC_ALGOS:
            raise ValueError(
                f"algo must be one of {_STOCHASTIC_ALGOS}, got "
                f"{self.algo!r}")
        if not all(0.0 <= a < 1.0 for a in self.frontier_alphas):
            raise ValueError(
                f"frontier_alphas must all be in [0, 1), got "
                f"{self.frontier_alphas!r}")


def candidate_fleets(plans: np.ndarray, quantiles: int = 9,
                     current: np.ndarray | None = None) -> np.ndarray:
    """The candidate menu: per-scenario fleets, their pairwise
    elementwise maxes (a fleet covering scenarios s AND t exactly —
    quantiles are per-type and miss such unions), the per-type
    quantile chain (q = 0..1, elementwise, so the chain is nested:
    higher q never buys fewer nodes of any type; q = 1 is the
    zero-overload elementwise max) and the current fleet, deduped and
    sorted by purchase footprint.

    >>> plans = np.array([[1, 0], [2, 1], [4, 1]])
    >>> candidate_fleets(plans, quantiles=3).tolist()
    [[1, 0], [2, 1], [4, 1]]
    >>> candidate_fleets(np.array([[2, 0], [0, 2]]), quantiles=2).tolist()
    [[0, 0], [0, 2], [2, 0], [2, 2]]
    """
    plans = np.asarray(plans, dtype=np.int64)
    qs = np.linspace(0.0, 1.0, quantiles)
    chain = np.quantile(plans, qs, axis=0, method="higher").astype(np.int64)
    uniq = np.unique(plans, axis=0)
    pairs = np.maximum(uniq[:, None, :], uniq[None, :, :]) \
        .reshape(-1, plans.shape[1])
    rows = [tuple(r) for r in pairs] + [tuple(r) for r in chain]
    if current is not None:
        rows.append(tuple(int(v) for v in current))
    menu = sorted(set(rows), key=lambda r: (sum(r), r))
    return np.asarray(menu, dtype=np.int64)


def overload_costs(plans: np.ndarray, fleets: np.ndarray,
                   node_cost: np.ndarray) -> np.ndarray:
    """(K, J) cost-weighted node shortfall of each scenario's required
    fleet ``plans[s]`` against each candidate ``fleets[j]``."""
    short = np.maximum(plans[:, None, :] - fleets[None, :, :], 0)
    return (short * node_cost[None, None, :]).sum(axis=2)


@dataclasses.dataclass
class StochasticResult:
    """Structured output of ``plan_stochastic``.

    fleet / fleet_cost: the CVaR-selected robust fleet (node counts
        per type) and its purchase cost.
    expected_fleet / expected_fleet_cost: the lambda=0 selection (same
        premium, no tail term) — the comparison every frontier prints.
    scenario_costs: (K,) each scenario's own optimal protocol cost.
    scenario_plans: (K, m) each scenario's required node counts.
    overload / expected_overload: (K,) per-scenario shortfall cost of
        the robust / expected-only fleet.
    max_fleet_cost: purchase cost of the elementwise-max fleet (zero
        overload by construction — the robust plan's upper bracket).
    frontier: rows over (lambda=0, then the alpha grid at the
        configured lambda); the row matching the configured alpha is
        the selection.
    stats: SolveStats of the batched scenario dispatch(es);
    lp_dispatches / buckets: how many LP dispatches the K
        scenarios cost (== 1 without sharding) and the bucket count
        (== 1 by the shared-shape construction).
    """

    config: StochasticConfig
    fleet: np.ndarray
    fleet_cost: float
    expected_fleet: np.ndarray
    expected_fleet_cost: float
    scenario_costs: np.ndarray
    scenario_plans: np.ndarray
    overload: np.ndarray
    expected_overload: np.ndarray
    max_fleet_cost: float
    frontier: list[dict]
    stats: list[SolveStats]
    lp_dispatches: int
    buckets: int
    timings: dict

    @property
    def K(self) -> int:
        return len(self.scenario_costs)

    @property
    def worst_overload(self) -> float:
        return float(self.overload.max())

    @property
    def cvar_overload(self) -> float:
        return cvar(self.overload, self.config.cvar_alpha)

    def to_rows(self) -> list[dict]:
        """Flat per-scenario rows (JSON/CSV-ready)."""
        return [{
            "scenario": s,
            "cost": float(self.scenario_costs[s]),
            "plan": self.scenario_plans[s].tolist(),
            "overload_robust": float(self.overload[s]),
            "overload_expected": float(self.expected_overload[s]),
        } for s in range(self.K)]

    def summary(self) -> dict:
        """The benchmark/CI blob: deterministic numbers only (no wall
        clock), rounded to 6 decimals like the golden tables."""
        r6 = lambda v: round(float(v), 6)  # noqa: E731
        return {
            "K": self.K,
            "seed": self.config.seed,
            "cvar_alpha": self.config.cvar_alpha,
            "cvar_lambda": self.config.cvar_lambda,
            "overload_premium": self.config.overload_premium,
            "recfg_weight": self.config.recfg_weight,
            "algo": self.config.algo,
            "fleet": self.fleet.tolist(),
            "fleet_cost": r6(self.fleet_cost),
            "expected_fleet": self.expected_fleet.tolist(),
            "expected_fleet_cost": r6(self.expected_fleet_cost),
            "mean_scenario_cost": r6(self.scenario_costs.mean()),
            "worst_scenario_cost": r6(self.scenario_costs.max()),
            "max_fleet_cost": r6(self.max_fleet_cost),
            "mean_overload": r6(self.overload.mean()),
            "cvar_overload": r6(self.cvar_overload),
            "worst_overload": r6(self.worst_overload),
            "expected_fleet_worst_overload": r6(
                self.expected_overload.max()),
            "frontier": self.frontier,
            "lp_dispatches": self.lp_dispatches,
            "buckets": self.buckets,
            "converged_frac": r6(np.mean([
                float(np.mean(s.converged)) for s in self.stats])
                if self.stats else 1.0),
            "total_iters": int(sum(int(s.iterations.sum())
                                   for s in self.stats)),
        }

    def to_json(self, indent: int | None = None) -> str:
        blob = dict(self.summary())
        blob["scenarios"] = self.to_rows()
        blob["timings"] = self.timings
        return json.dumps(blob, indent=indent)


def _select(fleets: np.ndarray, ov: np.ndarray, node_cost: np.ndarray,
            alpha: float, lam: float, premium: float,
            recfg_weight: float, current: np.ndarray | None) -> int:
    """Index of the objective-minimizing candidate (deterministic
    tie-break: lower worst-case overload, then lower purchase cost,
    then lexicographic fleet)."""
    costs = (fleets * node_cost[None, :]).sum(axis=1)
    recfg = np.zeros(len(fleets))
    if current is not None and recfg_weight > 0:
        churn = np.abs(fleets - np.asarray(current)[None, :])
        recfg = recfg_weight * (churn * node_cost[None, :]).sum(axis=1)
    obj = costs + premium * ov.mean(axis=0) + recfg
    if lam > 0:
        obj = obj + lam * np.array(
            [cvar(ov[:, j], alpha) for j in range(len(fleets))])
    keys = [(float(obj[j]), float(ov[:, j].max()), float(costs[j]),
             tuple(fleets[j])) for j in range(len(fleets))]
    return min(range(len(fleets)), key=keys.__getitem__)


def plan_stochastic(forecast: DemandForecast | ScenarioSet,
                    config: StochasticConfig = StochasticConfig(),
                    engine: FleetEngine | None = None,
                    current_fleet: np.ndarray | None = None,
                    device=None) -> StochasticResult:
    """Forecast -> fan-out -> ONE batched solve -> CVaR selection.

    ``forecast`` may be a ``DemandForecast`` (fanned out here with
    ``config.scenarios``/``config.seed``) or a pre-built
    ``ScenarioSet`` (reuse one fan-out across configs).  ``engine``
    defaults to a tolerance-stopped ``FleetEngine``; a passed engine
    must not configure warm-started sweeps (``solve_scenarios``
    rejects that).  ``current_fleet`` activates the Eva-style
    reconfiguration term of ``config.recfg_weight``.  ``device`` (None =
    the CUDA card) places the default engine only; a passed engine keeps
    its own.

    The result's ``timings`` are host-clock seconds of the whole plan, in
    order: ``fanout_s`` (the fan-out), ``lp_s`` (the scenarios' one LP
    dispatch, trimming and packing included), ``place_s`` (trimming,
    packing and the placement passes) and ``select_s`` (the candidate
    menu, the overloads, every selection and frontier row).  Under a
    ``torch.profiler`` session the call is one ``plan`` step of
    ``repro_torch.obs``.
    """
    with obs.span("plan"):
        return _plan(forecast, config, engine, current_fleet, device)


def _plan(forecast, config, engine, current_fleet, device):
    """``plan_stochastic``'s body, inside its ``plan`` step."""
    timings: dict = {}
    with obs.timed("fanout", timings, "fanout_s", host=True):
        scenario_set = forecast if isinstance(forecast, ScenarioSet) \
            else fan_out(forecast, config.scenarios, config.seed)
    problems = list(scenario_set.problems)
    base = scenario_set.forecast.base
    node_cost = base.node_types.cost
    if engine is None:
        engine = FleetEngine(solver=SolverConfig(tol=5e-3, iters=4000),
                             algos=(config.algo,), device=device)

    d0 = dispatch_count()
    with obs.timed("lp", timings, "lp_s"):
        lp_results, stats = engine.solve_scenarios(problems)
    lp_dispatches = dispatch_count() - d0

    # one lockstep placement pass per fit policy over the shared-shape
    # batch; each scenario keeps its own cheapest feasible fleet
    with obs.timed("place", timings, "place_s"):
        filling = config.algo.endswith("-f")
        with obs.span("place.prep", host=True):
            trimmed = [trim_timeline(p)[0] for p in problems]
            batch = pack_problems(trimmed, assume_trimmed=True)
        if config.algo.startswith("penalty-map"):
            from ..core import penalty_map

            with obs.span("place.maps", host=True):
                mapsets = [[penalty_map(t, kind) for t in trimmed]
                           for kind in ("avg", "max")]
        else:
            mapsets = [[r.mapping for r in lp_results]]
        K, m = len(problems), base.m
        best_cost = np.full(K, np.inf)
        plans = np.zeros((K, m), dtype=np.int64)
        for maps in mapsets:
            for fit in FIT_POLICIES:
                sols = engine.place(batch, maps, fit=fit, filling=filling)
                with obs.span("place.costs", host=True):
                    for s, (t, sol) in enumerate(zip(batch.problems, sols)):
                        c = sol.cost(t)
                        if c < best_cost[s]:
                            best_cost[s] = c
                            plans[s] = sol.nodes_per_type(t)

    with obs.timed("select", timings, "select_s", host=True):
        fleets = candidate_fleets(plans, quantiles=config.quantiles,
                                  current=current_fleet)
        ov = overload_costs(plans, fleets, node_cost)
        fleet_costs = (fleets * node_cost[None, :]).sum(axis=1)

        def _row(alpha: float, lam: float, j: int) -> dict:
            r6 = lambda v: round(float(v), 6)  # noqa: E731
            return {
                "alpha": alpha, "lambda": lam,
                "fleet": fleets[j].tolist(),
                "fleet_cost": r6(fleet_costs[j]),
                "mean_overload": r6(ov[:, j].mean()),
                "cvar_overload": r6(cvar(ov[:, j], alpha)),
                "worst_overload": r6(ov[:, j].max()),
            }

        sel = dict(alpha=config.cvar_alpha, lam=config.cvar_lambda,
                   premium=config.overload_premium,
                   recfg_weight=config.recfg_weight, current=current_fleet)
        j_exp = _select(fleets, ov, node_cost, **{**sel, "lam": 0.0})
        frontier = [_row(config.cvar_alpha, 0.0, j_exp)]
        alphas = sorted(set(config.frontier_alphas) | {config.cvar_alpha})
        j_sel = j_exp
        for alpha in alphas:
            j = _select(fleets, ov, node_cost, **{**sel, "alpha": alpha})
            frontier.append(_row(alpha, config.cvar_lambda, j))
            if alpha == config.cvar_alpha:
                j_sel = j

    return StochasticResult(
        config=config,
        fleet=fleets[j_sel],
        fleet_cost=float(fleet_costs[j_sel]),
        expected_fleet=fleets[j_exp],
        expected_fleet_cost=float(fleet_costs[j_exp]),
        scenario_costs=best_cost,
        scenario_plans=plans,
        overload=ov[:, j_sel],
        expected_overload=ov[:, j_exp],
        max_fleet_cost=float(
            (plans.max(axis=0) * node_cost).sum()),
        frontier=frontier,
        stats=list(stats),
        lp_dispatches=int(lp_dispatches),
        buckets=1,
        timings=timings,
    )
