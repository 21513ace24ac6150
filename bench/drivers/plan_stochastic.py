"""Driver of the forecast mixes: a closed loop of one client whose every
step is ``plan_stochastic`` on a demand forecast it has not planned before
(a fresh base instance and fan-out seed): the scenario fan-out, one
batched LP solve of every scenario, the placements and the CVaR fleet
selection."""

from __future__ import annotations

import numpy as np

from .. import gen, traffic, work
from ..check import lp_numbers, plan_numbers, rel_err, worst
from ..reference.instance import trim
from ..reference.protocol import best, passes
from ..reference.select import select
from . import engine, to_problem


class Driver:

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 bench_dir):
        from repro_torch.core import FleetEngine
        from repro_torch.stochastic import DemandForecast, StochasticConfig

        class Recording(FleetEngine):
            """The engine, keeping what its scenario solve returned and
            the plans of the lanes in ``keep`` of every placement pass."""

            keep = ()

            def solve_scenarios(self, problems, init=None):
                self.solved = super().solve_scenarios(problems, init=init)
                return self.solved

            def place(self, problems, mappings, fit=None, filling=None):
                sols = super().place(problems, mappings, fit=fit,
                                     filling=filling)
                self.placed.append([(sols[k].node_type, sols[k].assign)
                                    for k in self.keep])
                return sols

        self.mix, self.seed = mix, seed
        self.engine = engine(Recording, mix, device)
        plan = mix["plan"]
        self.K = plan["scenarios"]
        self.channels = mix["forecast"]

        def forecast(tag, i):
            base = traffic.instances(config, bench_dir, seed, tag, i, 1)[0]
            cfg = StochasticConfig(seed=traffic.step_seed(seed, tag, i),
                                   **plan)
            return base, DemandForecast(base=to_problem(base),
                                        **self.channels), cfg

        self.warm_step = forecast(traffic.WARM, 0)
        self.steps = [forecast(traffic.STEP, i)
                      for i in range(mix["max_steps"])]
        self.picks = traffic.picks(seed, mix["max_steps"], self.K,
                                   mix["sample"])
        self.records: list[dict] = []
        self.kept: list[dict] = []

    def _plan(self, fc, cfg):
        from repro_torch.stochastic import plan_stochastic

        return plan_stochastic(fc, cfg, engine=self.engine)

    def warm(self) -> None:
        self.engine.keep, self.engine.placed = (), []
        self._plan(*self.warm_step[1:])

    def step(self, i: int) -> int:
        self.engine.keep, self.engine.placed = self.picks[i], []
        res = self._plan(*self.steps[i][1:])
        lp_results, stats = self.engine.solved
        placed, algo = self.engine.placed, res.config.algo
        self.engine.solved = self.engine.placed = None
        ys = [y for st in stats for y in st.state.y]
        self.records.append({
            "lp_s": res.timings["lp_s"], "place_s": res.timings["place_s"],
            "iterations": np.concatenate([st.iterations for st in stats]),
            "converged": np.concatenate([st.converged for st in stats]),
            "passes": 2 * (1 + res.config.algo.startswith("penalty"))})
        self.kept.append({
            "plans": res.scenario_plans.copy(),
            "costs": res.scenario_costs.copy(), "fleet": res.fleet.copy(),
            "lanes": [{"x": lp_results[k].x, "y": ys[k],
                       "lb": lp_results[k].lower_bound,
                       "objective": lp_results[k].objective,
                       "kkt": lp_results[k].kkt,
                       "passes": {algo: [p[j] for p in placed]}}
                      for j, k in enumerate(self.picks[i])]})
        return 1

    def failed(self) -> int:
        """Plans with a scenario whose LP lane stopped at the iteration
        cap."""
        return int(sum(bool((~r["converged"]).any()) for r in self.records))

    def close(self) -> None:
        self.engine = None

    def work(self) -> None:
        """Each completed step's least work, from its trimmed scenarios'
        shape (every scenario of a forecast trims to its base's shape)."""
        for rec, (base, _, _) in zip(self.records, self.steps):
            t = trim(base)
            it = rec["iterations"]
            rec["lp_bytes"] = float(it.sum() * work.lp_iteration_bytes(t))
            rec["congestion_bytes"] = float(
                it.sum() * work.congestion_apply_bytes(t))
            rec["placement_bytes"] = float(
                rec["passes"] * self.K * work.placement_pass_bytes(t))

    def check(self, control: str | None = None) -> dict:
        """The worst reading of each number over a sample of the window's
        scenarios (every placement pass: purchases, assignments, capacity
        at every slot; the kept plan and its price; the LP's bound), and
        every sampled step's selection.  ``plan_err`` is 1 where a pass's
        plan, a kept plan's node counts or a selected fleet differ, else the
        kept plan's relative price difference.  ``control="float32"`` puts
        the reference's float32 placements and prices in the program's
        place; ``control="primal_bound"`` puts the program's primal
        objective in the place of its lower bound."""
        plan, algo = self.mix["plan"], self.mix["plan"]["algo"]
        rows = []
        pairs = traffic.sample(self.seed, len(self.kept),
                               self.picks.shape[1], self.mix["sample"])
        for i in sorted({i for i, _ in pairs}):
            base, kept = self.steps[i][0], self.kept[i]
            want = select(kept["plans"], base.cost, plan["quantiles"],
                          plan["cvar_alpha"], plan["cvar_lambda"],
                          plan["overload_premium"])
            rows.append({"plan_err": float(
                not np.array_equal(want, kept["fleet"]))})
        for i, j in pairs:
            base, _, cfg = self.steps[i]
            k = int(self.picks[i, j])
            lane = self.kept[i]["lanes"][j]
            t = trim(gen.scenario(base, self.channels, cfg.seed, k))
            y = lane["y"][: t.T, : t.m, : t.D]
            lb = lane["objective"] if control == "primal_bound" \
                else lane["lb"]
            row = lp_numbers(t, lane["x"], y, lb)
            row["gap_over_kkt"] = row["lp_gap"] - lane["kkt"]
            want = passes(t, lane["x"], algos=(algo,))
            if control == "float32":
                got = passes(t, lane["x"], algos=(algo,), dtype=np.float32)
                kept = best(t, got[algo])
            else:
                got = lane["passes"]
                kept = (self.kept[i]["costs"][k], self.kept[i]["plans"][k])
            row.update(plan_numbers(t, got, want))
            top = best(t, want[algo])
            if row["plan_err"] == 0.0:
                row["plan_err"] = 1.0 if not np.array_equal(kept[1], top[1]) \
                    else rel_err(kept[0], top[0])
            rows.append(row)
        return worst(rows)
