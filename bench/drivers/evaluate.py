"""Driver of the fleet mixes: a closed loop of one client whose every step
is ``FleetEngine.evaluate`` (the paper's §VI protocol: one batched LP
solve, then every algorithm and fit placed and verified) on a fleet it has
not planned before."""

from __future__ import annotations

import contextlib

import numpy as np

from .. import traffic, work
from ..check import lp_numbers, plan_numbers, rel_err, worst
from ..reference.instance import trim
from ..reference.protocol import best, passes
from . import engine, to_problem


@contextlib.contextmanager
def placements():
    """Records every ``place_many`` call of the program's protocol engine
    as (the packed batch, the algorithm, the plans it returned), in call
    order, and puts the original back."""
    from repro_torch.core import engine as mod

    real, calls = mod.place_many, []

    def recorded(batch, mappings, *args, **kwargs):
        sols = real(batch, mappings, *args, **kwargs)
        calls.append((batch, (kwargs.get("meta") or {}).get("algo"), sols))
        return sols

    mod.place_many = recorded
    try:
        yield calls
    finally:
        mod.place_many = real


class Driver:

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 bench_dir):
        from repro_torch.core import FleetEngine

        self.mix, self.seed = mix, seed
        B = mix["fleet"]
        self.engine = engine(FleetEngine, mix, device)
        self.warm_fleet = [to_problem(t) for t in traffic.instances(
            config, bench_dir, seed, traffic.WARM, 0, B)]
        self.fleets = [traffic.instances(config, bench_dir, seed,
                                         traffic.STEP, i, B)
                       for i in range(mix["max_steps"])]
        self.problems = [[to_problem(t) for t in f] for f in self.fleets]
        self.picks = traffic.picks(seed, mix["max_steps"], B, mix["sample"])
        self.records: list[dict] = []
        self.kept: list[list[dict]] = []

    def warm(self) -> None:
        self.engine.evaluate(self.warm_fleet)

    def step(self, i: int) -> int:
        with placements() as calls:
            r = self.engine.evaluate(self.problems[i])
        # the solve's lanes run bucket by bucket; ``at[b]`` is instance b's
        order = [b for bucket in r.plan.buckets for b in bucket.indices]
        at = np.empty(len(order), np.int64)
        at[order] = np.arange(len(order))
        ys = [y for st in r.stats for y in st.state.y]
        algo = self.mix["quality_algo"]
        self.records.append({
            "lp_s": r.timings["lp_s"], "place_s": r.timings["place_s"],
            "iterations": np.concatenate(
                [st.iterations for st in r.stats])[at],
            "converged": np.concatenate(
                [st.converged for st in r.stats])[at],
            "passes": r.timings["placement"]["calls"]
            - r.timings["placement"].get("fallbacks", 0),
            "quality": [e["normalized"][algo] for e in r.entries]})
        lane = {b: (bucket.batch, j) for bucket in r.plan.buckets
                for j, b in enumerate(bucket.indices)}
        kept = []
        for b in self.picks[i]:
            batch, j = lane[int(b)]
            plans: dict = {}
            for bb, a, sols in calls:
                if bb is batch:
                    plans.setdefault(a, []).append(
                        (sols[j].node_type, sols[j].assign))
            res = r.lp_results[b]
            kept.append({"x": res.x, "y": ys[at[b]], "lb": res.lower_bound,
                         "objective": res.objective, "kkt": res.kkt,
                         "costs": dict(r.entries[b]["costs"]),
                         "passes": plans})
        self.kept.append(kept)
        return len(r.entries)

    def failed(self) -> int:
        """Instances whose LP lane stopped at the iteration cap."""
        return int(sum(int((~r["converged"]).sum()) for r in self.records))

    def close(self) -> None:
        """Frees the program's state before the check."""
        self.engine = None
        self.warm_fleet = self.problems = None

    def work(self) -> None:
        """Each completed step's least work, from its trimmed instances."""
        for rec, fleet in zip(self.records, self.fleets):
            trimmed = [trim(t) for t in fleet]
            it = rec["iterations"]
            rec["lp_bytes"] = float(sum(
                k * work.lp_iteration_bytes(t) for k, t in zip(it, trimmed)))
            rec["congestion_bytes"] = float(sum(
                k * work.congestion_apply_bytes(t)
                for k, t in zip(it, trimmed)))
            rec["placement_bytes"] = float(rec["passes"] * sum(
                work.placement_pass_bytes(t) for t in trimmed))

    def check(self, control: str | None = None) -> dict:
        """The worst reading of each number over a sample of the answers
        the window produced: every placement pass of the sampled instances
        (purchases, assignments, capacity at every slot), each algorithm's
        best price and the LP's bound (``gap_over_kkt``, how far
        ``lp_gap`` reads above the program's own gap, is read and not
        compared).  ``control="float32"`` puts the reference's float32
        placements and prices in the program's place;
        ``control="primal_bound"`` puts the program's primal objective in
        the place of its lower bound."""
        rows = []
        pairs = traffic.sample(self.seed, len(self.kept),
                               self.picks.shape[1], self.mix["sample"])
        for i, j in pairs:
            kept, t = self.kept[i][j], trim(self.fleets[i][self.picks[i, j]])
            y = kept["y"][: t.T, : t.m, : t.D]
            lb = kept["objective"] if control == "primal_bound" \
                else kept["lb"]
            row = lp_numbers(t, kept["x"], y, lb)
            row["gap_over_kkt"] = row["lp_gap"] - kept["kkt"]
            want = passes(t, kept["x"])
            if control == "float32":
                got = passes(t, kept["x"], dtype=np.float32)
                prices = {a: best(t, p)[0] for a, p in got.items()}
            else:
                got, prices = kept["passes"], kept["costs"]
            row.update(plan_numbers(t, got, want))
            row["cost_err"] = max(rel_err(prices[a], best(t, p)[0])
                                  for a, p in want.items())
            rows.append(row)
        return worst(rows)
