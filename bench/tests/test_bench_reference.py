"""The plain reference against the program run on the CPU at small sizes,
and the import rules: nothing the benchmark loads is JAX or the JAX
package, and the reference loads nothing of the program."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from bench import gen
from bench.check import lp_numbers
from bench.drivers import to_problem
from bench.reference import lp as rlp
from bench.reference.instance import penalty_map as ref_penalty_map
from bench.reference.instance import trim
from bench.reference.place import FITS, overload, place, plan_cost
from bench.reference.protocol import best_plans
from bench.reference.select import select

from repro_torch.core import (FleetEngine, PlacementConfig, SolverConfig,
                              penalty_map, trim_timeline, two_phase)
from repro_torch.stochastic import (DemandForecast, StochasticConfig,
                                    plan_stochastic)

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORECAST = json.loads((ROOT / "bench" / "mixes" / "forecast.json")
                      .read_text())


def small(kind, seed, n=60):
    r = np.random.default_rng(seed)
    if kind == "synthetic":
        return gen.synthetic_instance(r, n, 4, 3, 12)
    return gen.gct_like_instance(r, n, 5, "gce")


def engine():
    return FleetEngine(solver=SolverConfig(tol=5e-3, iters=4000,
                                           operator="pallas"),
                       placement=PlacementConfig(engine="compiled"),
                       device="cpu")


@pytest.mark.parametrize("kind", ["synthetic", "gct"])
def test_trim_is_the_programs(kind):
    t = small(kind, 1)
    mine, (theirs, _) = trim(t), trim_timeline(to_problem(t))
    assert mine.T == theirs.T
    assert np.array_equal(mine.start, theirs.start)
    assert np.array_equal(mine.end, theirs.end)


@pytest.mark.parametrize("kind", ["synthetic", "gct"])
@pytest.mark.parametrize("fit", FITS)
@pytest.mark.parametrize("filling", [False, True])
def test_greedy_places_as_the_program(kind, fit, filling):
    t = trim(small(kind, 2))
    mapping = ref_penalty_map(t, "avg")
    assert np.array_equal(mapping, penalty_map(to_problem(t), "avg"))
    bought, assign = place(t, mapping, fit, filling)
    sol = two_phase(to_problem(t), mapping, fit=fit, filling=filling,
                    device="cpu")
    assert np.array_equal(bought, sol.node_type)
    assert np.array_equal(assign, sol.assign)
    assert plan_cost(t, bought) == sol.cost(to_problem(t))
    assert overload(t, bought, assign) <= 1e-7


@pytest.mark.parametrize("kind", ["synthetic", "gct"])
def test_protocol_and_certificate_against_the_program(kind):
    fleet = [small(kind, s) for s in (3, 4, 5)]
    r = engine().evaluate([to_problem(t) for t in fleet])
    y = r.stats[0].state.y
    for b, t in enumerate(fleet):
        t = trim(t)
        res = r.lp_results[b]
        want = best_plans(t, res.x)
        for algo, (cost, _) in want.items():
            assert r.entries[b]["costs"][algo] == cost
        assert np.array_equal(rlp.rounding(t, res.x), res.mapping)
        nums = lp_numbers(t, res.x, y[b][: t.T, : t.m, : t.D],
                          res.lower_bound)
        assert nums["lp_cert"] <= 1.0
        assert 0.0 <= nums["lp_gap"] <= 5e-3
        assert rlp.primal_bound(t, res.x) == pytest.approx(res.objective,
                                                            rel=1e-6)


def test_certificate_catches_a_raised_bound():
    t = trim(small("synthetic", 6))
    r = engine().evaluate([to_problem(t)])
    res, y = r.lp_results[0], r.stats[0].state.y[0][: t.T, : t.m, : t.D]
    g, slack = rlp.dual_bound(t, y)
    raised = lp_numbers(t, res.x, y, g + 2 * slack)
    assert raised["lp_cert"] > 1.0


def test_selection_is_the_programs():
    base = small("gct", 7, n=50)
    plan = dict(FORECAST["plan"], scenarios=12)
    eng = engine()
    res = plan_stochastic(DemandForecast(base=to_problem(base),
                                         **FORECAST["forecast"]),
                          StochasticConfig(seed=5, **plan), engine=eng)
    fleet = select(res.scenario_plans, base.cost, plan["quantiles"],
                   plan["cvar_alpha"], plan["cvar_lambda"],
                   plan["overload_premium"])
    assert np.array_equal(fleet, res.fleet)


SNIPPET = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
{body}
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in {names!r})
print(bad)
"""


def loaded(body: str, names) -> list:
    code = SNIPPET.format(src=str(ROOT / "src"), root=str(ROOT), body=body,
                          names=tuple(names))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    body = ("import bench.check, bench.reference.protocol, "
            "bench.reference.select, bench.traffic, bench.work")
    assert loaded(body, ("repro_torch", "repro", "jax", "jaxlib")) == []


def test_a_run_loads_no_jax(tmp_path):
    body = (
        "import pathlib\n"
        "sys.path.insert(0, {tests!r})\n"
        "import _tiny\n"
        "from bench import harness\n"
        "root = _tiny.tiny_root(pathlib.Path({tmp!r}))\n"
        "harness.run(root, 'tinygct.forecast', 3, 0.1, False, "
        "device='cpu', log=lambda *a, **k: None)\n"
    ).format(tests=str(ROOT / "bench" / "tests"), tmp=str(tmp_path))
    assert loaded(body, ("jax", "jaxlib", "flax", "repro")) == []
