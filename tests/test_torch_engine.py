"""The port's fleet session end to end on the CPU: the golden table, the
kernel configuration against the reference's, the single-instance API, and
the Table-I generator.

Tolerances: lower bounds rel 1e-4 (two frameworks' float32 PDHG
trajectories); costs rel 1e-5 (a flipped mapping or placement moves a cost
by a whole node price, far above that).
"""

import json
import pathlib

import numpy as np
import pytest

from repro.core import FleetEngine as JFleetEngine
from repro.core import PlacementConfig as JPlacementConfig
from repro.core import SolverConfig as JSolverConfig
from repro.core import evaluate as j_evaluate
from repro.core import rightsize as j_rightsize
from repro.workload import SyntheticSpec as JSpec
from repro.workload import sweep_specs as j_sweep_specs
from repro.workload import synthetic_instance as j_synthetic_instance
from repro_torch.convert import problem_from_arrays
from repro_torch.core import (ALGORITHMS, FleetEngine, PlacementConfig,
                              SolverConfig, SweepConfig, dispatch_count,
                              evaluate, rightsize, verify)
from repro_torch.workload import (SyntheticSpec, sweep_specs,
                                  synthetic_batch, synthetic_instance)

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = pathlib.Path(__file__).resolve().parent.parent \
    / "results" / "golden" / "evaluate_many.json"
LB_REL = 1e-4
COST_REL = 1e-5


def _golden_grid():
    return synthetic_batch(sweep_specs(SyntheticSpec(n=60, m=4, D=3, T=16),
                                       seeds=2, n=(40, 60, 80)))


def _small_fleet():
    return [synthetic_instance(SyntheticSpec(n=30, m=3, D=2, T=10, seed=s))
            for s in range(3)]


def _agree(got_entries, want_entries):
    assert len(got_entries) == len(want_entries)
    for got, want in zip(got_entries, want_entries):
        assert got["lb"] == pytest.approx(want["lb"], rel=LB_REL)
        assert set(got["costs"]) == set(want["costs"])
        for algo, cost in want["costs"].items():
            assert got["costs"][algo] == pytest.approx(cost, rel=COST_REL)
            assert got["normalized"][algo] == pytest.approx(
                want["normalized"][algo], rel=LB_REL)


def test_golden_table():
    want = json.loads(GOLDEN.read_text())
    res = FleetEngine(solver=SolverConfig(iters=want["lp_iters"]),
                      device="cpu").evaluate(_golden_grid())
    _agree(res.entries, want["entries"])
    assert res.timings["placement"]["engine"] == "batched"
    assert res.plan.n_buckets == 1 and len(res.lp_results) == len(res)


def test_kernel_configuration_matches_reference():
    fleet = _small_fleet()[:2]
    want = JFleetEngine(
        solver=JSolverConfig(operator="pallas", iters=30),
        placement=JPlacementConfig(backend="kernel")).evaluate(
            [j_synthetic_instance(JSpec(n=30, m=3, D=2, T=10, seed=s))
             for s in range(2)])
    got = FleetEngine(solver=SolverConfig(operator="pallas", iters=30),
                      placement=PlacementConfig(backend="kernel"),
                      device="cpu").evaluate(fleet)
    _agree(got.entries, want.entries)


def test_loop_engine_and_buckets_agree_with_batched():
    fleet = [synthetic_instance(SyntheticSpec(n=n, m=3, D=2, T=12, seed=s))
             for n, s in ((20, 0), (45, 1), (70, 2), (25, 3))]
    base = FleetEngine(solver=SolverConfig(iters=150), device="cpu")
    batched = base.evaluate(fleet)
    loop = base.with_overrides(engine="loop").evaluate(fleet)
    for a, b in zip(batched.entries, loop.entries):
        assert a["costs"] == b["costs"]
    bucketed = base.with_overrides(max_buckets=3, bucket_overhead=0.0,
                                   shard_size=1).evaluate(fleet)
    assert bucketed.plan.n_buckets > 1
    _agree(bucketed.entries, batched.entries)


def test_solve_and_place_phases():
    fleet = _small_fleet()
    eng = FleetEngine(solver=SolverConfig(iters=80), device="cpu")
    results, stats = eng.solve(fleet)
    assert stats == [] and len(results) == 3
    sols = eng.place(fleet, [r.mapping for r in results], fit="similarity",
                     filling=True)
    for p, s in zip(fleet, sols):
        verify(p, s)


def test_rightsize_and_evaluate_match_reference():
    jp = j_synthetic_instance(JSpec(n=40, m=3, D=2, T=12, seed=4))
    tp = problem_from_arrays(jp)
    for algo in ("penalty-map", "penalty-map-f", "lp-map-f",
                 "penalty-map-f+ls"):
        want = j_rightsize(jp, algo)
        got = rightsize(tp, algo, device="cpu")
        np.testing.assert_array_equal(got.assign, want.assign)
        assert got.cost(tp) == want.cost(jp)
    want = j_evaluate(jp, lp_solver="pdhg", lp_iters=200)
    got = evaluate(tp, lp_solver="pdhg", lp_iters=200, device="cpu")
    _agree([got], [want])
    exact = evaluate(tp, algos=("lp-map",), device="cpu")
    assert exact["lb"] == pytest.approx(
        j_evaluate(jp, algos=("lp-map",))["lb"], rel=1e-9)


def test_synthetic_generator_is_identical():
    for spec in (SyntheticSpec(n=50, m=4, D=3, T=16, seed=3),
                 SyntheticSpec(), SyntheticSpec(cost_model="heterogeneous",
                                                e=2.0, seed=9)):
        got = synthetic_instance(spec)
        want = j_synthetic_instance(JSpec(**{
            f: getattr(spec, f) for f in spec.__dataclass_fields__}))
        for name in ("dem", "start", "end"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        np.testing.assert_array_equal(got.node_types.cap, want.node_types.cap)
        np.testing.assert_array_equal(got.node_types.cost,
                                      want.node_types.cost)
    assert len(sweep_specs(SyntheticSpec(), seeds=2, D=(2, 5))) == len(
        j_sweep_specs(JSpec(), seeds=2, D=(2, 5)))


def test_unported_options_raise():
    assert SolverConfig(tol=5e-3).tol == 5e-3
    assert PlacementConfig(engine="compiled").engine == "compiled"
    assert SweepConfig(warm_start=2, pipeline=True, devices=1).devices == 1
    # the sharded pipeline is ported: a config of two shards is valid, and
    # the shard count is checked against the visible cards at dispatch
    assert SweepConfig(warm_start=2, pipeline=True, devices=2).devices == 2
    with pytest.raises(ValueError, match="requires pipeline=True"):
        SweepConfig(warm_start=2, devices=2)
    eng = FleetEngine(device="cpu")
    fleet = _small_fleet()
    d0 = dispatch_count()
    results, _ = eng.solve_scenarios([fleet[0]] * 3)
    assert dispatch_count() - d0 == 1 and len(results) == 3
    assert ALGORITHMS == ("penalty-map", "penalty-map-f", "lp-map",
                          "lp-map-f")


def test_active_constraints_raise():
    """Active constraints are lowered by the entry points; only an entry
    that takes plain instances (``trim_timeline``) still raises, naming
    ``lower_constraints``."""
    import dataclasses

    from repro_torch.core import TaskConstraints, check_plan, trim_timeline

    p = _small_fleet()[0]
    vacuous = dataclasses.replace(p, constraints=TaskConstraints.vacuous(p.n))
    rightsize(vacuous, "penalty-map", device="cpu")
    active = dataclasses.replace(
        p, constraints=TaskConstraints.from_groups(p.n, exclusive=(1,)))
    with pytest.raises(ValueError, match="lower_constraints"):
        trim_timeline(active)
    assert len(FleetEngine(device="cpu").evaluate([active]).entries) == 1
    sol = rightsize(active, device="cpu")
    assert check_plan(active, sol) == []
    assert sol.meta["constrained"] is True