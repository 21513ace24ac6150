"""The port's tolerance-mode PDLP solver and warm-started sweeps on the CPU,
against the reference.

The reference's tol mode imports ``jax.experimental.enable_x64``, which the
installed jax lacks; the module-scoped ``x64_alias`` fixture supplies it
(``jax.enable_x64(True)`` as a context manager) for this file's tests only,
so the reference's own tests keep failing as they do without it, and each
reference configuration compiles once.

Tolerances:
  * ``precision="f64"`` with the ``cumsum`` operator: per-lane iterations
    and restarts equal, objectives and bounds within rel 1e-6 (two float64
    trajectories that differ only in summation order);
  * the mixed-precision defaults: every lane converged, canonical mappings
    and protocol costs equal, objectives within ``_objective_slack`` (each
    of two tol-converged solves is within tol * (1 + |primal| + |dual|) of
    the optimum; the reference's ``tests/test_solver_speed.py`` bound);
  * the port's sequential and pipelined sweeps on the CPU: bit-equal (the
    same inputs through the same deterministic CPU kernels);
  * numpy host code (rounding, lower bounds, ``merge_stats``): equal.
"""

import warnings

import jax
import jax.experimental
import numpy as np
import pytest

from repro.core import FleetEngine as JFleetEngine
from repro.core import SolverConfig as JSolverConfig
from repro.core import SweepConfig as JSweepConfig
from repro.core import batch as jbatch
from repro.core import congestion_lowerbound as j_congestion_lowerbound
from repro.core import concentration_rounding as j_concentration_rounding
from repro.core import evaluate as j_evaluate
from repro.core import lp_lowerbound as j_lp_lowerbound
from repro.core import no_timeline_lowerbound as j_no_timeline_lowerbound
from repro.core import trim_timeline
from repro.core.lp_pdhg import merge_stats as j_merge_stats
from repro.workload import SyntheticSpec, sweep_specs, synthetic_batch
from repro.workload import synthetic_instance
from repro_torch.convert import problem_from_arrays, state_from_numpy
from repro_torch.core import (FleetEngine, PackPlan, SolverConfig,
                              SweepConfig, concentration_rounding,
                              congestion_lowerbound, evaluate,
                              lp_lowerbound, no_timeline_lowerbound,
                              solve_lp_pdhg, solve_lp_sweep)
from repro_torch.core import batch as tbatch
from repro_torch.core.lp_pdhg import merge_stats

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 5e-3
CAP = 4000
REL_F64 = 1e-6
ALGOS = ("lp-map", "lp-map-f")


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


def _objective_slack(a, b, tol=TOL):
    return tol * (2.0 + a.objective + a.lower_bound
                  + b.objective + b.lower_bound)


@pytest.fixture(scope="module")
def small():
    """B=3 trimmed instances, n=30, m=4, D=3, T=10."""
    probs = [trim_timeline(synthetic_instance(SyntheticSpec(
        n=30, m=4, D=3, T=10, seed=s)))[0] for s in range(3)]
    return probs, [problem_from_arrays(p) for p in probs]


@pytest.fixture(scope="module")
def sweep():
    """A 3-point sweep (n = 24, 28, 32) with 2 seeds per point."""
    grid = synthetic_batch(sweep_specs(SyntheticSpec(n=30, m=4, D=3, T=10),
                                       seeds=2, n=(24, 28, 32)))
    return grid, [problem_from_arrays(p) for p in grid]


def _same_mappings(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.mapping, w.mapping,
                                      err_msg=f"instance {i}")


# --- (a) f64 iterate: the same trajectory ---------------------------------

@pytest.mark.parametrize("knobs", [
    {},
    {"scaling": "none", "omega": False},
    {"adaptive": False, "restart": False, "iters": 300},
], ids=["ruiz-omega", "unscaled", "fixed-step"])
def test_f64_solve_follows_the_reference(small, knobs):
    probs, tprobs = small
    kw = dict({"iters": CAP}, **knobs)
    want, wst = jbatch.solve_lp_many(probs, tol=TOL, precision="f64",
                                     operator="cumsum", full_output=True,
                                     **kw)
    got, gst = tbatch.solve_lp_many(tprobs, tol=TOL, precision="f64",
                                    operator="cumsum", full_output=True,
                                    device="cpu", **kw)
    np.testing.assert_array_equal(gst.iterations, wst.iterations)
    np.testing.assert_array_equal(gst.restarts, wst.restarts)
    np.testing.assert_array_equal(gst.converged, wst.converged)
    for g, w in zip(got, want):
        assert g.objective == pytest.approx(w.objective, rel=REL_F64)
        assert g.lower_bound == pytest.approx(w.lower_bound, rel=REL_F64)
        assert (g.iters, g.restarts) == (w.iters, w.restarts)
    _same_mappings(got, want)
    np.testing.assert_allclose(gst.state.eta, wst.state.eta, rtol=REL_F64)


# --- (b) mixed-precision defaults, dense and the pallas route -------------

@pytest.fixture(scope="module")
def ref_fleet(small):
    probs, _ = small
    eng = JFleetEngine(solver=JSolverConfig(tol=TOL, iters=CAP,
                                            operator="dense"), algos=ALGOS)
    res, stats = eng.solve(probs)
    return res, stats, eng.evaluate(probs)


@pytest.mark.parametrize("operator", ["dense", "pallas"])
def test_default_solve_and_protocol_match_reference(small, ref_fleet,
                                                    operator):
    _, tprobs = small
    want, wstats, want_eval = ref_fleet
    eng = FleetEngine(solver=SolverConfig(tol=TOL, iters=CAP,
                                          operator=operator),
                      algos=ALGOS, device="cpu")
    got = eng.evaluate(tprobs)
    assert all(s.converged.all() for s in got.stats + wstats)
    assert all(r.converged and r.kkt <= np.float32(TOL)
               for r in got.lp_results)
    _same_mappings(got.lp_results, want)
    for g, w in zip(got.lp_results, want):
        assert abs(g.objective - w.objective) <= _objective_slack(g, w)
        assert g.lower_bound <= w.objective + _objective_slack(g, w)
        assert w.lower_bound <= g.objective + _objective_slack(g, w)
    for i, (g, w) in enumerate(zip(got.entries, want_eval.entries)):
        assert g["costs"] == w["costs"], i
        assert g["solver"]["converged"] and w["solver"]["converged"]
        assert set(g["solver"]) == set(w["solver"])


def test_single_instance_tol_matches_reference(small):
    probs, tprobs = small
    want = j_evaluate(probs[0], algos=ALGOS, lp_solver="pdhg",
                      lp_iters=CAP, lp_tol=TOL)
    got = evaluate(tprobs[0], algos=ALGOS, lp_solver="pdhg", lp_iters=CAP,
                   lp_tol=TOL, device="cpu")
    assert got["costs"] == want["costs"]
    one = solve_lp_pdhg(tprobs[0], iters=CAP, tol=TOL, device="cpu")
    many = tbatch.solve_lp_many(tprobs[:1], iters=CAP, tol=TOL,
                                device="cpu")[0]
    assert got["lb"] == one.lower_bound == many.lower_bound
    assert one.converged and one.iters == many.iters
    assert abs(got["lb"] - want["lb"]) <= TOL * (
        2.0 + 2 * one.objective + got["lb"] + want["lb"])


# --- (c) a reference state warm-starts both sides --------------------------

def test_reference_state_warm_starts_both(small):
    probs, tprobs = small
    _, st = jbatch.solve_lp_many(probs, tol=2e-2, iters=CAP,
                                 operator="dense", full_output=True)
    assert st.state.eta is not None and st.state.omega is not None
    init_t = state_from_numpy(st.state.x, st.state.y, st.state.eta,
                              st.state.omega)
    want, wst = jbatch.solve_lp_many(probs, tol=TOL, iters=CAP,
                                     operator="dense", init=st.state,
                                     full_output=True)
    got, gst = tbatch.solve_lp_many(tprobs, tol=TOL, iters=CAP,
                                    operator="dense", init=init_t,
                                    full_output=True, device="cpu")
    assert gst.converged.all() and wst.converged.all()
    _same_mappings(got, want)
    for g, w in zip(got, want):
        assert abs(g.objective - w.objective) <= _objective_slack(g, w)
    # the carried step state is resumed, not the power-iteration step
    cold = tbatch.solve_lp_many(tprobs, tol=TOL, iters=CAP, operator="dense",
                                full_output=True, device="cpu")[1]
    assert not np.array_equal(gst.state.eta, cold.state.eta)


# --- (d) the warm sweep, sequential and pipelined --------------------------

def test_warm_sweep_pipeline_matches_sequential_and_reference(sweep):
    grid, tgrid = sweep
    runs, counts = {}, {}
    for pipeline in (False, True):
        eng = FleetEngine(solver=SolverConfig(tol=TOL, iters=CAP,
                                              operator="dense"),
                          sweep=SweepConfig(warm_start=2, pipeline=pipeline),
                          algos=ALGOS, device="cpu")
        before = tbatch.dispatch_count()
        runs[pipeline] = eng.evaluate(tgrid)
        counts[pipeline] = tbatch.dispatch_count() - before
    assert counts == {False: 3, True: 1}
    seq, pipe = runs[False], runs[True]
    assert seq.plan is None and len(seq.stats) == len(pipe.stats) == 3
    for a, b in zip(seq.lp_results, pipe.lp_results):
        np.testing.assert_array_equal(a.mapping, b.mapping)
        assert (a.objective, a.lower_bound, a.iters, a.restarts) == (
            b.objective, b.lower_bound, b.iters, b.restarts)
    for a, b in zip(seq.entries, pipe.entries):
        assert a["costs"] == b["costs"]
    assert pipe.stats[-1].state is not None
    assert all(s.state is None for s in pipe.stats[:-1])
    np.testing.assert_array_equal(pipe.stats[-1].state.y,
                                  seq.stats[-1].state.y)

    jeng = JFleetEngine(solver=JSolverConfig(tol=TOL, iters=CAP,
                                             operator="dense"),
                        sweep=JSweepConfig(warm_start=2, pipeline=True),
                        algos=ALGOS)
    before = jbatch.dispatch_count()
    want = jeng.evaluate(grid)
    assert jbatch.dispatch_count() - before == 1
    want_lp, _ = jeng.solve(grid)
    _same_mappings(pipe.lp_results, want_lp)
    for g, w in zip(pipe.lp_results, want_lp):
        assert abs(g.objective - w.objective) <= _objective_slack(g, w)
    for a, b in zip(pipe.entries, want.entries):
        assert a["costs"] == b["costs"]
    # warm groups start from their neighbour: fewer iterations than cold
    cold = FleetEngine(solver=SolverConfig(tol=TOL, iters=CAP,
                                           operator="dense"),
                       algos=ALGOS, device="cpu").solve(tgrid[2:])[1][0]
    warm = np.concatenate([s.iterations for s in seq.stats[1:]])
    assert warm.sum() <= cold.iterations.sum()


def test_solve_lp_sweep_shim_warns_and_forwards(sweep):
    _, tgrid = sweep
    groups = [tgrid[i : i + 2] for i in range(0, 4, 2)]
    with pytest.warns(DeprecationWarning, match="FleetEngine"):
        res, stats = solve_lp_sweep(groups, tol=TOL, operator="dense",
                                    device="cpu")
    again, _ = tbatch._sweep_impl(groups, tol=TOL, operator="dense",
                                  device="cpu")
    assert [r.objective for r in res] == [r.objective for r in again]
    assert len(stats) == 2 and stats[1].state.eta is not None


# --- (e) numpy host code ---------------------------------------------------

def test_merge_stats_matches_reference(small):
    probs, tprobs = small
    _, wst = jbatch.solve_lp_many(probs, tol=TOL, iters=CAP,
                                  operator="dense", full_output=True)
    want = j_merge_stats([wst, wst])
    got = merge_stats([wst, wst])
    assert got == want
    _, gst = tbatch.solve_lp_many(tprobs, tol=TOL, iters=CAP,
                                  operator="dense", full_output=True,
                                  device="cpu")
    merged = merge_stats([gst, gst])
    assert merged["converged_frac"] == 1.0 and len(merged["iters"]) == 6
    assert merged["tol"] == TOL


def test_rounding_and_lower_bounds_match_reference(small):
    probs, tprobs = small
    rng = np.random.default_rng(3)
    for p, t in zip(probs, tprobs):
        x_lp = rng.random((p.n, p.m))
        x_lp /= x_lp.sum(axis=1, keepdims=True)
        np.testing.assert_array_equal(concentration_rounding(t, x_lp),
                                      j_concentration_rounding(p, x_lp))
        assert congestion_lowerbound(t) == j_congestion_lowerbound(p)
        assert lp_lowerbound(t) == pytest.approx(j_lp_lowerbound(p),
                                                 rel=1e-9)
        assert no_timeline_lowerbound(t) == pytest.approx(
            j_no_timeline_lowerbound(p), rel=1e-9)
        assert congestion_lowerbound(t) <= lp_lowerbound(t) + 1e-9


# --- (f) configuration errors ----------------------------------------------

def test_config_errors(small, sweep):
    _, tprobs = small
    _, tgrid = sweep
    with pytest.raises(ValueError, match=r"\('none', 'ruiz'\)"):
        SolverConfig(scaling="log")
    with pytest.raises(ValueError, match=r"\('f64', 'mixed'\)"):
        SolverConfig(precision="f16")
    with pytest.raises(ValueError, match=r"\('none', 'ruiz'\)"):
        tbatch.solve_lp_many(tprobs, tol=TOL, scaling="bogus", device="cpu")
    with pytest.raises(ValueError, match=r"\('f64', 'mixed'\)"):
        tbatch.solve_lp_many(tprobs, tol=TOL, precision="f128",
                             device="cpu")
    for bad in ({"tol": 0.0}, {"check_every": 0}):
        with pytest.raises(ValueError):
            SolverConfig(**bad)
    with pytest.raises(ValueError, match="warm_start"):
        SweepConfig(pipeline=True)
    with pytest.raises(ValueError, match="pipeline"):
        SweepConfig(devices=1)
    with pytest.raises(ValueError, match=">= 1"):
        SweepConfig(warm_start=2, pipeline=True, devices=0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        SweepConfig(warm_start=2, max_buckets=3)
    with pytest.raises(ValueError, match="mutually exclusive"):
        SweepConfig(warm_start=2, shard_size=4)
    with pytest.raises(ValueError, match="positive group size"):
        SweepConfig(warm_start=0)
    # sharding over devices is checked at dispatch, where the session's
    # device is known: the group size must divide
    assert SweepConfig(warm_start=2, pipeline=True, devices=4).devices == 4
    with pytest.raises(ValueError, match="divide the group size"):
        tbatch._sweep_impl([tgrid[:2]], pipeline=True, devices=4,
                           device="cpu")
    with pytest.raises(ValueError, match="tolerance-stopped"):
        FleetEngine(sweep=SweepConfig(warm_start=2), device="cpu")
    warm = FleetEngine(solver=SolverConfig(tol=TOL),
                       sweep=SweepConfig(warm_start=4, pipeline=True),
                       device="cpu")
    with pytest.raises(ValueError, match="divide the instance count"):
        warm.solve(tgrid)  # 6 instances in groups of 4: ragged
    with pytest.raises(ValueError, match="equal group sizes"):
        tbatch._sweep_impl([tgrid[:2], tgrid[2:5]], pipeline=True,
                           device="cpu")
    with pytest.raises(ValueError, match="align_shapes"):
        tbatch._sweep_impl([tgrid[:2]], pipeline=True, align_shapes=False,
                           device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        warm.solve(tgrid[:4], init=state_from_numpy(
            np.zeros((4, 1, 1)), np.zeros((4, 1, 1, 1))))
    with pytest.raises(ValueError, match="PackPlan"):
        warm.solve(FleetEngine(device="cpu").pack(tgrid[:4]))
    assert isinstance(FleetEngine(device="cpu").pack(tgrid[:4]), PackPlan)
    eng = warm.with_overrides(scaling="none", precision="f64", omega=False,
                              pipeline=False)
    assert (eng.solver.scaling, eng.solver.precision, eng.solver.omega,
            eng.sweep.pipeline) == ("none", "f64", False, False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        SweepConfig(warm_start=2, pipeline=True, devices=1)
