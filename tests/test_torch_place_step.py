"""The port's compiled placement stepper on the CPU, against the reference.

``place_many(placement="compiled")`` of the port (``repro_torch.core.
place_step``, whose stepper runs its plain PyTorch version on the CPU) must
place exactly as the reference's numpy lockstep engine and as the
reference's own compiled stepper (``repro.core.place_step``): the same
``assign``, the same purchases, the same cost, bit for bit, for first and
similarity fit with filling off and on, on a small ragged grid.

The reference's stepper imports ``jax.experimental.enable_x64``, which the
installed jax lacks; the ``x64_alias`` fixture supplies it for one test at a
time (``jax.enable_x64(True)`` as a context manager), so the reference's own
tests keep failing as they do without it.
"""

import numpy as np
import pytest

import jax
import jax.experimental

from repro.core import NodeTypes, Problem, assert_feasible
from repro.core import penalty_map as j_penalty_map
from repro.core import place_many as j_place_many
from repro.core import trim_timeline
from repro.workload import SyntheticSpec, synthetic_instance
from repro_torch.convert import problem_from_arrays
from repro_torch.core import FleetEngine, PlacementConfig, SolverConfig
from repro_torch.core import place_many
from repro_torch.core import place_step as t_place_step

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = [(fit, filling) for fit in ("first", "similarity")
         for filling in (False, True)]


@pytest.fixture
def x64_alias(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


@pytest.fixture(scope="module")
def grid():
    """A ragged grid (mixed n, m, D, T), trimmed, with two mappings."""
    shapes = [(40, 3, 2, 10), (60, 3, 3, 8), (30, 2, 1, 10), (50, 3, 3, 9)]
    probs = [trim_timeline(synthetic_instance(SyntheticSpec(
        n=n, m=m, D=D, T=T, seed=s)))[0]
        for s, (n, m, D, T) in enumerate(shapes)]
    maps = {kind: [j_penalty_map(p, kind) for p in probs]
            for kind in ("avg", "max")}
    return probs, maps


def _same(got, want, problem):
    np.testing.assert_array_equal(got.assign, want.assign)
    np.testing.assert_array_equal(got.node_type, want.node_type)
    assert got.cost(problem) == want.cost(problem)


@pytest.mark.parametrize("fit,filling", CASES)
def test_compiled_matches_reference_engines(grid, x64_alias, fit, filling):
    probs, maps = grid
    tprobs = [problem_from_arrays(p) for p in probs]
    for kind, mp in maps.items():
        tel = {}
        got = place_many(tprobs, mp, fit=fit, filling=filling,
                         placement="compiled", telemetry=tel, device="cpu")
        assert tel["engine"] == "compiled"
        want = j_place_many(probs, mp, fit=fit, filling=filling)
        for g, w, p in zip(got, want, probs):
            _same(g, w, p)
            assert_feasible(p, g)
        if kind == "avg":  # the reference's stepper, and its dispatches
            jtel = {}
            want_c = j_place_many(probs, mp, fit=fit, filling=filling,
                                  placement="compiled", telemetry=jtel)
            for g, w, p in zip(got, want_c, probs):
                _same(g, w, p)
            for key in ("engine", "mode", "waves", "dispatches"):
                assert tel[key] == jtel[key], key


def _infeasible():
    return Problem(dem=np.array([[0.9], [0.4], [0.95]]),
                   start=np.array([0, 0, 1]), end=np.array([1, 1, 1]),
                   node_types=NodeTypes(cap=np.array([[1.0], [0.5]]),
                                        cost=np.array([1.0, 0.4])),
                   T=2)


@pytest.mark.parametrize("filling", [False, True])
def test_infeasible_mapping_raises_like_reference(filling):
    t = _infeasible()
    bad = np.array([1, 1, 1])  # tasks 0 (0.9) and 2 (0.95) cannot fit 0.5
    with pytest.raises(RuntimeError) as want:
        j_place_many([t], [bad], filling=filling)
    with pytest.raises(RuntimeError) as got:
        place_many([problem_from_arrays(t)], [bad], filling=filling,
                   placement="compiled", device="cpu")
    assert str(got.value) == str(want.value)
    assert "task 0 to node-type 1" in str(got.value)


def test_telemetry_dispatches_and_fallback(grid, monkeypatch):
    probs, maps = grid
    tprobs = [problem_from_arrays(p) for p in probs]
    mp = maps["avg"]
    tel = {}
    place_many(tprobs, mp, placement="compiled", telemetry=tel,
               device="cpu")
    assert (tel["mode"], tel["dispatches"], tel["waves"]) == \
        ("type-parallel", 1, 1)
    assert tel["spilled_lanes"] == 0
    # wave mode: one own-pack dispatch per wave, and one cross-fill
    # dispatch per wave in which some instance has nodes and fill tasks
    tel = {}
    want = j_place_many(probs, mp, filling=True)
    place_many(tprobs, mp, filling=True, placement="compiled",
               telemetry=tel, device="cpu")
    waves = max(p.node_types.m for p in probs)
    assert tel["mode"] == "wave-sequential" and tel["waves"] == waves
    assert 1 < tel["dispatches"] <= 2 * waves
    # on the CPU, a pool budget of zero cells sends the call to the numpy
    # engine (the card has no cap: test_torch_cuda.py)
    monkeypatch.setattr(t_place_step, "MAX_POOL_CELLS", 0)
    tel = {}
    got = place_many(tprobs, mp, filling=True, placement="compiled",
                     telemetry=tel, device="cpu")
    assert tel["engine"] == "lockstep-fallback" and "fallback" in tel
    for g, w, p in zip(got, want, probs):
        _same(g, w, p)


def test_fleet_engine_compiled_equals_batched():
    fleet = [synthetic_instance(SyntheticSpec(n=30, m=3, D=2, T=10, seed=s))
             for s in range(3)]
    solver = SolverConfig(iters=200)
    got = FleetEngine(solver=solver,
                      placement=PlacementConfig(engine="compiled"),
                      device="cpu").evaluate(fleet)
    want = FleetEngine(solver=solver, device="cpu").evaluate(fleet)
    for g, w in zip(got.entries, want.entries):
        assert g["costs"] == w["costs"]
        assert g["lb"] == w["lb"]
    tel = got.timings["placement"]
    assert tel["engine"] == "compiled" and tel["fallbacks"] == 0
    assert tel["modes"] == ["type-parallel", "wave-sequential"]
    # 12 place_many calls: 6 type-parallel (1 dispatch each), 6 in waves
    assert tel["calls"] == 12 and tel["dispatches"] > 12
    sols = FleetEngine(placement=PlacementConfig(engine="compiled"),
                       device="cpu").place(
        fleet, [np.zeros(p.n, np.int64) for p in fleet], fit="similarity")
    assert all(s.meta["fit"] == "similarity" for s in sols)


def test_plain_stepper_rejects_what_it_does_not_take():
    import torch

    from repro_torch.kernels import place_step as kstep

    A, n_cap, K, D, L = 2, 3, 6, 2, 4
    f64 = dict(dtype=torch.float64)
    i32 = dict(dtype=torch.int32)
    args = [torch.ones((A, n_cap, K), **f64), torch.zeros(A, **i32),
            torch.full((A,), L, **i32), torch.full((L, A, D), 0.1, **f64),
            torch.zeros((L, A), **i32), torch.ones((L, A), **i32),
            torch.ones((L, A), **f64), torch.ones((A, D), **f64),
            torch.ones((A, D), **f64)]
    out = kstep.sub_phase(*args, 1e9, True, False, rows=n_cap)
    w, bad, j_rec = kstep.split(out, A)
    # first fit, demand 0.1 over slots 0-1 of capacity 1: one node each
    assert w.tolist() == [1, 1] and bad.tolist() == [-1, -1]
    assert j_rec.tolist() == [[0, 0]] * L
    assert torch.allclose(args[0][:, 0, :4], torch.full((A, 4), 0.6,
                                                        **f64))
    with pytest.raises(ValueError, match="rows"):
        kstep.sub_phase(*args, 1e9, True, False, rows=n_cap + 1)
    bad_args = list(args)
    bad_args[3] = bad_args[3].float()
    with pytest.raises(TypeError, match="dem_seq"):
        kstep.sub_phase(*bad_args, 1e9, True, False, rows=n_cap)
