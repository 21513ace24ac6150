"""The port's placement engines on the CPU, given the reference's mappings.

``place_many`` (lockstep) and ``two_phase`` (per instance), both scoring
backends, must place exactly as the reference does: the same ``assign``,
the same purchases, the same cost, bit for bit.  Every plan also passes the
reference's independent feasibility oracle (``repro.core.checker``).  The
reference's own ``kernel`` backend runs its Pallas kernel in interpret mode
once per step, so it is compared on a small grid only.
"""

import numpy as np
import pytest

from repro.core import assert_feasible, penalty_map, place_many
from repro.core import solve_lp_many, trim_timeline, two_phase
from repro.workload import (SyntheticSpec, sweep_specs, synthetic_batch,
                            synthetic_instance)
from repro_torch.convert import problem_from_arrays
from repro_torch.core import place_many as t_place_many
from repro_torch.core import two_phase as t_two_phase

CASES = [(fit, filling) for fit in ("first", "similarity")
         for filling in (False, True)]


def _trimmed(problems):
    return [trim_timeline(p)[0] for p in problems]


@pytest.fixture(scope="module")
def golden():
    """Golden-grid instances (trimmed) with PDHG and penalty mappings."""
    grid = _trimmed(synthetic_batch(sweep_specs(
        SyntheticSpec(n=60, m=4, D=3, T=16), seeds=2, n=(40, 60, 80))))
    lp = [r.mapping for r in solve_lp_many(grid, iters=400)]
    pen = [penalty_map(p, "max") for p in grid]
    return grid, {"lp": lp, "penalty": pen}


@pytest.fixture(scope="module")
def small():
    grid = _trimmed([synthetic_instance(SyntheticSpec(n=30, m=3, D=2, T=10,
                                                      seed=s))
                     for s in range(3)])
    return grid, [penalty_map(p, "avg") for p in grid]


def _same(got, want, problem):
    np.testing.assert_array_equal(got.assign, want.assign)
    np.testing.assert_array_equal(got.node_type, want.node_type)
    assert got.cost(problem) == want.cost(problem)
    assert_feasible(problem, got)


@pytest.mark.parametrize("fit,filling", CASES)
@pytest.mark.parametrize("source", ["lp", "penalty"])
def test_place_many_matches_reference(golden, source, fit, filling):
    grid, maps = golden
    want = place_many(grid, maps[source], fit=fit, filling=filling)
    tgrid = [problem_from_arrays(p) for p in grid]
    for backend in ("numpy", "kernel"):
        got = t_place_many(tgrid, maps[source], fit=fit, filling=filling,
                           backend=backend, device="cpu")
        for g, w, p in zip(got, want, grid):
            _same(g, w, p)


@pytest.mark.parametrize("fit,filling", CASES)
def test_two_phase_matches_reference(golden, fit, filling):
    grid, maps = golden
    for p, mp in zip(grid[:3], maps["lp"][:3]):
        want = two_phase(p, mp, fit=fit, filling=filling)
        t = problem_from_arrays(p)
        for backend in ("numpy", "kernel"):
            got = t_two_phase(t, mp, fit=fit, filling=filling,
                              backend=backend, device="cpu")
            _same(got, want, p)


@pytest.mark.parametrize("fit", ["first", "similarity"])
def test_kernel_backend_matches_reference_kernel_backend(small, fit):
    grid, maps = small
    want = place_many(grid, maps, fit=fit, filling=True, backend="kernel")
    got = t_place_many([problem_from_arrays(p) for p in grid], maps, fit=fit,
                       filling=True, backend="kernel", device="cpu")
    for g, w, p in zip(got, want, grid):
        _same(g, w, p)


def test_two_phase_kernel_matches_reference_kernel(small):
    grid, maps = small
    p, mp = grid[0], maps[0]
    want = two_phase(p, mp, fit="similarity", backend="kernel")
    got = t_two_phase(problem_from_arrays(p), mp, fit="similarity",
                      backend="kernel", device="cpu")
    _same(got, want, p)


def test_telemetry_and_compiled_stepper(small):
    grid, maps = small
    tgrid = [problem_from_arrays(p) for p in grid]
    tel = {}
    t_place_many(tgrid, maps, telemetry=tel, device="cpu")
    assert tel["engine"] == "lockstep" and tel["waves"] == 3
    with pytest.raises(NotImplementedError, match="item 7"):
        t_place_many(tgrid, maps, placement="compiled", device="cpu")


def test_bad_mapping_raises(small):
    grid, _ = small
    t = problem_from_arrays(grid[0])
    with pytest.raises(ValueError):
        t_place_many([t], [], device="cpu")
    with pytest.raises(ValueError):
        t_place_many([t], [np.zeros(t.n, np.int64)], fit="worst",
                     device="cpu")
