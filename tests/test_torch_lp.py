"""The port's packing and legacy batched PDHG solver on the CPU, against the
JAX reference on the golden grid.

Tolerances: packed arrays are equal exactly (the same numpy code); primal
and dual bounds agree to rel 1e-4 (two float32 trajectories, XLA's and
PyTorch's); argmax mappings are identical.  The reference's Pallas operator
runs in interpret mode, so it is held to 50 iterations.
"""

import numpy as np
import pytest

from repro.core import batch as jbatch
from repro.workload import SyntheticSpec, sweep_specs, synthetic_batch
from repro_torch.convert import problem_from_arrays, state_from_numpy
from repro_torch.core import batch as tbatch
from repro_torch.core import solve_lp_pdhg

REL = 1e-4


@pytest.fixture(scope="module")
def grid():
    """The golden grid (tests/test_golden.py), as reference instances."""
    return synthetic_batch(sweep_specs(SyntheticSpec(n=60, m=4, D=3, T=16),
                                       seeds=2, n=(40, 60, 80)))


@pytest.fixture(scope="module")
def tgrid(grid):
    return [problem_from_arrays(p) for p in grid]


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.objective == pytest.approx(w.objective, rel=REL)
        assert g.lower_bound == pytest.approx(w.lower_bound, rel=REL)
        np.testing.assert_array_equal(g.mapping, w.mapping)
        np.testing.assert_allclose(g.x, w.x, atol=2e-3)


def test_problem_from_arrays_keeps_every_array(grid, tgrid):
    for p, t in zip(grid, tgrid):
        for name in ("dem", "start", "end"):
            np.testing.assert_array_equal(getattr(t, name), getattr(p, name))
        np.testing.assert_array_equal(t.node_types.cap, p.node_types.cap)
        np.testing.assert_array_equal(t.node_types.cost, p.node_types.cost)
        assert t.T == p.T
    again = problem_from_arrays(grid[0].dem, grid[0].start, grid[0].end,
                                grid[0].node_types.cap,
                                grid[0].node_types.cost, grid[0].T)
    np.testing.assert_array_equal(again.dem, tgrid[0].dem)


def test_pack_arrays_equal(grid, tgrid):
    want = jbatch.pack_problems(grid)
    got = tbatch.pack_problems(tgrid)
    for name in ("dem", "start", "end", "cap", "cost", "feas", "task_mask",
                 "type_mask"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.Tp == want.Tp
    np.testing.assert_array_equal(got.weights(), want.weights())
    got_pad = tbatch.pack_problems(tgrid[:2], pad_to=(90, 5, 4, 20))
    want_pad = jbatch.pack_problems(grid[:2], pad_to=(90, 5, 4, 20))
    np.testing.assert_array_equal(got_pad.feas, want_pad.feas)
    assert got_pad.shape == want_pad.shape == (90, 5, 4, 20)


@pytest.mark.parametrize("operator", ["dense", "cumsum"])
def test_legacy_solve_matches_reference(grid, tgrid, operator):
    want = jbatch.solve_lp_many(grid, iters=400, operator=operator)
    got = tbatch.solve_lp_many(tgrid, iters=400, operator=operator,
                               device="cpu")
    _same_results(got, want)


def test_pallas_operator_matches_reference(grid, tgrid):
    want = jbatch.solve_lp_many(grid[:2], iters=50, operator="pallas")
    got = tbatch.solve_lp_many(tgrid[:2], iters=50, operator="pallas",
                               device="cpu")
    _same_results(got, want)


def test_operators_agree(tgrid):
    runs = [tbatch.solve_lp_many(tgrid, iters=200, operator=op, device="cpu")
            for op in ("dense", "cumsum", "pallas")]
    for other in runs[1:]:
        _same_results(other, runs[0])


def test_warm_start_from_reference_state(grid, tgrid):
    """Both solvers continue from the same numpy iterates."""
    _, st = jbatch.solve_lp_many(grid, iters=50, operator="dense",
                                 full_output=True)
    init_j = st.state
    init_t = state_from_numpy(init_j.x, init_j.y)
    want = jbatch.solve_lp_many(grid, iters=100, operator="dense",
                                init=init_j)
    got = tbatch.solve_lp_many(tgrid, iters=100, operator="dense",
                               init=init_t, device="cpu")
    _same_results(got, want)


def test_full_output_state_round_trips(tgrid):
    res, st = tbatch.solve_lp_many(tgrid[:2], iters=60, device="cpu",
                                   full_output=True)
    assert st.tol is None and st.state.x.dtype == np.float32
    assert st.state.x.shape[0] == 2
    assert list(st.iterations) == [60, 60]
    again = tbatch.solve_lp_many(tgrid[:2], iters=1, device="cpu",
                                 init=st.state)
    assert again[0].lower_bound == pytest.approx(res[0].lower_bound,
                                                 rel=1e-2)


def test_single_instance_is_the_batch_of_one(tgrid):
    one = solve_lp_pdhg(tgrid[0], iters=150, device="cpu")
    many = tbatch.solve_lp_many(tgrid[:1], iters=150, device="cpu")[0]
    assert one.lower_bound == many.lower_bound
    np.testing.assert_array_equal(one.mapping, many.mapping)


def test_lower_bound_below_exact_lp(tgrid):
    from repro_torch.core import solve_lp

    res = tbatch.solve_lp_many(tgrid[:2], iters=400, device="cpu")
    for r, p in zip(res, tgrid[:2]):
        exact = solve_lp(p).objective
        assert r.lower_bound <= exact + 1e-6 <= r.objective + 1e-5


def test_dispatch_count_is_one_per_solve(tgrid):
    before = tbatch.dispatch_count()
    tbatch.solve_lp_many(tgrid[:2], iters=5, device="cpu")
    assert tbatch.dispatch_count() == before + 1
