"""The single-instance placement through the ``two_phase`` kernel's route, on
the CPU (where the wrapper runs the kernel's plain version,
``kernels.ref.two_phase_ref``).

``repro_torch.core.two_phase(backend="kernel", device="cpu")`` must place
exactly as the reference's numpy ``repro.core.placement.two_phase``: the same
``assign`` and the same purchases, bit for bit (tolerance: exact equality),
for both fit policies, with and without cross-fill, at shapes that include
D=1, a one-slot timeline, tasks that all span the whole timeline, and exact
ties in the similarity score.  Inputs are made from numpy seeds.
"""

import numpy as np
import pytest
import torch

from repro.core import penalty_map, trim_timeline, two_phase
from repro.core.problem import NodeTypes, Problem
from repro.workload import SyntheticSpec, synthetic_instance
from repro_torch import kernels
from repro_torch.convert import problem_from_arrays
from repro_torch.core import ALGORITHMS, rightsize
from repro_torch.core.place_batch import _phases
from repro_torch.core.placement import TypePool
from repro_torch.core import two_phase as t_two_phase
from repro_torch.kernels import place_step as kstep
from repro_torch.kernels import ref

SEEDS = (0, 1, 2)


def _custom(rng, n, m, D, T, whole=False):
    """n tasks over T slots (all over the whole timeline when ``whole``)."""
    start = rng.integers(0, T, n)
    end = np.minimum(start + rng.integers(0, T, n), T - 1)
    if whole:
        start, end = np.zeros(n, np.int64), np.full(n, T - 1)
    cap = 0.4 + 0.6 * rng.random((m, D))
    return Problem(dem=0.02 + 0.25 * rng.random((n, D)), start=start,
                   end=end, node_types=NodeTypes(cap=cap,
                                                 cost=1 + rng.random(m)),
                   T=T)


def _ties(rng, T=8):
    """Identical large tasks open nodes whose remaining capacity is equal,
    and identical small tasks then score exactly equal on each of them."""
    D = 2
    cap = np.array([[1.0, 1.0], [0.8, 1.2]])
    n_big, n_small = 6, 24
    dem = np.vstack([np.full((n_big, D), 0.55),
                     np.tile(0.05 + 0.1 * rng.random(D), (n_small, 1))])
    start = np.concatenate([np.zeros(n_big, np.int64),
                            rng.integers(1, 3, n_small)])
    end = np.concatenate([np.full(n_big, T - 1), np.full(n_small, T - 2)])
    return Problem(dem=dem, start=start, end=end,
                   node_types=NodeTypes(cap=cap, cost=np.array([1.0, 1.1])),
                   T=T)


SHAPES = {
    "table": lambda rng, s: trim_timeline(synthetic_instance(
        SyntheticSpec(n=60, m=4, D=3, T=12, seed=s)))[0],
    "d1": lambda rng, s: trim_timeline(synthetic_instance(
        SyntheticSpec(n=40, m=3, D=1, T=10, seed=s)))[0],
    "t1": lambda rng, s: _custom(rng, 30, 3, 2, 1),
    "whole": lambda rng, s: _custom(rng, 30, 3, 3, 6, whole=True),
    "ties": lambda rng, s: _ties(rng),
}


def _instance(shape, seed):
    p = SHAPES[shape](np.random.default_rng(seed), seed)
    return p, penalty_map(p, "max" if seed % 2 else "avg")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("filling", [False, True])
@pytest.mark.parametrize("fit", ["first", "similarity"])
def test_kernel_route_places_as_the_reference(shape, seed, filling, fit):
    p, mapping = _instance(shape, seed)
    want = two_phase(p, mapping, fit=fit, filling=filling)
    got = t_two_phase(problem_from_arrays(p), mapping, fit=fit,
                      filling=filling, backend="kernel", device="cpu")
    np.testing.assert_array_equal(got.assign, want.assign)
    np.testing.assert_array_equal(got.node_type, want.node_type)
    assert got.meta["fit"] == fit and got.meta["filling"] == filling


@pytest.mark.parametrize("D", [1, 2, 5, 7])
def test_demand_norms_are_find_fit_s_bit_for_bit(D):
    for seed in SEEDS:
        p = trim_timeline(synthetic_instance(
            SyntheticSpec(n=300, m=6, D=D, T=24, seed=seed)))[0]
        mapping = penalty_map(p, "avg")
        cap = p.node_types.cap
        want = [np.linalg.norm(p.dem[u] / cap[mapping[u]])
                * np.sqrt(p.end[u] - p.start[u] + 1) for u in range(p.n)]
        got = _phases(problem_from_arrays(p), mapping, "similarity",
                      True).dem_norm
        np.testing.assert_array_equal(got, np.array(want))


@pytest.mark.parametrize("fit", ["first", "similarity"])
def test_type_pool_kernel_backend_matches_the_reference_type_pool(fit):
    """``TypePool(backend="kernel")``, the per-task B=1 fit kernel's route
    for direct callers, against the reference's ``TypePool`` with its
    kernel backend (the Pallas kernel in interpret mode): the same node
    for every task of one type's own pack, the same remaining capacity."""
    from repro.core.placement import TypePool as RefTypePool

    p = trim_timeline(synthetic_instance(
        SyntheticSpec(n=60, m=3, D=3, T=10, seed=6)))[0]
    B = 0
    ref_pool = RefTypePool(p.node_types.cap[B], p.T, backend="kernel")
    pool = TypePool(p.node_types.cap[B], p.T, backend="kernel",
                    device=torch.device("cpu"))
    order = np.lexsort((np.arange(p.n), p.start))[:24]
    for u in order:
        dem, s, e = p.dem[u], int(p.start[u]), int(p.end[u])
        want = ref_pool.find_fit(dem, s, e, fit)
        assert pool.find_fit(dem, s, e, fit) == want, u
        if want is None:
            want = ref_pool.open_node(ref_pool.count)
            assert pool.open_node(pool.count) == want
        ref_pool.place(want, dem, s, e)
        pool.place(want, dem, s, e)
    assert 1 < pool.count < len(order)
    np.testing.assert_array_equal(pool.rem, ref_pool.rem)


def _outcome(fn):
    try:
        sol = fn()
    except RuntimeError as err:
        return ("raised", str(err))
    return ("placed", sol.assign.tolist(), sol.node_type.tolist())


@pytest.mark.parametrize("filling", [False, True])
def test_unfit_mapping_raises_the_reference_error(filling):
    rng = np.random.default_rng(5)
    p = _custom(rng, 20, 3, 2, 6)
    cap = p.node_types.cap.copy()
    cap[1] = 0.05  # below every demand: no task fits type 1
    p = Problem(dem=p.dem, start=p.start, end=p.end,
                node_types=NodeTypes(cap=cap, cost=p.node_types.cost),
                T=p.T)
    mapping = penalty_map(p, "avg")
    mapping[[3, 11]] = 1
    want = _outcome(lambda: two_phase(p, mapping, filling=filling))
    got = _outcome(lambda: t_two_phase(problem_from_arrays(p), mapping,
                                       filling=filling, backend="kernel",
                                       device="cpu"))
    assert got == want
    if not filling:
        assert want[0] == "raised" and "to node-type 1 it" in want[1]


def test_rightsize_kernel_route_equals_numpy_route():
    p = trim_timeline(synthetic_instance(
        SyntheticSpec(n=40, m=3, D=2, T=10, seed=4)))[0]
    t = problem_from_arrays(p)
    for algo in ALGORITHMS:
        a = rightsize(t, algo, backend="kernel", device="cpu")
        b = rightsize(t, algo, backend="numpy", device="cpu")
        assert a.cost(t) == b.cost(t), algo
        np.testing.assert_array_equal(a.assign, b.assign)
        np.testing.assert_array_equal(a.node_type, b.node_type)


def _walk_args():
    i32, f64 = torch.int32, torch.float64
    return dict(walk=torch.tensor([0, 1], dtype=i32),
                bounds=torch.tensor([[0, 2, 2]], dtype=i32),
                cap=torch.ones((1, 2), dtype=f64),
                dem=torch.full((2, 2), 0.3, dtype=f64),
                start=torch.zeros(2, dtype=i32),
                end=torch.ones(2, dtype=i32),
                dn=torch.ones(2, dtype=f64))


def _walk(args, **kw):
    return kstep.two_phase_walk(**args, T=2, quantum=1e9, similarity=True,
                                sequential=True, rows=2, **kw)


def test_wrapper_places_and_counts_no_cpu_launch():
    before = kstep.two_phase_walk.launches
    out = _walk(_walk_args())
    w, bad, steps, phase, node = kstep.split_walk(out.numpy(), 1, 2)
    assert (w.tolist(), bad.tolist(), steps.tolist()) == ([1], [-1], [2])
    assert phase.tolist() == [0, 0] and node.tolist() == [0, 0]
    assert kstep.two_phase_walk.launches == before
    assert kernels.launch_counts()["two_phase"] == kstep.two_phase_walk.launches


@pytest.mark.parametrize("sequential", [False, True])
def test_wrapper_raises_when_rows_are_too_few(sequential):
    """A phase that must buy more than ``rows`` nodes stops with bad = -2
    in the plain version (as the kernel does), and the wrapper raises."""
    args = _walk_args()
    out = ref.two_phase_ref(*args.values(), T=2, quantum=1e9,
                            similarity=True, sequential=sequential, rows=0)
    w, bad, steps, phase, node = kstep.split_walk(out.numpy(), 1, 2)
    assert (w.tolist(), bad.tolist(), steps.tolist()) == ([0], [-2], [1])
    assert phase.tolist() == [-1, -1] and node.tolist() == [-1, -1]
    with pytest.raises(ValueError, match="rows=0"):
        kstep.two_phase_walk(**args, T=2, quantum=1e9, similarity=True,
                             sequential=sequential, rows=0)


@pytest.mark.parametrize("similarity,want", [
    # first fit: task 1 meets node 0's violation at its first element, task
    # 2 stops at node 0, which fits (4 elements)
    (False, {"scored": 1 + 4, "similar": 0, "debited": 3 * 4}),
    # similarity: task 2 compares and scores both feasible nodes
    (True, {"scored": 1 + 8, "similar": 8, "debited": 3 * 4}),
])
def test_plain_version_tallies_the_work_the_walk_needs(similarity, want):
    i32, f64 = torch.int32, torch.float64
    work: dict = {}
    out = ref.two_phase_ref(
        torch.tensor([0, 1, 2], dtype=i32),
        torch.tensor([[0, 3, 3]], dtype=i32), torch.ones((1, 2), dtype=f64),
        torch.tensor([[0.6, 0.6], [0.6, 0.6], [0.3, 0.3]], dtype=f64),
        torch.zeros(3, dtype=i32), torch.ones(3, dtype=i32),
        torch.ones(3, dtype=f64), T=2, quantum=1e9, similarity=similarity,
        sequential=True, rows=3, work=work)
    assert kstep.split_walk(out.numpy(), 1, 3)[4].tolist() == [0, 1, 0]
    assert work == want


@pytest.mark.parametrize("field,value,error", [
    ("dem", torch.full((2, 2), 0.3, dtype=torch.float32), TypeError),
    ("walk", torch.tensor([0, 1], dtype=torch.int64), TypeError),
    ("bounds", torch.zeros((1, 2), dtype=torch.int32), ValueError),
    ("dn", torch.ones(3, dtype=torch.float64), ValueError),
    ("cap", torch.ones((1, 2), dtype=torch.float64, device="meta"),
     ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(field, value, error):
    args = _walk_args()
    args[field] = value
    with pytest.raises(error):
        _walk(args)


def test_wrapper_rejects_a_device_it_cannot_run_on():
    args = {k: v.to("meta") for k, v in _walk_args().items()}
    with pytest.raises(ValueError, match="unsupported device"):
        _walk(args)


def test_kernel_route_rejects_a_mapping_outside_the_catalogue():
    p, mapping = _instance("table", 0)
    mapping = mapping.copy()
    mapping[0] = p.node_types.m
    with pytest.raises(ValueError, match="node-types"):
        t_two_phase(problem_from_arrays(p), mapping, backend="kernel",
                    device="cpu")
