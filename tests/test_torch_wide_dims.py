"""Wide constrained instances on the CPU: the port against the reference.

Every instance is ``synthetic_instance`` with exclusive tasks and
anti-affinity pairs drawn by ``np.random.default_rng(2000 + seed)`` over
disjoint tasks (``wide_instance``, as ``chip_smoke.py`` phase 10c draws
them); each pair lowers to one unit-capacity dimension and the exclusive
set to one more, so D = 3 + 1 + 40 = 44 and 3 + 1 + 270 = 274 here (phase
10c's D = 276 and m * D = 8280 on the card).  On the card these shapes pass
the steppers' old D <= 32 and D <= 256 and the congestion kernel's old
m * D <= 8192 limits; on the CPU every kernel wrapper runs its plain
version, so these tests hold the CPU side of those paths:

* ``rightsize`` for the four algorithms, ``backend="numpy"`` and
  ``backend="kernel"`` (``ref.two_phase_ref`` here), against the
  reference's: costs and ``assign`` equal, 0 ``check_plan`` violations;
* ``FleetEngine(device="cpu")`` against the reference's ``FleetEngine()``
  (legacy LP, batched placement) at D = 274: lower bounds within rel 1e-4,
  costs within rel 1e-5, and, given the reference's LP mappings, the
  compiled route's plain version (``ref.sub_phase_ref``) placing exactly as
  the reference's numpy lockstep engine;
* ``congestion_lp`` and ``congestion_many`` at m * D = 8280 against the
  reference's Pallas kernel in interpret mode, within 1e-5 of the output's
  max |value| (float32 sums in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import batch as jbatch
from repro.kernels.congestion import congestion_many_pallas
from repro.workload import SyntheticSpec, synthetic_instance
from repro_torch import core as P
from repro_torch.convert import problem_from_arrays
from repro_torch.kernels import congestion as tcong

LB_RTOL = 1e-4
COST_RTOL = 1e-5
CONG_TOL = 1e-5


def wide_instance(n, m, D, T, seed, pairs, exclusive):
    """The reference's Table-I-style instance with ``pairs`` anti-affinity
    pairs and ``exclusive`` exclusive tasks over disjoint tasks drawn by
    ``np.random.default_rng(2000 + seed)``."""
    p = synthetic_instance(SyntheticSpec(n=n, m=m, D=D, T=T, seed=seed))
    rng = np.random.default_rng(2000 + seed)
    pool = list(rng.permutation(p.n))

    def pop(k):
        return [int(pool.pop()) for _ in range(k)]

    anti = {f"anti{g}": pop(2) for g in range(pairs)}
    c = J.TaskConstraints.from_groups(p.n, anti_affinity=anti,
                                      exclusive=pop(exclusive))
    return dataclasses.replace(p, constraints=c)


@pytest.fixture(scope="module")
def d44():
    ref = wide_instance(120, 4, 3, 12, 0, pairs=40, exclusive=4)
    assert J.lower_constraints(ref).lowered.D == 44
    return ref, problem_from_arrays(ref), {}


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("algo", J.ALGORITHMS)
def test_rightsize_at_44_dimensions(d44, algo, backend):
    ref, port, cache = d44
    if algo not in cache:
        cache[algo] = J.rightsize(ref, algo)
    want = cache[algo]
    got = P.rightsize(port, algo, backend=backend, device="cpu")
    assert got.cost(port) == want.cost(ref)
    assert np.array_equal(got.assign, want.assign)
    assert np.array_equal(got.node_type, want.node_type)
    assert P.check_plan(port, got) == []


@pytest.fixture(scope="module")
def d274():
    refs = [wide_instance(600, 3, 3, 8, s, pairs=270, exclusive=4)
            for s in range(2)]
    assert {J.lower_constraints(p).lowered.D for p in refs} == {274}
    ports = [problem_from_arrays(p) for p in refs]
    want = J.FleetEngine().evaluate(refs)
    got = P.FleetEngine(device="cpu").evaluate(ports)
    return refs, ports, want, got


@pytest.fixture(scope="module")
def d274_lowered(d274):
    """The lowered, trimmed instances of both packages and the reference's
    own legacy LP mappings of them."""
    refs, ports, _, _ = d274
    lowered_ref = [J.trim_timeline(J.lower_constraints(p).lowered)[0]
                   for p in refs]
    lowered = [P.trim_timeline(P.lower_constraints(p).lowered)[0]
               for p in ports]
    maps = [np.asarray(r.mapping) for r in J.solve_lp_many(lowered_ref)]
    return lowered_ref, lowered, maps


def test_fleet_at_274_dimensions(d274):
    _, _, want, got = d274
    for g, w in zip(got.entries, want.entries):
        assert abs(g["lb"] / w["lb"] - 1) <= LB_RTOL
        assert list(g["costs"]) == list(w["costs"])
        for algo, c in w["costs"].items():
            assert abs(g["costs"][algo] / c - 1) <= COST_RTOL, algo


@pytest.mark.parametrize("filling", [False, True])
@pytest.mark.parametrize("fit", ["first", "similarity"])
def test_compiled_plain_version_places_as_the_reference(d274_lowered, fit,
                                                        filling):
    lowered_ref, lowered, maps = d274_lowered
    expect = J.place_many(lowered_ref, maps, fit=fit, filling=filling)
    tel: dict = {}
    placed = P.place_many(lowered, maps, fit=fit, filling=filling,
                          placement="compiled", telemetry=tel, device="cpu")
    assert tel["engine"] == "compiled" and "fallback" not in tel, tel
    for a, b in zip(placed, expect):
        assert np.array_equal(a.assign, b.assign)
        assert np.array_equal(a.node_type, b.node_type)


def _spans(rng, G, n, T):
    start = rng.integers(0, T, (G, n)).astype(np.int32)
    end = np.minimum(start + rng.integers(0, T, (G, n)), T - 1)
    return start, end.astype(np.int32)


def test_congestion_lp_past_one_column_tile():
    rng = np.random.default_rng(8280)
    B, n, m, D, Tp = 1, 12, 30, 276, 8
    start, end = _spans(rng, B, n, Tp)
    w = rng.random((B, n, m, D)).astype(np.float32)
    x = rng.random((B, n, m)).astype(np.float32)
    fwd, _ = jbatch._make_operators(jnp.asarray(w), jnp.asarray(start),
                                    jnp.asarray(end), Tp, "pallas")
    want = np.asarray(fwd(jnp.asarray(x)))
    got = tcong.congestion_lp(*(torch.from_numpy(a)
                                for a in (start, end, w, x)), Tp)
    assert tcong.column_tiles(m * D, Tp)[1] > 1
    assert got.shape == (B, Tp, m, D)
    assert np.abs(got.numpy() - want).max() <= CONG_TOL * np.abs(want).max()


def test_congestion_many_past_one_column_tile():
    rng = np.random.default_rng(8281)
    G, n, K, T = 2, 12, 8280, 8
    start, end = _spans(rng, G, n, T)
    start[:, 0], end[:, 0] = 1, 0  # a never-active padding task
    w = rng.random((G, n, K)).astype(np.float32)
    want = np.asarray(congestion_many_pallas(
        jnp.asarray(start), jnp.asarray(end), jnp.asarray(w), T,
        interpret=True))
    got = tcong.congestion_many(*(torch.from_numpy(a)
                                  for a in (start, end, w)), T)
    assert got.shape == (G, T, K)
    assert np.abs(got.numpy() - want).max() <= CONG_TOL * np.abs(want).max()
