"""Tolerance mode at Table-I scale on the CPU: how far the port's tol solve
lies from the reference's, beside how far the reference's own two operators
lie from each other.

Four Table-I instances (n=1000, m=10, D=5, T=24; seeds 10-13) are solved
in tol mode (``tol=5e-3``, ``iters=4000``, the mixed-precision defaults):
by the port with ``operator="dense"``, and by the reference with ``dense``
and with ``cumsum`` (the reference's tol mode needs
``jax.experimental.enable_x64``, which the installed jax lacks; the
module-scoped ``x64_alias`` fixture supplies it, as in
``tests/test_torch_tol.py``).  Every mapping is then placed by the same
host code (the reference's numpy lockstep engine, lp-map and lp-map-f, both
fit policies), so a cost differs only where a mapping does.

A tolerance-stopped iterate of these degenerate LPs rounds differently
under another summation order, and the reference's ratio-test reductions on
the CPU follow XLA's code generation (a windowed tree reduction for the
primal movement, reassociated multiply-add chains for the dual movement and
the interaction), which a torch port does not reproduce.  Exact agreement
does not hold at this scale; what holds, and is asserted:

  * every lane converged in all three runs;
  * each run's certified lower bound lies below the other run's objective,
    and the objectives lie within the gap two tol-converged solves can show
    (``tol * (2 + |primal| + |dual|)`` summed over both);
  * the port's spread against the reference (flipped task mappings, and
    instances whose lp-map or lp-map-f cost differs) is no larger than the
    reference's own ``dense`` against ``cumsum``;
  * the port's largest relative cost and bound gaps against the reference
    stay at their recorded readings (``GAP_LIMITS``).  They are larger than
    the reference's own on these seeds, for a cause not yet found
    (``ROADMAP.md`` Queue 3), so they are held where they stand.

Both runs are deterministic on the CPU (the same readings under 1, 3 and 8
threads, and for these seeds inside a batch of 16).  Run as a script to
measure the same spreads over more seeds, with the port's own ``dense``
against ``cumsum`` beside them::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_tol_scale.py 10 26
"""

import sys

import jax
import jax.experimental
import numpy as np
import pytest

import repro.core as J
from repro.core import batch as jbatch
from repro.workload import SyntheticSpec, synthetic_instance
from repro_torch.convert import problem_from_arrays
from repro_torch.core import batch as tbatch

TOL = 5e-3
CAP = 4000
SEEDS = (10, 11, 12, 13)
ALGOS = ("lp-map", "lp-map-f")
# the port's gaps against the reference dense on SEEDS, read on the CPU:
# costs 2.2165e-2 (lp-map) and 1.7818e-2 (lp-map-f), bounds 1.4645e-3
GAP_LIMITS = {"max_rel_cost": [2.3e-2, 1.8e-2], "max_rel_bound": 1.5e-3}


def _enable_x64():
    return jax.enable_x64(True)


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", _enable_x64,
                   raising=False)
        yield


def _costs(batch, results):
    """(B, 2) best lp-map / lp-map-f costs of the mappings, placed by the
    reference's numpy lockstep engine."""
    maps = [np.asarray(r.mapping) for r in results]
    out = np.full((batch.B, len(ALGOS)), np.inf)
    for j, algo in enumerate(ALGOS):
        for fit in J.FIT_POLICIES:
            sols = J.place_many(batch, maps, fit=fit,
                                filling=algo.endswith("-f"))
            for b, (t, s) in enumerate(zip(batch.problems, sols)):
                out[b, j] = min(out[b, j], s.cost(t))
    return out


def _solve(seeds, port_cumsum=False) -> dict:
    probs = [J.trim_timeline(synthetic_instance(SyntheticSpec(seed=s)))[0]
             for s in seeds]
    batch = J.pack_problems(probs, assume_trimmed=True)
    kw = dict(tol=TOL, iters=CAP)
    ported = [problem_from_arrays(p) for p in probs]
    out = {
        "port": tbatch.solve_lp_many(ported, operator="dense", device="cpu",
                                     **kw),
        "ref dense": jbatch.solve_lp_many(probs, operator="dense", **kw),
        "ref cumsum": jbatch.solve_lp_many(probs, operator="cumsum", **kw),
    }
    if port_cumsum:
        out["port cumsum"] = tbatch.solve_lp_many(
            ported, operator="cumsum", device="cpu", **kw)
    return {name: (res, _costs(batch, res)) for name, res in out.items()}


@pytest.fixture(scope="module")
def runs(x64_alias):
    return _solve(SEEDS)


def _spread(a, b) -> dict:
    (ra, ca), (rb, cb) = a, b
    lb_a = np.array([r.lower_bound for r in ra])
    lb_b = np.array([r.lower_bound for r in rb])
    rel_cost = np.abs(ca - cb) / cb
    rel_bound = np.abs(lb_a - lb_b) / lb_b
    return {
        "flips": int(sum((x.mapping != y.mapping).sum()
                         for x, y in zip(ra, rb))),
        "instances": [int(v) for v in (ca != cb).sum(axis=0)],
        "max_rel_cost": [float(v) for v in rel_cost.max(axis=0)],
        "mean_rel_cost": [float(v) for v in rel_cost.mean(axis=0)],
        "max_rel_bound": float(rel_bound.max()),
        "median_rel_bound": float(np.median(rel_bound)),
        "bound_below": int((lb_a < lb_b).sum()),
    }


@pytest.mark.parametrize("name", ["port", "ref dense", "ref cumsum"])
def test_every_lane_converged(runs, name):
    res, costs = runs[name]
    assert all(r.converged for r in res)
    assert np.isfinite(costs).all()


@pytest.mark.parametrize("pair", [("port", "ref dense"),
                                  ("port", "ref cumsum"),
                                  ("ref dense", "ref cumsum")])
def test_certified_bounds_cross(runs, pair):
    ra, rb = runs[pair[0]][0], runs[pair[1]][0]
    for i, (a, b) in enumerate(zip(ra, rb)):
        assert a.lower_bound <= b.objective, i
        assert b.lower_bound <= a.objective, i
        slack = TOL * (2.0 + a.objective + a.lower_bound + b.objective
                       + b.lower_bound)
        assert abs(a.objective - b.objective) <= slack, i


def test_port_spread_within_the_references_own(runs):
    port = _spread(runs["port"], runs["ref dense"])
    own = _spread(runs["ref dense"], runs["ref cumsum"])
    print(f"\ntol scale, seeds {SEEDS}: port vs ref dense {port}; "
          f"ref dense vs ref cumsum {own}")
    assert own["flips"] > 0  # the reference itself is not exact here
    assert port["flips"] <= own["flips"]
    assert sum(port["instances"]) <= sum(own["instances"])


def test_port_gaps_hold_at_their_recorded_readings(runs):
    port = _spread(runs["port"], runs["ref dense"])
    for j, algo in enumerate(ALGOS):
        assert port["max_rel_cost"][j] <= GAP_LIMITS["max_rel_cost"][j], algo
    assert port["max_rel_bound"] <= GAP_LIMITS["max_rel_bound"]


if __name__ == "__main__":
    jax.experimental.enable_x64 = _enable_x64
    lo, hi = (int(v) for v in sys.argv[1:3])
    got = _solve(range(lo, hi), port_cumsum=True)
    for a, b in [("port", "ref dense"), ("port cumsum", "ref cumsum"),
                 ("ref dense", "ref cumsum"), ("port", "port cumsum")]:
        print(f"seeds {lo}-{hi - 1}, {a} vs {b}: {_spread(got[a], got[b])}")
    for name, (res, _) in got.items():
        gap = [(r.objective - r.lower_bound) / r.objective for r in res]
        print(f"seeds {lo}-{hi - 1}, {name}: certified gap median "
              f"{np.median(gap)}, max {np.max(gap)}")
