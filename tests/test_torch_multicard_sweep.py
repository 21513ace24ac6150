"""The sweep pipeline sharded over devices (``SweepConfig(devices=k)``) on
the CPU: the port's k shards against its own unsharded pipeline and against
the reference's ``shard_map`` over k forced host devices.

On the CPU the port runs its k lane shards one after another
(``device="cpu"``), the counterpart of the reference's forced host devices.

Tolerances:
  * sharded against unsharded, in the port: lane for lane, iterations,
    restarts and convergence equal, ``x``, objectives, bounds and the final
    state bit-equal (every lane's arithmetic is its own: nothing in the
    tol core is reduced across lanes, and converged lanes are frozen);
  * against the reference's ``devices=4`` run: the bounds of
    ``tests/test_torch_tol.py``'s pipeline parity (canonical mappings and
    protocol costs equal, objectives within ``_objective_slack``).

The reference runs in a subprocess, where ``XLA_FLAGS`` can force four host
devices before JAX starts; its tol mode needs the test-side
``jax.experimental.enable_x64`` alias that ``tests/test_torch_tol.py``
uses, set in that subprocess only.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.workload import SyntheticSpec, sweep_specs, synthetic_batch
from repro_torch.convert import problem_from_arrays
from repro_torch.core import FleetEngine, SolverConfig, SweepConfig
from repro_torch.core import batch as tbatch
from repro_torch.launch import rightsize as cli

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 5e-3
CAP = 4000
ALGOS = ("lp-map", "lp-map-f")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

# two sweep points (n = 24, 28), four seeds each: two groups of four lanes
GRID = "sweep_specs(SyntheticSpec(n=30, m=4, D=3, T=10), seeds=4, n=(24, 28))"

REFERENCE = textwrap.dedent(f"""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.experimental
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    from repro.core import FleetEngine, SolverConfig, SweepConfig
    from repro.core import batch as jbatch
    from repro.workload import SyntheticSpec, sweep_specs, synthetic_batch
    assert jax.local_device_count() == 4
    grid = synthetic_batch({GRID})
    eng = FleetEngine(solver=SolverConfig(tol={TOL}, iters={CAP},
                                          operator="dense"),
                      sweep=SweepConfig(warm_start=4, pipeline=True,
                                        devices=4),
                      algos={ALGOS!r})
    d0 = jbatch.dispatch_count()
    res = eng.evaluate(grid)
    dispatches = jbatch.dispatch_count() - d0
    lp, _ = eng.solve(grid)
    json.dump({{"dispatches": dispatches,
               "costs": [e["costs"] for e in res.entries],
               "lp": [{{"objective": r.objective,
                        "lower_bound": r.lower_bound, "iters": r.iters,
                        "converged": bool(r.converged),
                        "mapping": r.mapping.tolist()}}
                      for r in lp]}}, open(sys.argv[1], "w"))
""")


def _objective_slack(a, b, tol=TOL):
    return tol * (2.0 + a["objective"] + a["lower_bound"]
                  + b["objective"] + b["lower_bound"])


@pytest.fixture(scope="module")
def tgrid():
    return [problem_from_arrays(p) for p in synthetic_batch(eval(GRID))]


def _engine(devices, operator="dense"):
    return FleetEngine(solver=SolverConfig(tol=TOL, iters=CAP,
                                           operator=operator),
                       sweep=SweepConfig(warm_start=4, pipeline=True,
                                         devices=devices),
                       algos=ALGOS, device="cpu")


def _assert_lane_for_lane(got, want):
    (res_g, st_g), (res_w, st_w) = got, want
    assert len(res_g) == len(res_w) and len(st_g) == len(st_w)
    for a, b in zip(res_g, res_w):
        assert (a.iters, a.restarts, a.converged) == (b.iters, b.restarts,
                                                      b.converged)
        assert (a.objective, a.lower_bound, a.kkt) == (b.objective,
                                                       b.lower_bound, b.kkt)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.mapping, b.mapping)
    for a, b in zip(st_g, st_w):
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.restarts, b.restarts)
        np.testing.assert_array_equal(a.converged, b.converged)
    s_g, s_w = st_g[-1].state, st_w[-1].state
    for name in ("x", "y", "eta", "omega"):
        np.testing.assert_array_equal(getattr(s_g, name), getattr(s_w, name))


@pytest.fixture(scope="module")
def unsharded(tgrid):
    """The unsharded pipeline's ``solve`` per operator form, on demand."""
    cache = {}

    def get(operator):
        if operator not in cache:
            cache[operator] = _engine(None, operator).solve(tgrid)
        return cache[operator]
    return get


# "pallas" is the card's route (congestion_lp); on the CPU its plain version
@pytest.mark.parametrize("devices,operator", [(2, "dense"), (4, "pallas")])
def test_sharded_sweep_equals_unsharded(tgrid, unsharded, devices, operator):
    d0 = tbatch.dispatch_count()
    got = _engine(devices, operator).solve(tgrid)
    assert tbatch.dispatch_count() - d0 == 1
    _assert_lane_for_lane(got, unsharded(operator))


def test_sharded_sweep_against_reference(tgrid, tmp_path):
    out = tmp_path / "reference.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", REFERENCE, str(out)], env=env,
                   check=True, timeout=300)
    ref = json.loads(out.read_text())
    assert ref["dispatches"] == 1
    d0 = tbatch.dispatch_count()
    res = _engine(4).evaluate(tgrid)
    assert tbatch.dispatch_count() - d0 == 1
    assert len(res.lp_results) == len(ref["lp"]) == 8
    for r, w in zip(res.lp_results, ref["lp"]):
        assert r.converged and w["converged"]
        np.testing.assert_array_equal(r.mapping, w["mapping"])
        g = {"objective": r.objective, "lower_bound": r.lower_bound}
        assert abs(g["objective"] - w["objective"]) <= _objective_slack(g, w)
    for e, w in zip(res.entries, ref["costs"]):
        assert e["costs"] == w


def test_sharding_errors(tgrid, monkeypatch):
    groups = [tgrid[:4], tgrid[4:]]
    with pytest.raises(ValueError, match="divide the group size"):
        tbatch._sweep_impl(groups, pipeline=True, devices=3, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        tbatch._sweep_impl(groups, pipeline=True, devices=0, device="cpu")
    with pytest.raises(ValueError, match="divide the group size"):
        _engine(8).solve(tgrid)
    # on the card: more shards than visible cards raises, naming the count,
    # before anything is placed on a card; nothing moves to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    d0 = tbatch.dispatch_count()
    with pytest.raises(ValueError, match=r"devices=2 exceeds the 1 visible"):
        tbatch._sweep_impl(groups, pipeline=True, devices=2)
    with pytest.raises(ValueError, match=r"devices=4 exceeds the 1 visible"):
        FleetEngine(solver=SolverConfig(tol=TOL),
                    sweep=SweepConfig(warm_start=4, pipeline=True,
                                      devices=4)).solve(tgrid)
    assert tbatch.dispatch_count() == d0


def test_cli_fleet_shards_on_the_cpu():
    argv = ["fleet", "-n", "4", "--buckets", "1", "--lp-tol", "5e-3",
            "--warm-start", "2", "--pipeline", "--device", "cpu"]
    outs = []
    for extra in ([], ["--devices", "2"]):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            result = cli.run(argv + extra)
        outs.append((text.getvalue(), result))
    (plain, r1), (sharded, r2) = outs
    assert "one warm-started sweep chain" in sharded
    # the cost table is the same; the timing line is not
    assert plain.split("demand x")[1] == sharded.split("demand x")[1]
    assert [e["costs"] for e in r1.entries] == [e["costs"] for e in r2.entries]
    assert [r.iters for r in r1.lp_results] == [r.iters for r in r2.lp_results]


def test_card_shards_interleave(monkeypatch):
    """On cards every shard queues its next chunk before the next round of
    host reads: the shards' steps alternate from one host thread, a shard
    that ends drops out, and the results come back in shard order."""
    log = []

    def steps(d, lanes):
        for chunk in range(lanes.stop - lanes.start):
            log.append((d.index, chunk))
            yield
        return f"shard {d.index}"

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    shards = [(torch.device("cuda", i), slice(0, n))
              for i, n in enumerate((2, 1, 3))]
    assert tbatch._run_shards(steps, shards) == ["shard 0", "shard 1",
                                                 "shard 2"]
    assert log == [(0, 0), (1, 0), (2, 0), (0, 1), (2, 1), (2, 2)]
