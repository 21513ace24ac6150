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

``--trace [SEED] [--ref-ruiz]`` follows one lane (default seed 12) check by
check through both solves and stops where they part (see ``_trace``).
"""

import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _trace(seed: int, ref_ruiz: bool = False) -> None:
    """Per-check trace of one lane: the reference's tol solve and the
    port's (``dense``, mixed precision) on the packed batch of ``SEEDS``
    (plus ``seed``), following the lane of ``seed``.  Prints the Ruiz
    scalings and the first step size of both sides, then at every check
    (each ``check_every`` attempts) max |dx| and |dy| in unscaled
    coordinates, eta, omega, restarts and the normalized gaps, and stops
    at the first check where a restart decision, eta or omega differ by
    more than the float32 spacing.  ``ref_ruiz`` hands the port the
    reference's Ruiz scalings, to see where the two part after them."""
    seeds = sorted(set(SEEDS) | {seed})
    lane = seeds.index(seed)
    probs = [J.trim_timeline(synthetic_instance(SyntheticSpec(seed=s)))[0]
             for s in seeds]
    batch = J.pack_problems(probs, assume_trimmed=True)
    statics = dict(max_iters=CAP, check_every=jbatch.DEFAULT_CHECK_EVERY,
                   Tp=batch.Tp, operator="dense", adaptive=True,
                   restart=True, power_iters=12, scaling="ruiz",
                   precision="mixed", omega_on=True)
    fields = ("k", "x", "y", "eta", "omega", "restarts_b", "gap_b",
              "last_gap")

    def reading(vals):
        return {f: (int(v) if f == "k" else np.array(v[lane]))
                for f, v in zip(fields, vals)}

    # reference: every loop carry passes through a host callback
    ref = []
    while_loop = jax.lax.while_loop

    def traced_while(cond, body, init):
        if not isinstance(init, jbatch._TolCarry):
            return while_loop(cond, body, init)

        def record(c):
            jax.debug.callback(lambda *v: ref.append(reading(v)),
                               *(getattr(c, f) for f in fields))

        def body_rec(c):
            c = body(c)
            record(c)
            return c

        record(init)
        return while_loop(cond, body_rec, init)

    with jax.enable_x64(True):
        w = jnp.asarray(batch.weights(), jnp.float32)
        args = (w, jnp.asarray(batch.start), jnp.asarray(batch.end),
                jnp.asarray(batch.feas), jnp.asarray(batch.cost, jnp.float32),
                jnp.float32(0.9), jnp.float32(TOL))
        jax.lax.while_loop = traced_while
        try:
            core = jax.jit(jbatch._tol_core,
                           static_argnames=tuple(statics) + ("power_iters",))
            out = core(*args, **statics)
        finally:
            jax.lax.while_loop = while_loop
        c_ref, r_ref = (np.asarray(a)[lane]
                        for a in jax.jit(jbatch._ruiz_scalings)(w))
    # the callbacks must not have moved the reference off its own run
    plain = jbatch.solve_lp_many(probs, operator="dense", tol=TOL, iters=CAP)
    assert [r.iters for r in plain] == [int(i) for i in out[5]]

    # port: the carry records itself whenever a check sets its mask
    port = []

    class _Carry(tbatch._TolCarry):
        def __setattr__(self, name, value):
            object.__setattr__(self, name, value)
            if (name == "conv" and "dys" in self.__dict__) or (
                    name == "dys" and not port):
                port.append(reading(
                    [self.k] + [getattr(self, f).numpy()
                                for f in fields[1:]]))

    tb = tbatch.pack_problems([problem_from_arrays(p) for p in probs],
                              assume_trimmed=True)
    arrays = tbatch._device_arrays(tb, torch.float32, torch.device("cpu"))
    carry, ruiz = tbatch._TolCarry, tbatch._ruiz_scalings
    tbatch._TolCarry = _Carry
    if ref_ruiz:
        scales = tuple(torch.from_numpy(np.array(a))
                       for a in jax.jit(jbatch._ruiz_scalings)(w))
        tbatch._ruiz_scalings = lambda *_: scales
    try:
        with torch.no_grad():
            tbatch._tol_core(*arrays, tbatch._f32(0.9), tbatch._f32(TOL),
                             **statics)
        c_port, r_port = (a[lane].numpy()
                          for a in tbatch._ruiz_scalings(arrays[0]))
    finally:
        tbatch._TolCarry, tbatch._ruiz_scalings = carry, ruiz
    # XLA compiles a / sqrt(b) (the Ruiz row update) to a * rsqrt(b), and
    # its float32 rsqrt is not the correctly rounded one
    a, b = np.random.default_rng(0).uniform(1e-3, 1e3, (2, 100000)).astype(
        np.float32)
    xla = np.asarray(jax.jit(lambda a, b: a / jnp.sqrt(b))(a, b))
    print(f"a / sqrt(b) compiled by XLA differs from the IEEE quotient in "
          f"{int((xla != a / np.sqrt(b)).sum())} of {a.size} float32 pairs")

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    print(f"seed {seed} (lane {lane} of seeds {seeds}): Ruiz column scales "
          f"differ in {int((c_port != c_ref).sum())} of {c_ref.size} "
          f"(max rel {rel(c_port, c_ref):.3g}), row scales in "
          f"{int((r_port != r_ref).sum())} of {r_ref.size} (max rel "
          f"{rel(r_port, r_ref):.3g}); first eta {ref[0]['eta']:.10g} "
          f"(ref) {port[0]['eta']:.10g} (port)")
    for a, b in zip(ref[1:], port[1:]):
        dx = np.abs(a["x"] / c_ref[:, None] - b["x"] / c_port[:, None]).max()
        dy = np.abs(a["y"] * r_ref[None, :, None]
                    - b["y"] * r_port[None, :, None]).max()
        print(f"check at k={a['k']} (port k={b['k']}): max|dx| {dx:.3g} "
              f"max|dy| {dy:.3g}; eta {a['eta']:.9g} / {b['eta']:.9g}, "
              f"omega {a['omega']:.9g} / {b['omega']:.9g}, restarts "
              f"{a['restarts_b']} / {b['restarts_b']}, gap "
              f"{a['gap_b']:.6g} / {b['gap_b']:.6g}, last restart gap "
              f"{a['last_gap']:.6g} / {b['last_gap']:.6g} (ref / port)")
        apart = [name for name in ("eta", "omega")
                 if abs(a[name] - b[name])
                 > np.spacing(np.float32(a[name]))]
        if a["restarts_b"] != b["restarts_b"]:
            apart.append("restart decision")
        if apart:
            print(f"first parting at k={a['k']}: {', '.join(apart)}")
            break


if __name__ == "__main__":
    jax.experimental.enable_x64 = _enable_x64
    if sys.argv[1:2] == ["--trace"]:
        args = sys.argv[2:]
        _trace(int(args[0]) if args[:1] and args[0].isdigit() else 12,
               ref_ruiz="--ref-ruiz" in args)
        sys.exit(0)
    lo, hi = (int(v) for v in sys.argv[1:3])
    got = _solve(range(lo, hi), port_cumsum=True)
    for a, b in [("port", "ref dense"), ("port cumsum", "ref cumsum"),
                 ("ref dense", "ref cumsum"), ("port", "port cumsum")]:
        print(f"seeds {lo}-{hi - 1}, {a} vs {b}: {_spread(got[a], got[b])}")
    for name, (res, _) in got.items():
        gap = [(r.objective - r.lower_bound) / r.objective for r in res]
        print(f"seeds {lo}-{hi - 1}, {name}: certified gap median "
              f"{np.median(gap)}, max {np.max(gap)}")
