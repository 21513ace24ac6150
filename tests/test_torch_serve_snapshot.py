"""Snapshots of the serving loop across the two packages, on the CPU.

A snapshot (``serve.snapshot``: a JSON manifest and an npz blob with a
SHA-256 checksum) written by either package restores in the other: that is
how a live reference service moves into the port, and back.  Under
``precision="f64"`` (``operator="cumsum"``) the two services tick alike
(``tests/test_torch_serve.py``), so a replay that crashes in one package and
finishes in the other adopts the same plans as an uninterrupted replay in
either, bit for bit: ``total_cost``, ``proposed_cost_total``, every fleet's
plan and every scale event.  Warm states round-trip bit for bit (float32
``x`` and ``y``; ``eta`` and ``omega`` as Python floats).  The port's own
``replay_with_crash`` matches its own uninterrupted replay, and a corrupt
snapshot raises ``SnapshotError`` in both packages.

The reference's tick needs ``jax.experimental.enable_x64``, which the
installed jax lacks: the module-scoped ``x64_alias`` fixture supplies it, as
in ``tests/test_torch_tol.py``.
"""

import jax
import jax.experimental
import numpy as np
import pytest

import repro.core as J
import repro.serve as JS
import repro_torch.core as P
import repro_torch.serve as PS

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

PKGS = {"ref": JS, "port": PS}
SPEC = dict(fleets=2, requests=24, n0=12, m=3, seed=0)
PUSH = 4
CRASH_AFTER = 3


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


def _engine(pkg):
    if pkg == "ref":
        return J.FleetEngine(solver=J.SolverConfig(
            tol=5e-3, iters=4000, precision="f64", operator="cumsum"),
            algos=("lp-map-f",))
    return P.FleetEngine(solver=P.SolverConfig(
        tol=5e-3, iters=4000, precision="f64", operator="cumsum"),
        algos=("lp-map-f",), device="cpu")


def _service(pkg):
    return PKGS[pkg].RightsizingService(engine=_engine(pkg))


def _trace():
    return PS.gct_trace(PS.TraceSpec(**SPEC))


def _outcome(svc) -> dict:
    """What a replay adopted: the deterministic report fields, every
    fleet's plan and cost, and the scale-event log."""
    rep = svc.report()
    return {
        "total_cost": rep["total_cost"],
        "proposed_cost_total": rep["proposed_cost_total"],
        "ticks": rep["ticks"], "requests": rep["requests"],
        "plans": {f: (svc.fleet(f).plan.tolist(), svc.fleet(f).plan_cost)
                  for f in svc.fleets},
        "events": [e.to_dict() for e in svc.events],
    }


def _crash_across(src: str, dst: str, path) -> dict:
    """``replay_with_crash`` with the restore in the other package: the
    trace runs ``CRASH_AFTER`` ticks in ``src``, the service is
    snapshotted and dropped, and ``dst`` restores it (queue included) and
    feeds it the rest of the same trace, generated by ``dst``."""
    trace = _trace()
    svc = _service(src)
    i = ticks = 0
    while ticks < CRASH_AFTER:
        for req in trace[i:i + PUSH]:
            svc.submit(req)
        i += PUSH
        svc.tick()
        ticks += 1
    svc.snapshot(str(path))
    del svc
    svc = PKGS[dst].RightsizingService.restore(str(path),
                                               engine=_engine(dst))
    rest = PKGS[dst].gct_trace(PKGS[dst].TraceSpec(**SPEC))[i:]
    PKGS[dst].replay(svc, rest, push_per_tick=PUSH)
    return _outcome(svc)


@pytest.fixture(scope="module")
def uninterrupted(x64_alias):
    out = {}
    for pkg, S in PKGS.items():
        svc = _service(pkg)
        S.replay(svc, S.gct_trace(S.TraceSpec(**SPEC)), push_per_tick=PUSH)
        out[pkg] = _outcome(svc)
    return out


def test_uninterrupted_replays_agree(uninterrupted):
    assert uninterrupted["port"] == uninterrupted["ref"]
    assert uninterrupted["ref"]["ticks"] > CRASH_AFTER


@pytest.mark.parametrize("src,dst", [("port", "ref"), ("ref", "port")])
def test_snapshot_restores_across_and_replays_bit_equal(src, dst, tmp_path,
                                                        uninterrupted):
    got = _crash_across(src, dst, tmp_path / "snap")
    assert got == uninterrupted[dst]
    assert got == uninterrupted[src]


@pytest.mark.parametrize("src,dst", [("port", "ref"), ("ref", "port")])
def test_warm_states_round_trip_bit_for_bit(src, dst, tmp_path):
    S = PKGS[src]
    svc = _service(src)
    S.replay(svc, S.gct_trace(S.TraceSpec(**SPEC))[:12], push_per_tick=PUSH)
    svc.snapshot(str(tmp_path))
    back = PKGS[dst].RightsizingService.restore(str(tmp_path),
                                                engine=_engine(dst))
    assert back.fleets == svc.fleets
    warm = 0
    for name in svc.fleets:
        a, b = svc._fleets[name], back._fleets[name]
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.plan, b.plan)
        assert a.plan_cost == b.plan_cost
        np.testing.assert_array_equal(a.solution.assign, b.solution.assign)
        if a.warm is None:
            assert b.warm is None
            continue
        warm += 1
        for key in ("x", "y", "ids", "kept"):
            va, vb = getattr(a.warm, key), getattr(b.warm, key)
            assert va.dtype == vb.dtype and va.tobytes() == vb.tobytes()
        assert a.warm.x.dtype == np.float32
        assert type(b.warm.eta) is float and b.warm.eta == a.warm.eta
        assert type(b.warm.omega) is float and b.warm.omega == a.warm.omega
    assert warm > 0
    assert back.queue.dump()[0] == svc.queue.dump()[0]
    assert [t.to_dict() for t in back.ticks] == \
        [t.to_dict() for t in svc.ticks]


def test_port_crash_replay_matches_its_uninterrupted_replay(tmp_path,
                                                            uninterrupted):
    svc = _service("port")
    rep, crashed = PS.replay_with_crash(
        svc, _trace(), crash_after_ticks=CRASH_AFTER,
        snapshot_dir=str(tmp_path), push_per_tick=PUSH)
    assert crashed
    assert rep["total_cost"] == uninterrupted["port"]["total_cost"]
    assert rep["proposed_cost_total"] == \
        uninterrupted["port"]["proposed_cost_total"]
    assert rep["ticks"] == uninterrupted["port"]["ticks"]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_corrupt_snapshot_raises_in_both(writer, tmp_path):
    svc = _service(writer)
    PKGS[writer].replay(svc, _trace()[:8], push_per_tick=PUSH)
    svc.snapshot(str(tmp_path))
    PKGS[writer].corrupt_snapshot(str(tmp_path))
    for pkg, S in PKGS.items():
        with pytest.raises(S.SnapshotError, match="checksum"):
            S.RightsizingService.restore(str(tmp_path), engine=_engine(pkg))

