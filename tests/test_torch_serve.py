"""The port's serving loop (``repro_torch.serve``) on the CPU, against the
reference's (``repro.serve``).

The reference's tick runs its tol-mode solve, which imports
``jax.experimental.enable_x64``; the installed jax lacks it, so the
module-scoped ``x64_alias`` fixture supplies it (``jax.enable_x64(True)``
as a context manager), as in ``tests/test_torch_tol.py``.

What is held, and how closely:
  * host modules (requests, the admission queue, shedding, the scale flags,
    the config): the reference's own cases from ``tests/test_serve.py`` run
    against both packages and must give identical outcomes: the same
    exception and message, the same events, the same JSON;
  * traces: ``gct_trace`` and ``jobs_trace`` give the same requests, array
    for array, from the same spec;
  * tick by tick under ``precision="f64"`` (``operator="cumsum"``): the
    chosen fleets, lane modes, per-lane iterations and restarts, adopted
    plans and scale events equal, costs within rel 1e-9, and ``report()``
    equal in every field but the wall-clock ones;
  * under the mixed-precision defaults, where float32 trajectories part
    (``tests/test_torch_tol_scale.py``): every lane converged, one dispatch
    per tick, every adopted plan clean under the reference's oracle, the
    proposed cost total within ``cost_drift_bound_pct`` of the
    reference's, and the lanes, plans and events that differ held at
    their readings;
  * the rest of the service on the port alone: retry and quarantine,
    shedding, deadline misses, a ``constrain`` request, ``preprovision``,
    the reference's latent ``_lane_init`` fault, and errors
    of the engine propagating out of ``tick`` instead of quarantining or
    falling back to a plain version.
"""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest

import repro.core as J
import repro.serve as JS
import repro_torch.core as P
import repro_torch.serve as PS
import repro_torch.stochastic as PST
from repro.core.checker import check_plan as ref_check_plan
from repro_torch.core import check_plan

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

PKGS = {"ref": JS, "port": PS}
CORES = {"ref": J, "port": P}
WALL_KEYS = {"wall_s", "requests_per_s", "p50_replan_s", "p99_replan_s"}
WALL_FIELDS = {"solve_s", "place_s", "total_s"}
F64_SPEC = dict(fleets=2, requests=24, n0=12, m=3, seed=0)
# the reference's paired_replay trace (tests/test_serve.py), cut from 200
# requests to 60: the reference compiles its solve for every padded shape
MIXED_SPEC = dict(fleets=3, requests=60, n0=28, m=5, seed=0)
# mixed-precision readings on the CPU (port against reference, MIXED_SPEC)
MIXED_READINGS = {"lanes_apart": 2, "plans_apart": 1, "events_apart": 1}


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


def _outcome(fn, S):
    """What a case gives under package ``S``: ('ok', value) or the raised
    exception's type name and message."""
    try:
        return ("ok", fn(S))
    except Exception as e:  # the outcome under test
        return (type(e).__name__, str(e))


# --- host modules: the reference's own cases, run against both ----------

def _validation_cases():
    arrive = dict(dem=np.ones((2, 2)), start=np.zeros(2), end=np.ones(2))
    cases = {
        "unknown kind": lambda S: S.Request(fleet="a", kind="shrink"),
        "admit needs catalogue": lambda S: S.Request(
            fleet="a", kind="admit", **arrive),
        "depart needs ids": lambda S: S.Request(fleet="a", kind="depart"),
        "burst needs factor": lambda S: S.Request(
            fleet="a", kind="burst", ids=(1,)),
        "constrain needs ids": lambda S: S.Request(
            fleet="a", kind="constrain", exclusive=True),
        "constrain needs a field": lambda S: S.Request(
            fleet="a", kind="constrain", ids=(0,)),
        "constrain deadline >= 0": lambda S: S.Request(
            fleet="a", kind="constrain", ids=(0,), deadline=-1),
        "arrive counts tasks": lambda S: S.Request(
            fleet="a", kind="arrive", **arrive).n_tasks,
    }
    for factor in (float("inf"), float("nan"), 0.0, -2.0):
        cases[f"factor {factor}"] = (
            lambda S, f=factor: S.Request(fleet="a", kind="burst", ids=(1,),
                                          factor=f))
    for field in ("dem", "start", "end"):
        def nonfinite(S, field=field):
            payload = {k: np.asarray(v, float).copy()
                       for k, v in arrive.items()}
            payload[field].flat[0] = np.nan
            return S.Request(fleet="a", kind="arrive", **payload)
        cases[f"non-finite {field}"] = nonfinite
    for deadline in (0.0, -1.0, float("inf")):
        cases[f"deadline_s {deadline}"] = (
            lambda S, d=deadline: S.Request(fleet="a", kind="replan",
                                            deadline_s=d))
    return cases


def _queue_cases():
    def fifo(S):
        q = S.AdmissionQueue()
        items = [q.push(S.Request(fleet=f, kind="replan"), now_s=float(i))
                 for i, f in enumerate("abcd")]
        first = q.take(2)
        q.requeue(first)
        return ([p.seq for p in first], [p.seq for p in items],
                [p.request.fleet for p in q.take(4)])

    def coalesce(S):
        q = S.AdmissionQueue()
        items = [q.push(S.Request(fleet=f, kind="replan"), now_s=0.0)
                 for f in "babca"]
        groups = S.AdmissionQueue.coalesce(items)
        return {k: [p.seq for p in v] for k, v in groups.items()}

    def backlog(S):
        q = S.AdmissionQueue()
        for i in range(6):
            q.push(S.Request(fleet=f"f{i}", kind="burst", ids=(0,),
                             factor=1.5), now_s=0.0)
        return [e.to_dict() for e in q.shed(now_s=100.0, max_pending=2,
                                            tick=0)], q.pending

    def expired(S):
        q = S.AdmissionQueue()
        q.push(S.Request(fleet="a", kind="replan", deadline_s=1.0),
               now_s=0.0)
        q.push(S.Request(fleet="b", kind="replan"), now_s=0.0)
        return [e.to_dict() for e in q.shed(now_s=50.0, max_pending=10,
                                            tick=3)], q.pending

    def coalesced(S):
        q = S.AdmissionQueue()
        q.push(S.Request(fleet="a", kind="replan"), now_s=0.0)
        q.push(S.Request(fleet="a", kind="burst", ids=(0,), factor=1.5),
               now_s=0.0)
        q.push(S.Request(fleet="b", kind="replan"), now_s=0.0)
        return [e.to_dict() for e in q.shed(now_s=1.0, max_pending=2,
                                            tick=0)], q.pending

    def pressure(S):
        q = S.AdmissionQueue()
        for i in range(4):
            q.push(S.Request(fleet=f"f{i}", kind="replan"), now_s=float(i))
        return [e.to_dict() for e in q.shed(now_s=10.0, max_pending=2,
                                            tick=0)], q.pending

    def round_trip(S):
        e = S.ShedEvent(tick=2, seq=7, fleet="a", kind="replan",
                        reason="pressure", waited_s=1.25)
        return S.ShedEvent.from_dict(e.to_dict()) == e, e.to_dict()

    cases = {"fifo take and front requeue": fifo,
             "coalesce by fleet": coalesce,
             "state-changing backlog kept": backlog,
             "expired replans shed": expired,
             "coalesced wave": coalesced,
             "pressure wave, stalest first": pressure,
             "shed event JSON round trip": round_trip}
    for kind in JS.NEVER_SHED_KINDS:
        cases[f"shed event refuses {kind}"] = (
            lambda S, k=kind: S.ShedEvent(tick=0, seq=0, fleet="a", kind=k,
                                          reason="pressure", waited_s=0.0))
    return cases


def _scale_cases():
    cost = np.array([1.0, 3.0])

    def decide(current, required, tick, last, **cfg):
        def run(S):
            base = dict(scale_in_cooldown=3, min_scale_in_savings=0.02,
                        payback_ticks=12, reconfig_weight=0.5)
            base.update(cfg)
            d = S.evaluate_scale(
                None if current is None else np.array(current),
                np.array(required), cost, tick=tick, last_scale_in_tick=last,
                cfg=S.ServiceConfig(**base))
            event = S.ScaleEvent(tick=tick, fleet="f", scope=d.scope,
                                 cost_before=10.0, cost_after=d.cost,
                                 checks=d.checks)
            return (d.scope, d.adopted.tolist(), d.cost, d.scaled_in,
                    event.to_dict(),
                    S.ScaleEvent.from_dict(event.to_dict()).to_dict())
        return run

    return {
        "fresh fleet admits": decide(None, [2, 1], 0, -10),
        "growth never gated": decide([1, 1], [3, 1], 0, 0),
        "cooldown holds": decide([4, 2], [2, 2], 5, 3),
        "cooldown releases": decide([4, 2], [2, 2], 6, 3),
        "savings threshold": decide([4, 2], [3, 2], 20, 0,
                                    min_scale_in_savings=0.5),
        "payback rejects thrash": decide([4, 2], [3, 2], 20, 0,
                                         payback_ticks=1,
                                         reconfig_weight=10.0),
        "scale-in event log": decide([4, 2], [2, 2], 9, 0),
    }


def _config_cases():
    def frozen(S):
        cfg = S.ServiceConfig()
        with pytest.raises(dataclasses.FrozenInstanceError):
            cfg.warm_start = False
        return (dataclasses.asdict(cfg),
                dataclasses.replace(cfg, warm_start=False).warm_start)

    cases = {"frozen and replaceable": frozen}
    for field, value in [("max_requests_per_tick", 0),
                         ("max_shape_drift", 1.5), ("payback_ticks", 0),
                         ("max_pending", 0), ("max_request_retries", -1),
                         ("max_buckets", 0), ("bucket_overhead", -1.0),
                         ("cost_drift_bound_pct", -1.0),
                         ("reconfig_weight", -1.0),
                         ("scale_in_cooldown", -1),
                         ("min_scale_in_savings", 1.0),
                         ("shape_quantum", 0)]:
        cases[f"{field}={value}"] = (
            lambda S, f=field, v=value: S.ServiceConfig(**{f: v}))
    return cases


def _fault_cases():
    def injector(S):
        inj = S.FaultInjector([S.FaultSpec(kind="verify-fail", fleet="a",
                                           tick=2, times=1)])
        fired = [inj.fire("verify-fail", fleet="b", tick=2),
                 inj.fire("verify-fail", fleet="a", tick=3),
                 inj.fire("nonconverge", fleet="a", tick=2),
                 inj.fire("verify-fail", fleet="a", tick=2),
                 inj.fire("verify-fail", fleet="a", tick=2)]
        return fired, inj.fired

    return {"injector matching and budget": injector,
            "fault kind checked": lambda S: S.FaultSpec(kind="oom"),
            "fault budget checked": lambda S: S.FaultSpec(kind="nonconverge",
                                                          times=0)}


HOST_CASES = {**{f"request: {k}": v for k, v in _validation_cases().items()},
              **{f"queue: {k}": v for k, v in _queue_cases().items()},
              **{f"scale: {k}": v for k, v in _scale_cases().items()},
              **{f"config: {k}": v for k, v in _config_cases().items()},
              **{f"faults: {k}": v for k, v in _fault_cases().items()}}

# the reference's own expectations (tests/test_serve.py) for the cases that
# raise: the message each must name
EXPECTED_ERRORS = {
    "request: unknown kind": "request kind must be one of",
    "request: admit needs catalogue": "admit requests need node_types and T",
    "request: depart needs ids": "non-empty ids tuple",
    "request: burst needs factor": "ids and factor",
    "request: constrain needs ids": "non-empty ids tuple",
    "request: constrain needs a field": "at least one of affinity",
    "request: constrain deadline >= 0": "deadline must be a slot index >= 0",
    "config: max_requests_per_tick=0": "max_requests_per_tick must be >= 1",
    "config: max_shape_drift=1.5": "max_shape_drift must be in [0, 1]",
    "config: payback_ticks=0": "payback_ticks must be >= 1",
    "faults: fault kind checked": "fault kind must be one of",
    "faults: fault budget checked": "times must be >= 1",
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_modules_match_the_reference(case):
    ref = _outcome(HOST_CASES[case], JS)
    port = _outcome(HOST_CASES[case], PS)
    assert port == ref
    if case in EXPECTED_ERRORS:
        assert ref[0] == "ValueError" and EXPECTED_ERRORS[case] in ref[1]
    if case.startswith("request: factor") or case.startswith(
            "request: non-finite") or case.startswith("request: deadline_s"):
        assert ref[0] == "ValueError"
    if case.startswith("queue: shed event refuses"):
        assert "only ever name" in ref[1]


# --- traces --------------------------------------------------------------

def _request_arrays(r) -> dict:
    out = {"fleet": r.fleet, "kind": r.kind, "T": r.T, "ids": r.ids,
           "factor": r.factor}
    for name in ("dem", "start", "end"):
        v = getattr(r, name)
        out[name] = None if v is None else (np.asarray(v).dtype.str,
                                            np.asarray(v).tobytes())
    if r.node_types is not None:
        out["node_types"] = (r.node_types.cap.tobytes(),
                             r.node_types.cost.tobytes(),
                             tuple(r.node_types.names))
    return out


@pytest.mark.parametrize("kind,spec", [
    ("gct", dict(fleets=2, requests=24, n0=12, m=3, seed=0)),
    ("gct", dict(fleets=3, requests=60, n0=28, m=5, seed=1)),
    ("gct", dict(fleets=16, requests=160, n0=1000, m=10, seed=0)),
    ("jobs", dict(fleets=2, n0=0)),
    ("jobs", dict(fleets=3, requests=40, n0=0, seed=4)),
    ("jobs", dict(fleets=1, requests=30, n0=0, seed=9, max_batch=3)),
])
def test_traces_equal_array_for_array(kind, spec):
    traces = [getattr(S, f"{kind}_trace")(S.TraceSpec(**spec))
              for S in (JS, PS)]
    assert len(traces[0]) == len(traces[1]) == spec.get("requests", 200)
    for a, b in zip(*traces):
        assert _request_arrays(a) == _request_arrays(b)


# --- tick by tick ----------------------------------------------------------

def _engine(pkg, **solver):
    C = CORES[pkg]
    kw = {} if pkg == "ref" else {"device": "cpu"}
    return C.FleetEngine(solver=C.SolverConfig(tol=5e-3, iters=4000, **solver),
                         algos=("lp-map-f",), **kw)


def _replay_ticks(pkg, spec, push, **solver):
    """``replay`` of the trace of ``spec``, reading the service after each
    tick: the tick record, each lane's mode, iterations and restarts, and
    every fleet's adopted plan."""
    S = PKGS[pkg]
    svc = S.RightsizingService(engine=_engine(pkg, **solver))
    solves = []
    solve = svc.engine.solve

    def recorded(batch, init=None):
        res, stats = solve(batch, init=init)
        solves.append([(int(i), int(r)) for st in stats
                       for i, r in zip(st.iterations, st.restarts)])
        return res, stats

    svc.engine.solve = recorded
    lane_init = svc._lane_init
    modes: list[str] = []

    def mode_of(*args):
        out = lane_init(*args)
        modes.append(out[0])
        return out

    svc._lane_init = mode_of
    trace = S.gct_trace(S.TraceSpec(**spec))
    ticks = []
    i = 0
    while i < len(trace) or svc.queue.pending:
        chunk = trace[i:i + push]
        for req in chunk:
            svc.submit(req)
        i += len(chunk)
        n_solves, n_modes = len(solves), len(modes)
        rec = svc.tick()
        if rec is None and i >= len(trace):
            break
        ticks.append({
            "record": {k: v for k, v in rec.to_dict().items()
                       if k not in WALL_FIELDS},
            "lanes": solves[n_solves:], "modes": modes[n_modes:],
            "plans": {f: (svc.fleet(f).plan.tolist(), svc.fleet(f).plan_cost)
                      for f in svc.fleets}})
    return svc, ticks


@pytest.fixture(scope="module")
def f64_replays(x64_alias):
    return {pkg: _replay_ticks(pkg, F64_SPEC, 8, precision="f64",
                               operator="cumsum") for pkg in PKGS}


@pytest.fixture(scope="module")
def mixed_replays(x64_alias):
    out = {}
    for pkg, S in PKGS.items():
        svc = S.RightsizingService(engine=_engine(pkg))
        out[pkg] = (svc, S.replay(svc, S.gct_trace(S.TraceSpec(**MIXED_SPEC)),
                                  push_per_tick=12))
    return out


def test_f64_ticks_match_the_reference(f64_replays):
    (_, ref), (_, port) = f64_replays["ref"], f64_replays["port"]
    assert len(ref) == len(port) >= 4
    assert {m for t in ref for m in t["modes"]} >= {"admit", "warm"}
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a["record"] == b["record"], i    # fleets, lanes, iterations
        assert a["modes"] == b["modes"], i
        assert a["lanes"] == b["lanes"], i      # (iterations, restarts)
        assert a["plans"].keys() == b["plans"].keys(), i
        for f in a["plans"]:
            assert a["plans"][f][0] == b["plans"][f][0], (i, f)
            assert a["plans"][f][1] == pytest.approx(b["plans"][f][1],
                                                     rel=1e-9), (i, f)


def test_f64_events_and_report_match_the_reference(f64_replays):
    ref, port = f64_replays["ref"][0], f64_replays["port"][0]
    assert len(ref.events) == len(port.events) > 0
    for a, b in zip(ref.events, port.events):
        assert (a.tick, a.fleet, a.scope) == (b.tick, b.fleet, b.scope)
        assert [c.to_dict() for c in a.checks] == \
            [c.to_dict() for c in b.checks]
        assert a.cost_before == pytest.approx(b.cost_before, rel=1e-9)
        assert a.cost_after == pytest.approx(b.cost_after, rel=1e-9)
    ra, rb = ref.report(), port.report()
    assert ra.keys() == rb.keys()
    for key in ra.keys() - WALL_KEYS:
        if isinstance(ra[key], float):
            assert ra[key] == pytest.approx(rb[key], rel=1e-9), key
        else:
            assert ra[key] == rb[key], key


def test_mixed_replay_converges_in_one_dispatch_per_tick(mixed_replays):
    for pkg in PKGS:
        rep = mixed_replays[pkg][1]
        assert rep["requests"] == MIXED_SPEC["requests"]
        assert rep["dispatches_per_tick"] == 1, pkg
        assert rep["converged_frac"] == 1.0, pkg


def test_mixed_replay_plans_pass_the_oracle(mixed_replays):
    svc = mixed_replays["port"][0]
    assert len(svc.fleets) == MIXED_SPEC["fleets"]
    for name in svc.fleets:
        st = svc._fleets[name]
        assert check_plan(st.problem, st.solution) == []
        assert ref_check_plan(st.problem, st.solution) == []


def test_mixed_replay_costs_within_the_drift_bound(mixed_replays):
    (ref_svc, ref), (port_svc, port) = (mixed_replays["ref"],
                                        mixed_replays["port"])
    drift = abs(port["proposed_cost_total"] - ref["proposed_cost_total"]) \
        / ref["proposed_cost_total"] * 100.0
    lanes_apart = sum(a.iters != b.iters
                      for a, b in zip(ref_svc.ticks, port_svc.ticks))
    plans_apart = sum(not np.array_equal(ref_svc.fleet(f).plan,
                                         port_svc.fleet(f).plan)
                      for f in ref_svc.fleets)
    events_apart = abs(len(ref_svc.events) - len(port_svc.events)) + sum(
        a.to_dict() != b.to_dict()
        for a, b in zip(ref_svc.events, port_svc.events))
    print(f"\nmixed replay {MIXED_SPEC}: proposed cost drift {drift:.4f}%, "
          f"ticks whose iterations differ {lanes_apart}, fleets whose plan "
          f"differs {plans_apart}, events apart {events_apart}")
    assert len(ref_svc.ticks) == len(port_svc.ticks)
    assert drift <= PS.ServiceConfig().cost_drift_bound_pct
    assert lanes_apart <= MIXED_READINGS["lanes_apart"]
    assert plans_apart <= MIXED_READINGS["plans_apart"]
    assert events_apart <= MIXED_READINGS["events_apart"]


# --- the rest of the service, on the port ---------------------------------

def _admit(S, fleet, n=12, m=3, seed=0):
    from repro_torch.workload import gct_like_instance

    p = gct_like_instance(n=n, m=m, seed=seed)
    return p, S.Request(fleet=fleet, kind="admit", dem=p.dem, start=p.start,
                        end=p.end, node_types=p.node_types, T=p.T)


def _service(faults=None, **cfg):
    return PS.RightsizingService(config=PS.ServiceConfig(**cfg),
                                 faults=faults, device="cpu")


def test_default_engine_is_the_reference_default():
    svc = _service()
    assert svc.engine.solver == P.SolverConfig(tol=5e-3, iters=4000)
    assert svc.engine.algos == ("lp-map-f",)
    assert svc.engine.sweep == P.SweepConfig()
    assert svc.engine.device.type == "cpu"
    with pytest.raises(ValueError, match="tolerance-stopped solver"):
        PS.RightsizingService(engine=P.FleetEngine(device="cpu"))
    with pytest.raises(ValueError, match="brings its own device"):
        PS.RightsizingService(engine=svc.engine, device="cpu")


def test_admit_then_warm_replan_and_drift_fallback():
    svc = _service(shape_quantum=4, max_shape_drift=0.5)
    p, admit = _admit(PS, "gpu", seed=1)
    svc.submit(admit)
    rec = svc.tick()
    assert svc.fleets == ("gpu",) and rec.cold_lanes == 1
    svc.submit(PS.Request(fleet="gpu", kind="replan"))
    assert svc.tick().warm_lanes == 1
    svc.submit(PS.Request(fleet="gpu", kind="arrive",
                          dem=np.tile(p.dem, (2, 1))[:16],
                          start=np.tile(p.start, 2)[:16],
                          end=np.tile(p.end, 2)[:16]))
    rec = svc.tick()
    assert rec.drift_fallbacks == 1 and svc.fleet("gpu").n_tasks == 28


def test_lane_init_drift_returns_three_values_unlike_the_reference():
    """A stored state of another m or D cold-starts the lane in the port;
    the reference returns a 2-tuple there, which its caller cannot unpack
    (a latent fault: no request changes a fleet's m or D)."""
    out = {}
    for pkg, S in PKGS.items():
        svc = S.RightsizingService(engine=_engine(pkg))
        _, admit = _admit(S, "gpu", n=8, m=3, seed=2)
        problem = CORES[pkg].Problem(
            dem=admit.dem, start=admit.start, end=admit.end,
            node_types=admit.node_types, T=admit.T)
        trimmed, kept = CORES[pkg].trim_timeline(problem)
        warm = S.service._LaneState(
            x=np.zeros((8, 2), np.float32),            # m = 2, not 3
            y=np.zeros((len(kept), 2, 2), np.float32), eta=0.1, omega=1.0,
            ids=np.arange(8), kept=kept)
        st = S.service._FleetState(problem=problem, ids=np.arange(8),
                                   next_id=8, warm=warm)
        x0 = np.zeros((1, 8, 3), np.float32)
        y0 = np.zeros((1, trimmed.T, 3, trimmed.D), np.float32)

        def unpack(S, svc=svc, st=st, trimmed=trimmed, kept=kept, x0=x0,
                   y0=y0):
            mode, eta, omega = svc._lane_init(st, np.arange(8), trimmed,
                                              kept, x0, y0, 0)
            return mode, eta, omega

        out[pkg] = _outcome(unpack, S)
    assert out["port"] == ("ok", ("drift", None, None))
    assert out["ref"][0] == "ValueError"
    assert "not enough values to unpack" in out["ref"][1]


def test_poison_request_quarantines_after_retries():
    svc = _service(shape_quantum=4, max_request_retries=1)
    _, admit = _admit(PS, "gpu", n=4, m=3, seed=2)
    svc.submit(admit)
    svc.tick()
    svc.submit(PS.Request(fleet="gpu", kind="depart", ids=(0, 1, 2, 3)))
    svc.drain()
    assert svc.queue.pending == 0 and len(svc.quarantined) == 1
    q = svc.quarantined[0]
    assert (q.kind, q.attempts) == ("depart", 2)
    assert "depart would empty fleet" in q.error
    assert svc.fleet("gpu").n_tasks == 4 and svc.report()["retries"] == 1


@pytest.mark.parametrize("kind", ["nonconverge", "verify-fail"])
def test_injected_lane_failure_retries_cold(kind):
    svc = _service(shape_quantum=4, faults=PS.FaultInjector([
        PS.FaultSpec(kind=kind, fleet="gpu", tick=1, times=1)]))
    svc.submit(_admit(PS, "gpu", n=8, seed=1)[1])
    svc.tick()
    svc.submit(PS.Request(fleet="gpu", kind="burst", ids=(0, 1), factor=1.5))
    failed = svc.tick()
    assert failed.fleets == () and failed.retried == 1
    recovered = svc.tick()
    assert recovered.fleets == ("gpu",) and recovered.warm_lanes == 0
    assert not svc.quarantined and svc.report()["retries"] == 1


def test_poison_fleet_quarantines_without_stalling_others():
    svc = _service(shape_quantum=4, max_request_retries=2,
                   faults=PS.FaultInjector([PS.FaultSpec(
                       kind="apply-raise", fleet="bad", times=None)]))
    svc.submit(_admit(PS, "bad", n=8, seed=1)[1])
    svc.submit(_admit(PS, "ok", n=8, seed=2)[1])
    assert svc.drain() < 10
    assert svc.fleets == ("ok",) and len(svc.quarantined) == 1
    q = svc.quarantined[0]
    assert (q.fleet, q.kind, q.attempts) == ("bad", "admit", 3)
    assert q.error.startswith("InjectedFault")


def test_unknown_ids_quarantine_naming_them():
    svc = _service(shape_quantum=4, max_request_retries=0)
    svc.submit(_admit(PS, "gpu", n=4, m=3, seed=2)[1])
    svc.tick()
    svc.submit(PS.Request(fleet="gpu", kind="burst", ids=(2, 99),
                          factor=1.5))
    rec = svc.tick()
    assert rec.dispatches == 0 and rec.quarantined == 1
    assert "unknown task ids [99]" in svc.quarantined[0].error


def test_shedding_under_pressure():
    svc = _service(shape_quantum=4, max_pending=2, max_requests_per_tick=2)
    svc.submit(_admit(PS, "gpu", n=8, seed=3)[1])
    svc.tick()
    for _ in range(5):
        svc.submit(PS.Request(fleet="gpu", kind="replan"))
    svc.submit(PS.Request(fleet="gpu", kind="burst", ids=(0,), factor=1.3))
    svc.drain()
    rep = svc.report()
    assert rep["shed"] >= 3 and sum(rep["shed_reasons"].values()) == \
        rep["shed"]
    assert all(e.kind == "replan" for e in svc.shed_events)
    assert any(e.reason == "coalesced" for e in svc.shed_events)


def test_deadline_misses_counted():
    svc = _service(shape_quantum=4)
    svc.submit(_admit(PS, "gpu", n=8, seed=3)[1])
    svc.tick()
    svc.submit(PS.Request(fleet="gpu", kind="replan", deadline_s=1e-9))
    svc.tick()
    assert svc.report()["deadline_misses"] == 1


def test_constrain_request_plan_passes_the_oracle():
    svc = _service(shape_quantum=4)
    svc.submit(_admit(PS, "gpu", n=8, m=3, seed=2)[1])
    svc.tick()
    svc.submit(PS.Request(fleet="gpu", kind="constrain", ids=(0, 1),
                          affinity="tower"))
    svc.submit(PS.Request(fleet="gpu", kind="constrain", ids=(2,),
                          exclusive=True))
    svc.drain()
    assert not svc.quarantined
    st = svc._fleets["gpu"]
    assert "tower" in st.problem.constraints.affinity_names
    sol = st.solution
    assert sol.meta.get("constrained") is True
    assert sol.assign[0] == sol.assign[1]
    assert check_plan(st.problem, sol) == []
    assert ref_check_plan(st.problem, sol) == []


def test_preprovision_grows_the_plan_and_logs_its_event():
    svc = _service(shape_quantum=4)
    svc.submit(_admit(PS, "gpu", n=8, seed=3)[1])
    svc.tick()
    before = svc.fleet("gpu").plan.copy()
    n_events = len(svc.events)
    res = svc.preprovision("gpu", config=PST.StochasticConfig(scenarios=4,
                                                              quantiles=3))
    after = svc.fleet("gpu").plan
    assert res.K == 4 and res.lp_dispatches == 1
    assert (after >= before).all()
    assert len(svc.events) == n_events + 1
    ev = svc.events[-1]
    assert ev.scope == "preprovision" and ev.fleet == "gpu"
    assert ev.cost_after == pytest.approx(
        float(after @ svc._fleets["gpu"].problem.node_types.cost))


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_kernel_build_failure_propagates_without_fallback(monkeypatch):
    """A congestion kernel that fails to build raises out of ``tick``: the
    request is neither retried nor quarantined, and the plain version
    never runs in the kernel's place."""
    from repro_torch.kernels import build, congestion, ref

    svc = PS.RightsizingService(engine=P.FleetEngine(
        solver=P.SolverConfig(tol=5e-3, iters=4000, operator="pallas"),
        algos=("lp-map-f",), device="cpu"))
    svc.submit(_admit(PS, "gpu", n=8, seed=3)[1])
    plain = _spy(monkeypatch, ref, "congestion_lp_ref")
    monkeypatch.setattr(congestion, "_on_card", lambda *t: True)

    def no_build(name):
        raise RuntimeError(f"nvcc failed building {name}")

    monkeypatch.setattr(build, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed building congestion"):
        svc.tick()
    assert plain == [] and not svc.quarantined and svc.report()["retries"] == 0


def test_stepper_failure_propagates_without_fallback(monkeypatch):
    """The same for the compiled stepper's launch: ``tick`` raises, and
    neither the plain stepper nor the numpy lockstep engine runs."""
    from repro_torch.core import place_batch
    from repro_torch.kernels import place_step, ref

    svc = PS.RightsizingService(engine=P.FleetEngine(
        solver=P.SolverConfig(tol=5e-3, iters=4000),
        placement=P.PlacementConfig(engine="compiled"), algos=("lp-map-f",),
        device="cpu"))
    svc.submit(_admit(PS, "gpu", n=8, seed=3)[1])
    plain = _spy(monkeypatch, ref, "sub_phase_ref")
    lockstep = _spy(monkeypatch, place_batch._Engine, "run_wave")

    def launch_failed(*args, **kwargs):
        raise RuntimeError("place_step kernel launch failed: CUDA error 700")

    monkeypatch.setattr(place_step, "sub_phase", launch_failed)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        svc.tick()
    assert plain == [] and lockstep == []
    assert not svc.quarantined and svc.report()["retries"] == 0
