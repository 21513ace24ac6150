"""The port's recorder (``repro_torch.obs``): off without a profiler; under
``torch.profiler`` one step a call with the spans and counters of each
phase, their times matching the phase timings, the host-only spans in the
profile as ``repro_torch.<name>`` and the others not; a well-formed tree
when the sweep's shards interleave on one thread."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import obs
from repro_torch.core import (FleetEngine, PlacementConfig, SolverConfig,
                              SweepConfig)
from repro_torch.stochastic import (StochasticConfig, gct_forecast,
                                    plan_stochastic)
from repro_torch.workload import SyntheticSpec, synthetic_instance

LP = {"lp", "lp/lp.setup", "lp/lp.enqueue", "lp/lp.wait", "lp/lp.polish",
      "lp/lp.read", "lp/lp.results"}
PLACE = {"place", "place/place.prep", "place/place.gather",
         "place/place.pack", "place/place.upload", "place/place.dispatch",
         "place/place.apply", "place/place.solutions", "place/place.costs"}
EVALUATE = {"evaluate", "evaluate/pack"} | {
    f"evaluate/{p}" for p in LP | PLACE | {"place/place.maps",
                                           "place/place.verify"}}
PLAN = {"plan", "plan/fanout", "plan/lp/pack", "plan/select"} | {
    f"plan/{p}" for p in LP | PLACE}


def _fleet(k=3):
    return [synthetic_instance(SyntheticSpec(n=20, m=3, D=2, T=8, seed=s))
            for s in range(k)]


def _engine(**sweep):
    return FleetEngine(solver=SolverConfig(tol=1e-2, iters=300),
                       placement=PlacementConfig(engine="compiled"),
                       sweep=SweepConfig(**sweep), device="cpu")


def _last_id():
    done = obs.steps()
    return done[-1]["id"] if done else -1


def _traced(fn):
    """``fn()`` under a CPU profile: (its value, the steps it recorded, the
    profile's host event names)."""
    before = _last_id()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    new = [s for s in obs.steps() if s["id"] > before]
    return out, new, {e.name for e in prof.events()}


@pytest.fixture(scope="module")
def fleet_run():
    eng = _engine()
    eng.evaluate(_fleet())   # builds nothing on the CPU; warms numpy
    return _traced(lambda: eng.evaluate(_fleet()))


@pytest.fixture(scope="module")
def plan_run():
    eng = _engine()
    fc = gct_forecast(n=20, m=4, seed=1, burst_prob=0.1)
    return _traced(lambda: plan_stochastic(fc, StochasticConfig(scenarios=6),
                                           engine=eng))


@pytest.mark.parametrize("recording", [False, True])
def test_timed_feeds_the_timings_on_and_off(recording):
    """``timed`` adds its seconds to the timings whether or not the
    recorder is on; on, its span's total is those same seconds."""
    timings = {}

    def run():
        with obs.span("evaluate"):
            for _ in range(2):
                with obs.timed("lp", timings, "lp_s"):
                    sum(range(1000))

    if recording:
        _, steps, _ = _traced(run)
        count, total, _, _ = steps[0]["spans"]["evaluate/lp"]
        assert count == 2 and total == pytest.approx(timings["lp_s"],
                                                     rel=1e-12)
    else:
        before = _last_id()
        run()
        assert _last_id() == before
    assert list(timings) == ["lp_s"] and timings["lp_s"] > 0


def test_off_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert obs.span("lp") is obs.span("place", host=True)
    before = _last_id()
    _engine().evaluate(_fleet(2))
    obs.add("lp.attempts", 3)
    assert _last_id() == before


@pytest.mark.parametrize("which", ["evaluate", "plan"])
def test_one_step_with_every_phase(fleet_run, plan_run, which):
    _, steps, _ = fleet_run if which == "evaluate" else plan_run
    assert [s["name"] for s in steps] == [which]
    want = EVALUATE if which == "evaluate" else PLAN
    assert set(steps[0]["spans"]) == want
    counters = steps[0]["counters"]
    # on the CPU every chunk runs eagerly (no CUDA graph)
    assert set(counters) == {"lp.attempts", "lp.chunks_eager",
                             "place.upload_bytes"}
    assert all(v > 0 for v in counters.values())


@pytest.mark.parametrize("which", ["evaluate", "plan"])
def test_times_add_up(fleet_run, plan_run, which):
    res, steps, _ = fleet_run if which == "evaluate" else plan_run
    table = steps[0]["spans"]
    for path, (count, total, self_s, _) in table.items():
        assert count >= 1 and 0 <= self_s <= total + 1e-9, path
        kids = [v[1] for p, v in table.items()
                if p.rsplit("/", 1)[0] == path and p != path]
        assert total - sum(kids) == pytest.approx(self_s, abs=1e-6), path
    for phase in ("lp", "place"):
        span_s = table[f"{which}/{phase}"][1]
        assert abs(span_s - res.timings[f"{phase}_s"]) <= \
            1e-3 + 0.01 * res.timings[f"{phase}_s"]
    if which == "plan":
        parts = sum(table[f"plan/{p}"][1]
                    for p in ("fanout", "lp", "place", "select"))
        assert parts <= table["plan"][1]
        for key in ("fanout_s", "lp_s", "place_s", "select_s"):
            assert res.timings[key] > 0


@pytest.mark.parametrize("which", ["evaluate", "plan"])
def test_counters_match_the_solver_and_stepper(fleet_run, plan_run, which):
    res, steps, _ = fleet_run if which == "evaluate" else plan_run
    table, counters = steps[0]["spans"], steps[0]["counters"]
    assert counters["lp.attempts"] == sum(int(st.iterations.max())
                                          for st in res.stats)
    if which == "evaluate":
        # one place.dispatch span a stepper call
        assert table["evaluate/place/place.dispatch"][0] == \
            res.timings["placement"]["dispatches"]


@pytest.mark.parametrize("which", ["evaluate", "plan"])
def test_only_host_spans_reach_the_profile(fleet_run, plan_run, which):
    _, steps, names = fleet_run if which == "evaluate" else plan_run
    table = steps[0]["spans"]
    host = {"repro_torch." + p.rsplit("/", 1)[-1]
            for p, v in table.items() if v[3]}
    other = {"repro_torch." + p.rsplit("/", 1)[-1]
             for p, v in table.items() if not v[3]}
    assert host and host <= names
    assert not (other - host) & names


def test_interleaved_shards_leave_a_well_formed_tree():
    """Two lane shards of the sweep pipeline run interleaved on this one
    thread (``_run_shards``): their chunks land under one ``lp`` span."""
    eng = _engine(warm_start=4, pipeline=True, devices=2)
    res, steps, _ = _traced(lambda: eng.evaluate(_fleet(8)))
    assert [s["name"] for s in steps] == ["evaluate"]
    table, counters = steps[0]["spans"], steps[0]["counters"]
    for path in table:
        parent = path.rsplit("/", 1)[0]
        assert parent == path or parent in table, path
    assert {p for p in table if p.startswith("evaluate/lp/")} == {
        f"evaluate/{p}" for p in LP - {"lp"}}
    # each shard runs its own chunks: attempts are its slowest lane's
    want = sum(int(st.iterations[i:i + 2].max())
               for st in res.stats for i in (0, 2))
    assert counters["lp.attempts"] == want
    # every chunk queued is waited on once
    assert table["evaluate/lp/lp.enqueue"][0] == \
        table["evaluate/lp/lp.wait"][0]
    assert np.isfinite(res.timings["lp_s"])
