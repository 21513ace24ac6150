"""The benchmark's frozen generators give the program's own inputs, bit
for bit, at the paper's sizes; its streams repeat by seed."""

import json
import pathlib

import numpy as np
import pytest

from bench import gen, traffic

from repro_torch.stochastic import DemandForecast, fan_out
from repro_torch.workload import (SyntheticSpec, gct_like_instance, gct_pool,
                                  synthetic_instance)

BENCH = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = {p.stem: json.loads(p.read_text())
           for p in (BENCH / "configs").glob("*.json")}
FORECAST = json.loads((BENCH / "mixes" / "forecast.json").read_text())


def same(inst: gen.Instance, prob) -> bool:
    pairs = ((inst.dem, prob.dem), (inst.start, prob.start),
             (inst.end, prob.end), (inst.cap, prob.node_types.cap),
             (inst.cost, prob.node_types.cost))
    return inst.T == prob.T and all(
        a.dtype == b.dtype and np.array_equal(a, b) for a, b in pairs)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_table1_instance_is_the_programs(seed):
    size = CONFIGS["table1"]["instance"]
    mine = gen.synthetic_instance(np.random.default_rng(seed), **size)
    spec = SyntheticSpec(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in size.items()}, seed=seed)
    assert same(mine, synthetic_instance(spec))


def test_gct_pool_is_the_programs():
    mine, theirs = gen.gct_pool(), gct_pool()
    for key in ("dem", "start", "end", "cap"):
        assert np.array_equal(mine[key], theirs[key])
    assert mine["horizon"] == theirs["horizon"]


@pytest.mark.parametrize("seed", [0, 3, 2**33 + 1])
def test_gct_instance_is_the_programs(seed):
    size = CONFIGS["gct"]["instance"]
    mine = gen.gct_like_instance(np.random.default_rng(seed), **size)
    assert same(mine, gct_like_instance(seed=seed, **size))


def test_forecast_scenarios_are_the_programs():
    from bench.drivers import to_problem

    size = CONFIGS["gct"]["instance"]
    base = gen.gct_like_instance(np.random.default_rng(9), **size)
    channels = FORECAST["forecast"]
    seed = traffic.step_seed(2**40 + 3, traffic.STEP, 2)
    theirs = fan_out(DemandForecast(base=to_problem(base), **channels), 6,
                     seed)
    for k in range(6):
        assert same(gen.scenario(base, channels, seed, k),
                    theirs.problems[k])


def test_streams_repeat_by_seed_and_step():
    cfg = CONFIGS["table1"]
    a = traffic.instances(cfg, BENCH, 2**31 + 7, traffic.STEP, 3, 2)
    b = traffic.instances(cfg, BENCH, 2**31 + 7, traffic.STEP, 3, 2)
    c = traffic.instances(cfg, BENCH, 2**31 + 7, traffic.STEP, 4, 2)
    w = traffic.instances(cfg, BENCH, 2**31 + 7, traffic.WARM, 3, 2)
    assert all(np.array_equal(x.dem, y.dem) for x, y in zip(a, b))
    assert not np.array_equal(a[0].dem, a[1].dem)
    assert not np.array_equal(a[0].dem, c[0].dem)
    assert not np.array_equal(a[0].dem, w[0].dem)
    assert traffic.entropy(-1) == 2**64 - 1
