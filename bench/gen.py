"""Frozen copies of the instance and forecast generators.

The benchmark's yardstick must not move when the program changes, so the
generators that make its inputs live here: the paper's Table-I synthetic
instance (§VI-A), the GCT-2019-like pool and its paper-protocol sampling,
the node-type cost models, and the demand forecast's channels and scenario
fan-out.  They draw exactly what the program's own generators draw from the
same ``np.random.Generator`` state (``bench/tests/test_bench_inputs.py``
holds them bit for bit), and return plain numpy ``Instance`` tuples that
the harness hands to the program through its public ``Problem`` type.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np

# namespaces the scenario fan-out's seed streams (the program's value, so
# that a scenario drawn here equals the program's scenario)
FANOUT_TAG = 0x5C3A

# GCE n2 on-demand-like per-dimension prices (vCPU-hour, memory-GB-hour)
GCE_COEFF_2D = np.array([0.88, 0.12])

# the 13 normalized (cpu, memory) machine shapes of GCT-2019 cell "a"
MACHINE_SHAPES = np.array([
    [1.000, 1.000], [1.000, 0.500], [0.500, 0.500], [0.500, 0.250],
    [0.500, 0.750], [0.500, 0.125], [0.250, 0.250], [0.708, 0.250],
    [0.500, 0.375], [1.000, 0.250], [0.250, 0.125], [0.708, 0.500],
    [0.958, 0.500],
])
POOL_SEED = 20190501
POOL_TASKS = 13_000
HORIZON_S = 86_400


class Instance(NamedTuple):
    """A rightsizing instance as plain arrays: demands (n, D), inclusive
    0-based start and end slots (n,), node capacities (m, D) and prices
    (m,), and the number of slots T."""

    dem: np.ndarray
    start: np.ndarray
    end: np.ndarray
    cap: np.ndarray
    cost: np.ndarray
    T: int

    @property
    def n(self) -> int:
        return self.dem.shape[0]

    @property
    def m(self) -> int:
        return self.cap.shape[0]

    @property
    def D(self) -> int:
        return self.cap.shape[1]


def node_cost(cap: np.ndarray, cost_model: str) -> np.ndarray:
    """Prices by the paper's Eq. 8 with e = 1: ``homogeneous`` sums the
    capacities, ``gce`` weighs (cpu, memory) like GCE on-demand prices."""
    if cost_model == "homogeneous":
        return cap.sum(axis=1)
    if cost_model == "gce":
        if cap.shape[1] != 2:
            raise ValueError("the gce cost model needs D = 2 (cpu, memory)")
        return (GCE_COEFF_2D[None, :] * cap).sum(axis=1) * 2.0
    raise ValueError(f"unknown cost model {cost_model!r}")


def synthetic_instance(rng: np.random.Generator, n: int, m: int, D: int,
                       T: int, demand=(0.01, 0.1), capacity=(0.2, 1.0),
                       cost_model: str = "homogeneous") -> Instance:
    """One Table-I instance: capacities U(capacity), demands U(demand),
    spans from two uniform slots, in the program's draw order."""
    cap = rng.uniform(*capacity, size=(m, D))
    cost = node_cost(cap, cost_model)
    dem = rng.uniform(*demand, size=(n, D))
    a = rng.integers(0, T, size=n)
    b = rng.integers(0, T, size=n)
    return Instance(dem=dem, start=np.minimum(a, b).astype(np.int64),
                    end=np.maximum(a, b).astype(np.int64), cap=cap,
                    cost=cost, T=int(T))


@functools.lru_cache(maxsize=1)
def gct_pool() -> dict:
    """The fixed GCT-2019-like pool (13,000 tasks, 13 machine shapes):
    diurnal arrivals, log-normal durations with a long-running cohort,
    discrete cpu requests and mem:cpu ratios, drawn from seed 20190501."""
    rng = np.random.default_rng(POOL_SEED)
    n = POOL_TASKS
    u = rng.random(n)
    start = np.where(
        u < 0.7,
        rng.uniform(0, HORIZON_S, n),
        np.where(u < 0.85, rng.normal(10 * 3600, 1.5 * 3600, n),
                 rng.normal(20 * 3600, 1.5 * 3600, n)))
    start = np.clip(start, 0, HORIZON_S - 2).astype(np.int64)
    dur = np.exp(rng.normal(np.log(5400), 1.3, n))
    long_mask = rng.random(n) < 0.20
    dur = np.where(long_mask, rng.uniform(6 * 3600, 24 * 3600, n), dur)
    dur = np.clip(dur, 10, 24 * 3600).astype(np.int64)
    end = np.minimum(start + dur, HORIZON_S - 1)
    cpu_sizes = np.array([0.005, 0.01, 0.02, 0.04, 0.08, 0.16])
    cpu_probs = np.array([0.10, 0.20, 0.25, 0.20, 0.15, 0.10])
    mem_ratio = np.array([0.25, 0.5, 1.0, 2.0])
    ratio_probs = np.array([0.15, 0.40, 0.35, 0.10])
    cpu = rng.choice(cpu_sizes, size=n, p=cpu_probs)
    mem = np.clip(cpu * rng.choice(mem_ratio, size=n, p=ratio_probs),
                  1e-4, 0.5)
    return {"dem": np.stack([cpu, mem], axis=1), "start": start,
            "end": end, "cap": MACHINE_SHAPES.copy(), "horizon": HORIZON_S}


def gct_like_instance(rng: np.random.Generator, n: int, m: int,
                      cost_model: str = "homogeneous") -> Instance:
    """The paper's protocol on the pool: n tasks and m node types sampled
    without replacement."""
    pool = gct_pool()
    ti = rng.choice(len(pool["dem"]), size=min(n, len(pool["dem"])),
                    replace=False)
    mi = rng.choice(len(pool["cap"]), size=min(m, len(pool["cap"])),
                    replace=False)
    cap = pool["cap"][mi]
    return Instance(dem=pool["dem"][ti], start=pool["start"][ti],
                    end=pool["end"][ti], cap=cap,
                    cost=node_cost(cap, cost_model), T=pool["horizon"])


def forecast_factors(base: Instance, rng: np.random.Generator,
                     load_sigma: float, diurnal_amp: float,
                     burst_prob: float, burst_alpha: float,
                     burst_cap: float) -> np.ndarray:
    """One scenario's per-task demand multipliers: a scenario-wide
    log-normal load, a phase-jittered diurnal sinusoid over the start slot
    and Pareto bursts, drawn in that order."""
    if load_sigma == 0.0 and diurnal_amp == 0.0 and burst_prob == 0.0:
        return np.ones(base.n, dtype=np.float64)
    load = math.exp(rng.normal(-0.5 * load_sigma**2, load_sigma)) \
        if load_sigma > 0 else 1.0
    phase = rng.uniform(0.0, 2.0 * math.pi)
    diurnal = 1.0 + diurnal_amp * np.sin(
        2.0 * math.pi * base.start / max(base.T, 1) - phase) \
        if diurnal_amp > 0 else np.ones(base.n)
    burst = np.ones(base.n)
    if burst_prob > 0:
        hit = rng.random(base.n) < burst_prob
        tail = (1.0 - rng.random(base.n)) ** (-1.0 / burst_alpha)
        burst = np.where(hit, np.minimum(tail, burst_cap), 1.0)
    return load * diurnal * burst


def scenario(base: Instance, channels: dict, seed: int, k: int) -> Instance:
    """Scenario k of the fan-out of ``seed``: the base's demands times the
    scenario's factors, each task's factor clamped to the headroom of its
    best-fitting node type."""
    with np.errstate(divide="ignore"):
        ratios = np.where(base.dem[:, None, :] > 0,
                          base.cap[None, :, :] / base.dem[:, None, :],
                          np.inf)
    headroom = ratios.min(axis=2).max(axis=1)
    rng = np.random.default_rng([FANOUT_TAG, seed, k])
    f = forecast_factors(base, rng, **channels)
    return base._replace(dem=base.dem * np.minimum(f, headroom)[:, None])
