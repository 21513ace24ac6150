"""GCT-2019-like trace (paper §VI-A), ported from ``repro.workload.gct``:
the same pool and the same instances, bit for bit, from the same seed.

The paper samples ~13K collection events and the 13 machine-types of
cluster "a" of the Google Cluster Trace 2019 via BigQuery: demands and
capacities are 2-dimensional (CPU, memory) and normalized, task demands are
small relative to node capacities, and task intervals come from creation /
end events with second timestamps.  Offline, we emulate that distribution
statistically (and provide a CSV loader for the real trace when present):

* 13 machine shapes drawn from the public GCT-2019 machine-config table
  (normalized CPU/memory pairs).
* ~13K tasks with log-normal durations (median minutes, heavy hour tail),
  diurnal arrival mix, and small log-normal demands with CPU<->memory
  correlation, matching the trace's "demands are fixed and small compared
  to node-capacities" regime.

``gct_like_instance(n, m, seed)`` reproduces the paper's sampling protocol:
draw n tasks and m node-types from the fixed processed pool per instance.
"""

from __future__ import annotations

import functools

import numpy as np

from ..core import NodeTypes, Problem
from .cost_models import gce_like_cost, homogeneous_cost

__all__ = ["gct_pool", "gct_like_instance", "load_trace_csv"]

# Normalized (cpu, memory) machine shapes — the 13 distinct configs of
# GCT-2019 cell "a" (normalized to the largest machine), per the public
# machine_events table.
_MACHINE_SHAPES = np.array([
    [1.000, 1.000],
    [1.000, 0.500],
    [0.500, 0.500],
    [0.500, 0.250],
    [0.500, 0.750],
    [0.500, 0.125],
    [0.250, 0.250],
    [0.708, 0.250],
    [0.500, 0.375],
    [1.000, 0.250],
    [0.250, 0.125],
    [0.708, 0.500],
    [0.958, 0.500],
])

_POOL_TASKS = 13_000
_HORIZON_S = 86_400  # one day, second resolution (paper converts to seconds)


@functools.lru_cache(maxsize=1)
def gct_pool() -> dict:
    """The fixed processed pool: ~13K tasks + 13 node-types."""
    rng = np.random.default_rng(20190501)
    # Diurnal arrival mix: 70% uniform over the day, 30% in two peaks.
    n = _POOL_TASKS
    u = rng.random(n)
    start = np.where(
        u < 0.7,
        rng.uniform(0, _HORIZON_S, n),
        np.where(
            u < 0.85,
            rng.normal(10 * 3600, 1.5 * 3600, n),  # morning peak
            rng.normal(20 * 3600, 1.5 * 3600, n),  # evening peak
        ),
    )
    start = np.clip(start, 0, _HORIZON_S - 2).astype(np.int64)
    # Durations: log-normal (median ~90 min, heavy tail) plus a 20%
    # long-running cohort spanning 6-24h, as in the real trace where many
    # collections live for most of the day.
    dur = np.exp(rng.normal(np.log(5400), 1.3, n))
    long_mask = rng.random(n) < 0.20
    dur = np.where(long_mask, rng.uniform(6 * 3600, 24 * 3600, n), dur)
    dur = np.clip(dur, 10, 24 * 3600).astype(np.int64)
    end = np.minimum(start + dur, _HORIZON_S - 1)
    # Demands: the real trace's requests are *discrete* (fixed request
    # sizes; "task demands are fixed and small compared to node-capacities",
    # paper §VI-A): a small catalogue of CPU sizes with a heavy-small
    # distribution, and memory set by a discrete mem:cpu ratio concentrated
    # near the machine shapes (Borg requests are cpu-dominant).
    cpu_sizes = np.array([0.005, 0.01, 0.02, 0.04, 0.08, 0.16])
    cpu_probs = np.array([0.10, 0.20, 0.25, 0.20, 0.15, 0.10])
    mem_ratio = np.array([0.25, 0.5, 1.0, 2.0])
    ratio_probs = np.array([0.15, 0.40, 0.35, 0.10])
    cpu = rng.choice(cpu_sizes, size=n, p=cpu_probs)
    mem = np.clip(cpu * rng.choice(mem_ratio, size=n, p=ratio_probs),
                  1e-4, 0.5)
    dem = np.stack([cpu, mem], axis=1)
    return {
        "dem": dem,
        "start": start,
        "end": end,
        "cap": _MACHINE_SHAPES.copy(),
        "horizon": _HORIZON_S,
    }


def _node_types(cap: np.ndarray, cost_model: str, e: float = 1.0) -> NodeTypes:
    if cost_model == "homogeneous":
        cost = homogeneous_cost(cap)
    elif cost_model == "gce":
        cost = gce_like_cost(cap, e=e)
    else:
        raise ValueError(f"unknown cost model {cost_model!r}")
    return NodeTypes(cap=cap, cost=cost)


def gct_like_instance(
    n: int = 1000,
    m: int = 10,
    seed: int = 0,
    cost_model: str = "homogeneous",
    e: float = 1.0,
    rng: np.random.Generator | None = None,
) -> Problem:
    """Paper protocol: sample n tasks and m node-types from the pool.

    Sampling is bit-reproducible: all randomness flows from ONE
    explicit source — ``rng`` when given, else a fresh
    ``np.random.default_rng(seed)`` — so the same seed always yields
    the same instance (the scenario fan-out and the serving trace
    generators rely on this).
    Passing ``rng`` advances the caller's generator in place (draw
    several distinct instances from one stream); passing ``seed``
    never touches global NumPy state.
    """
    pool = gct_pool()
    if rng is None:
        rng = np.random.default_rng(seed)
    ti = rng.choice(len(pool["dem"]), size=min(n, len(pool["dem"])),
                    replace=False)
    mi = rng.choice(len(pool["cap"]), size=min(m, len(pool["cap"])),
                    replace=False)
    return Problem(
        dem=pool["dem"][ti],
        start=pool["start"][ti],
        end=pool["end"][ti],
        node_types=_node_types(pool["cap"][mi], cost_model, e),
        T=pool["horizon"],
    )


def load_trace_csv(
    path: str,
    cap: np.ndarray,
    cost_model: str = "homogeneous",
    e: float = 1.0,
) -> Problem:
    """Load a processed real trace: CSV rows ``start,end,cpu,mem`` in
    seconds/normalized units; entries with missing fields are purged
    (paper §VI-A)."""
    raw = np.genfromtxt(path, delimiter=",", skip_header=1)
    raw = raw[~np.isnan(raw).any(axis=1)]
    start = raw[:, 0].astype(np.int64)
    end = raw[:, 1].astype(np.int64)
    keep = end >= start
    raw, start, end = raw[keep], start[keep], end[keep]
    return Problem(
        dem=raw[:, 2:4],
        start=start - start.min(),
        end=end - start.min(),
        node_types=_node_types(np.asarray(cap, dtype=float), cost_model, e),
        T=int(end.max() - start.min() + 1),
    )
