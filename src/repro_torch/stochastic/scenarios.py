"""Seeded scenario fan-out: forecast -> K same-shape ``Problem``s.

``fan_out`` samples K Monte-Carlo scenarios from a ``DemandForecast``.
Every scenario is the forecast's base instance with its demand vectors
multiplied by that scenario's sampled factors (load x diurnal x burst,
see ``forecast.py``), clamped per task to the headroom of its
best-fitting node-type so every scenario stays placeable — spans and
catalogue are untouched, so
all K trimmed instances share ONE ``(n, m, D, T')`` shape and
``FleetEngine.solve_scenarios`` solves them in a single batched
dispatch (the whole point of fanning out on the batched engine; a
fan-out that also perturbed arrival *counts* would fracture the shape
and pay one dispatch per shape).

Determinism contract: scenario ``k`` of ``fan_out(fc, K, seed)`` is a
pure function of ``(forecast, seed, k)`` — each scenario draws from
its own ``np.random.default_rng([_FANOUT_TAG, seed, k])`` stream — so
draws are bit-reproducible, independent of K (growing K appends
scenarios without moving the first ones), and independent across
scenarios.  Tests pin same-seed-twice equality and the K-prefix
property.

Ported from ``repro.stochastic.scenarios``: the same streams and the same
clamp, so every scenario's demands are bit-equal to the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Problem, trim_timeline

from .forecast import DemandForecast

__all__ = ["ScenarioSet", "fan_out"]

# namespaces the fan-out's seed streams away from every other
# default_rng(seed) user in the repo (workload generators, traces)
_FANOUT_TAG = 0x5C3A


@dataclasses.dataclass(frozen=True)
class ScenarioSet:
    """K sampled scenarios on a shared shape (``fan_out``'s output).

    problems: the K scenario instances (original timeline; the engine
        trims them on pack, and all K trim to one shape).
    factors: (K, n) sampled per-task demand multipliers *before* the
        feasibility clamp (the raw uncertainty, kept for telemetry).
    forecast / seed: provenance, enough to re-draw the set exactly.
    """

    forecast: DemandForecast
    problems: tuple[Problem, ...]
    factors: np.ndarray
    seed: int

    def __post_init__(self):
        if len(self.problems) != self.factors.shape[0]:
            raise ValueError(
                f"factors must have one row per scenario, got "
                f"{self.factors.shape[0]} rows for "
                f"{len(self.problems)} problems")

    @property
    def K(self) -> int:
        return len(self.problems)

    @property
    def shape(self) -> tuple[int, int, int, int]:
        """The shared trimmed ``(n, m, D, T')`` shape."""
        t = trim_timeline(self.problems[0])[0]
        return (t.n, t.m, t.D, t.T)


def fan_out(forecast: DemandForecast, K: int, seed: int = 0) -> ScenarioSet:
    """Fan a forecast into K deterministic scenario instances.

    >>> from repro_torch.workload import SyntheticSpec, synthetic_instance
    >>> base = synthetic_instance(SyntheticSpec(n=6, m=2, D=2, T=8))
    >>> fc = DemandForecast(base=base, burst_prob=0.2)
    >>> ss = fan_out(fc, K=4, seed=1)
    >>> ss.K, ss.factors.shape
    (4, (4, 6))
    >>> bool((fan_out(fc, K=4, seed=1).factors == ss.factors).all())
    True
    """
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K!r}")
    base = forecast.base
    # per-task burst headroom: the largest factor under which the task
    # still fits SOME single node-type along every dimension (the same
    # best-fitting-SKU clamp the serving layer applies at admission —
    # clipping to the elementwise-max capacity would not do: max-cpu
    # and max-memory can live on different types).  A feasible base
    # has headroom >= 1, so a factor of exactly 1.0 survives the clamp
    # untouched and a zero-variance forecast reproduces the base
    # bit-for-bit.
    cap = base.node_types.cap
    with np.errstate(divide="ignore"):
        ratios = np.where(base.dem[:, None, :] > 0,
                          cap[None, :, :] / base.dem[:, None, :],
                          np.inf)
    headroom = ratios.min(axis=2).max(axis=1)  # (n,)
    problems: list[Problem] = []
    factors = np.empty((K, base.n), dtype=np.float64)
    for k in range(K):
        rng = np.random.default_rng([_FANOUT_TAG, seed, k])
        f = forecast.factors(rng)
        factors[k] = f
        dem = base.dem * np.minimum(f, headroom)[:, None]
        problems.append(dataclasses.replace(base, dem=dem))
    return ScenarioSet(forecast=forecast, problems=tuple(problems),
                       factors=factors, seed=seed)
