"""Demand-forecast model: the distribution a scenario fan-out samples.

The paper plans a minimum-cost cluster for a *known* timeline; real
traffic is a distribution.  ``DemandForecast`` keeps that distribution
small and explicit: a **point-forecast base instance** (the expected
task set, spans, and node-type catalogue — any ``Problem``) plus three
multiplicative uncertainty channels applied per scenario:

  * **load** — one scenario-wide lognormal factor (mean 1,
    ``load_sigma``): "the whole day runs hot/cold";
  * **diurnal** — a phase-jittered sinusoid over each task's start
    slot (amplitude ``diurnal_amp``): "the peaks land earlier/later
    than forecast" (the shape mirrors ``workload.gct``'s diurnal
    arrival mix, which is where the default base comes from);
  * **bursts** — per-task Pareto-tail spikes (probability
    ``burst_prob``, tail index ``burst_alpha``, capped at
    ``burst_cap``): the heavy-tail channel CVaR selection exists for.

All channels are multiplicative on demands, so every scenario keeps
the base's spans and catalogue — after timeline trimming all K
scenarios share ONE ``(n, m, D, T')`` shape and the engine solves them
in one batched dispatch (``FleetEngine.solve_scenarios``).  A forecast
with all three channels at zero is *deterministic*: every scenario
equals the base bit-for-bit, so stochastic planning degenerates to the
paper's point-forecast plan exactly (pinned by a Hypothesis test).

``gct_forecast`` parameterizes a forecast from the GCT-2019-like
generator; ``fit_forecast`` estimates the channel parameters from a
replayed arrival trace (``repro_torch.serve.trace``-shaped requests).

Ported from ``repro.stochastic.forecast``: the same validation and the same
draw order, so a scenario is bit-equal to the reference's from the same
``np.random.Generator`` state.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core import Problem
from ..workload.gct import gct_like_instance

__all__ = ["DemandForecast", "gct_forecast", "fit_forecast"]


@dataclasses.dataclass(frozen=True)
class DemandForecast:
    """A demand distribution around a point-forecast ``base`` instance.

    >>> from repro_torch.workload import SyntheticSpec, synthetic_instance
    >>> base = synthetic_instance(SyntheticSpec(n=6, m=2, D=2, T=8))
    >>> DemandForecast(base=base).deterministic
    False
    >>> DemandForecast(base=base, load_sigma=0.0, diurnal_amp=0.0,
    ...                burst_prob=0.0).deterministic
    True
    >>> DemandForecast(base=base, burst_alpha=0.0)
    Traceback (most recent call last):
        ...
    ValueError: burst_alpha must be positive, got 0.0
    """

    base: Problem
    load_sigma: float = 0.15
    diurnal_amp: float = 0.10
    burst_prob: float = 0.05
    burst_alpha: float = 1.8
    burst_cap: float = 8.0

    def __post_init__(self):
        if not isinstance(self.base, Problem):
            raise ValueError(
                f"base must be a Problem (the point forecast), got "
                f"{type(self.base).__name__}")
        if self.base.n == 0:
            raise ValueError("base must have at least one task")
        if self.load_sigma < 0:
            raise ValueError(
                f"load_sigma must be >= 0, got {self.load_sigma!r}")
        if not 0.0 <= self.diurnal_amp < 1.0:
            raise ValueError(
                f"diurnal_amp must be in [0, 1), got {self.diurnal_amp!r}")
        if not 0.0 <= self.burst_prob <= 1.0:
            raise ValueError(
                f"burst_prob must be in [0, 1], got {self.burst_prob!r}")
        if not self.burst_alpha > 0:
            raise ValueError(
                f"burst_alpha must be positive, got {self.burst_alpha!r}")
        if self.burst_cap < 1.0:
            raise ValueError(
                f"burst_cap must be >= 1 (a burst only ever grows "
                f"demand), got {self.burst_cap!r}")

    @property
    def deterministic(self) -> bool:
        """True when every channel is off: all scenarios == base."""
        return (self.load_sigma == 0.0 and self.diurnal_amp == 0.0
                and self.burst_prob == 0.0)

    def factors(self, rng: np.random.Generator) -> np.ndarray:
        """One scenario's per-task demand multipliers, shape ``(n,)``.

        Draw order is fixed (load, phase, burst mask, burst tails) so
        a given generator state always yields the same scenario.  A
        deterministic forecast returns exactly 1.0 everywhere —
        multiplying by it is a bit-exact no-op.
        """
        base = self.base
        if self.deterministic:
            return np.ones(base.n, dtype=np.float64)
        load = math.exp(rng.normal(-0.5 * self.load_sigma**2,
                                   self.load_sigma)) \
            if self.load_sigma > 0 else 1.0
        phase = rng.uniform(0.0, 2.0 * math.pi)
        diurnal = 1.0 + self.diurnal_amp * np.sin(
            2.0 * math.pi * base.start / max(base.T, 1) - phase) \
            if self.diurnal_amp > 0 else np.ones(base.n)
        burst = np.ones(base.n)
        if self.burst_prob > 0:
            hit = rng.random(base.n) < self.burst_prob
            # Pareto(alpha) with x_m = 1: heavy right tail, so a few
            # tasks per scenario spike hard — the regime that separates
            # CVaR selection from expected-cost selection
            tail = (1.0 - rng.random(base.n)) ** (-1.0 / self.burst_alpha)
            burst = np.where(hit, np.minimum(tail, self.burst_cap), 1.0)
        return load * diurnal * burst


def gct_forecast(n: int = 200, m: int = 8, seed: int = 0,
                 cost_model: str = "gce", e: float = 1.0,
                 **channels) -> DemandForecast:
    """A forecast whose base is a GCT-2019-like paper-protocol instance
    (``workload.gct.gct_like_instance``); ``channels`` override the
    uncertainty parameters (``load_sigma``/``diurnal_amp``/
    ``burst_prob``/``burst_alpha``/``burst_cap``).

    >>> fc = gct_forecast(n=16, m=4, burst_prob=0.1)
    >>> (fc.base.n, fc.base.m, fc.burst_prob)
    (16, 4, 0.1)
    """
    base = gct_like_instance(n=n, m=m, seed=seed,
                             cost_model=cost_model, e=e)
    return DemandForecast(base=base, **channels)


def _pareto_mle(factors: np.ndarray) -> float:
    """Pareto tail-index MLE with x_m = 1: alpha = k / sum(log f)."""
    logs = np.log(np.maximum(factors, 1.0 + 1e-12))
    return float(len(logs) / max(logs.sum(), 1e-12))


def fit_forecast(requests, base: Problem, **overrides) -> DemandForecast:
    """Trace-fitted mode: estimate the uncertainty channels from a
    replayed arrival trace and return a ``DemandForecast`` around
    ``base``.

    ``requests`` is any sequence of ``repro_torch.serve``-shaped request
    records (duck-typed on ``kind``/``fleet``/``dem``/``ids``/
    ``factor`` so this module never imports the serving layer):

      * ``burst_prob`` — bursted-task events over total live-task
        events (each burst request hits ``len(ids)`` tasks);
      * ``burst_alpha`` — Pareto tail-index MLE over the observed
        burst factors (x_m = 1);
      * ``load_sigma`` — the trace is re-applied fleet-by-fleet
        (admit/arrive grow the demand ledger, depart removes rows by
        id, burst multiplies them — mirroring the service's own id
        assignment) and the std of each fleet's log total-demand
        trajectory is pooled by median across fleets.

    Estimates are deterministic in the trace; keyword ``overrides``
    pin any channel instead of estimating it (``diurnal_amp`` is never
    estimated — traces carry no slot phase — so it defaults to 0
    unless overridden).

    >>> from repro_torch.workload import SyntheticSpec, synthetic_instance
    >>> base = synthetic_instance(SyntheticSpec(n=6, m=2, D=2, T=8))
    >>> fit_forecast([], base).deterministic
    True
    """
    ledgers: dict[str, dict[int, float]] = {}
    next_id: dict[str, int] = {}
    totals: dict[str, list[float]] = {}
    burst_factors: list[float] = []
    bursted = 0
    task_events = 0
    for req in requests:
        name = req.fleet
        ledger = ledgers.setdefault(name, {})
        if req.kind in ("admit", "arrive"):
            rows = np.asarray(req.dem, dtype=np.float64).sum(axis=1)
            start = next_id.get(name, 0)
            for i, v in enumerate(rows):
                ledger[start + i] = float(v)
            next_id[name] = start + len(rows)
            task_events += len(rows)
        elif req.kind == "depart":
            for i in req.ids:
                ledger.pop(int(i), None)
        elif req.kind == "burst":
            for i in req.ids:
                if int(i) in ledger:
                    ledger[int(i)] *= float(req.factor)
            burst_factors.append(float(req.factor))
            bursted += len(req.ids)
        else:  # replan and friends carry no demand information
            continue
        total = sum(ledger.values())
        if total > 0:
            totals.setdefault(name, []).append(total)

    est: dict[str, float] = {"diurnal_amp": 0.0}
    est["burst_prob"] = (min(1.0, bursted / task_events)
                         if task_events else 0.0)
    est["burst_alpha"] = (_pareto_mle(np.asarray(burst_factors))
                          if burst_factors else DemandForecast.burst_alpha)
    sigmas = [float(np.std(np.log(np.asarray(t))))
              for t in totals.values() if len(t) >= 2]
    est["load_sigma"] = float(np.median(sigmas)) if sigmas else 0.0
    est.update(overrides)
    return DemandForecast(base=base, **est)
