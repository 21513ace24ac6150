"""``ServiceConfig``: the serving-loop member of the typed-config family.

The engine configs (``SolverConfig`` / ``PlacementConfig`` /
``SweepConfig``) describe ONE fleet evaluation; ``ServiceConfig``
describes the loop around many of them — how aggressively the admission
queue coalesces requests into a tick's micro-batch, when a perturbed
fleet may re-enter PDHG warm versus falling back to a cold solve, and
how the scale decision loop trades savings against reconfiguration
churn.  Like its siblings it is frozen and validates eagerly, so a bad
service is impossible to construct rather than failing mid-stream.

Ported from ``repro.serve.config``: the same fields, defaults and checks.
"""

from __future__ import annotations

import dataclasses

from ..core.engine import DEFAULT_BUCKET_OVERHEAD

__all__ = ["ServiceConfig"]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Serving-loop configuration for ``RightsizingService``.

    Admission / micro-batching
        ``max_requests_per_tick`` caps how many queued requests one tick
        drains; ``max_buckets`` / ``bucket_overhead`` feed the same
        ``plan_buckets`` planner the engine uses, here to partition the
        tick's *touched fleets* into shape buckets — the bucket holding
        the oldest pending request becomes the tick's single dispatch
        and the rest requeue at the front (FIFO fairness).
        ``shape_quantum`` rounds each tick's padded task/slot dims up
        to a multiple, so consecutive ticks whose fleets drift by a few
        tasks reuse one compiled solve instead of recompiling per
        shape (padding is exact, so costs are unaffected).

    Overload shedding / SLO admission
        ``max_pending`` bounds the backlog: when the queue exceeds it
        at a tick boundary, queued ``replan``s are shed with structured
        ``ShedEvent``s (expired-deadline first, then coalesced-away,
        then stalest) until the backlog fits again.  State-changing
        requests (``admit``/``arrive``/``depart``/``burst``) are NEVER
        shed.  ``None`` (the default) disables shedding.  Per-request
        ``deadline_s`` SLOs feed the deadline-miss telemetry whether or
        not shedding is on.

    Fault handling
        ``max_request_retries`` bounds how often a request whose
        application (or whose tick's solve/verify) fails is retried
        before it is quarantined with its error — a poison request
        costs a bounded number of ticks instead of wedging the queue.
        0 quarantines on the first failure.

    Warm starts
        ``warm_start`` re-enters PDHG from each fleet's previous
        ``PDHGState`` (task rows and trimmed time slots re-aligned by
        id).  ``max_shape_drift`` is the fallback knob: when more than
        this fraction of a fleet's task rows or kept time slots no
        longer match the stored state, that lane cold-starts instead.
        ``cost_drift_bound_pct`` documents the warm-vs-cold parity
        bound on the *proposed* placement-cost total
        (``report()['proposed_cost_total']``): both solves stop at the
        same tolerance, so replaying one trace warm and cold proposes
        near-identical aggregate costs — they differ only by which
        epsilon-optimal vertex each solve lands on.  The default budget
        (5%) covers the Ruiz-scaled solver: equilibration changes the
        trajectory, so warm and cold runs land on different degenerate
        vertices more often (measured ~3.8% on the acceptance trace,
        vs ~1.6% unscaled) while cutting warm re-solve iterations ~3x.
        The noise is two-sided — neither replay is systematically
        cheaper.  Tests and the CI gate hold this bound.  *Adopted*
        plan costs are NOT bounded
        this tightly: the flag-gated decision loop is path-dependent
        (a cooldown latched on one run but not the other compounds
        over subsequent ticks), so ``total_cost`` may drift several
        times further while every individual proposal stays in bound.

    Scale decision loop
        Scale-OUT is forced (holding a too-small fleet is infeasible).
        Scale-IN must pass every flag: a cooldown of
        ``scale_in_cooldown`` ticks since the fleet's last scale-in,
        a savings fraction of at least ``min_scale_in_savings``, and an
        Eva-style reconfiguration payback — projected savings over
        ``payback_ticks`` must exceed ``reconfig_weight`` x the node
        churn cost (each changed node is priced at that fraction of its
        hourly cost, standing in for drain/migration).  A rejected
        scale-in holds the superset ``max(current, required)`` so the
        proposed placement stays feasible without thrash.

    >>> ServiceConfig().warm_start
    True
    >>> ServiceConfig(max_requests_per_tick=0)
    Traceback (most recent call last):
        ...
    ValueError: max_requests_per_tick must be >= 1, got 0
    >>> ServiceConfig(max_shape_drift=1.5)
    Traceback (most recent call last):
        ...
    ValueError: max_shape_drift must be in [0, 1], got 1.5
    """

    max_requests_per_tick: int = 32
    max_buckets: int = 4
    bucket_overhead: float = DEFAULT_BUCKET_OVERHEAD
    warm_start: bool = True
    max_shape_drift: float = 0.5
    cost_drift_bound_pct: float = 5.0
    reconfig_weight: float = 0.5
    payback_ticks: int = 12
    scale_in_cooldown: int = 3
    min_scale_in_savings: float = 0.02
    filling: bool = True
    shape_quantum: int = 8
    max_pending: int | None = None
    max_request_retries: int = 2

    def __post_init__(self):
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 (or None to disable "
                f"shedding), got {self.max_pending!r}")
        if self.max_request_retries < 0:
            raise ValueError(
                f"max_request_retries must be >= 0, got "
                f"{self.max_request_retries!r}")
        if self.max_requests_per_tick < 1:
            raise ValueError(
                f"max_requests_per_tick must be >= 1, got "
                f"{self.max_requests_per_tick!r}")
        if self.max_buckets < 1:
            raise ValueError(
                f"max_buckets must be >= 1, got {self.max_buckets!r}")
        if self.bucket_overhead < 0:
            raise ValueError(
                f"bucket_overhead must be >= 0, got "
                f"{self.bucket_overhead!r}")
        if not 0.0 <= self.max_shape_drift <= 1.0:
            raise ValueError(
                f"max_shape_drift must be in [0, 1], got "
                f"{self.max_shape_drift!r}")
        if self.cost_drift_bound_pct < 0:
            raise ValueError(
                f"cost_drift_bound_pct must be >= 0, got "
                f"{self.cost_drift_bound_pct!r}")
        if self.reconfig_weight < 0:
            raise ValueError(
                f"reconfig_weight must be >= 0, got "
                f"{self.reconfig_weight!r}")
        if self.payback_ticks < 1:
            raise ValueError(
                f"payback_ticks must be >= 1, got {self.payback_ticks!r}")
        if self.scale_in_cooldown < 0:
            raise ValueError(
                f"scale_in_cooldown must be >= 0, got "
                f"{self.scale_in_cooldown!r}")
        if not 0.0 <= self.min_scale_in_savings < 1.0:
            raise ValueError(
                f"min_scale_in_savings must be in [0, 1), got "
                f"{self.min_scale_in_savings!r}")
        if self.shape_quantum < 1:
            raise ValueError(
                f"shape_quantum must be >= 1, got {self.shape_quantum!r}")
