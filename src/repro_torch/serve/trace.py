"""Replayable arrival traces + the replay loop.

A trace is a deterministic (seeded) list of ``Request``s: fleet
admissions followed by a mixed stream of task arrivals, departures and
demand bursts — the online regime of Dynamic Vector Bin Packing laid
over the paper's workloads.  ``gct_trace`` samples tasks from the
GCT-2019-like pool (``workload.gct``); ``jobs_trace`` perturbs the
LM-job fleet (``workload.jobs``) with job-shaped arrivals.  The
generator mirrors the service's id assignment exactly (admission ids
are row ranks, each arrival takes the next ids), so departures and
bursts always reference live tasks and the same trace replays to the
same fleets.

``replay`` pushes the trace into a ``RightsizingService`` in bounded
chunks and ticks until drained — the benchmark harness for sustained
requests/sec and p99 re-plan latency.  ``replay_with_crash`` is the
crash-and-recover variant: it snapshots mid-replay, throws the live
service away, restores from the checkpoint, and finishes the trace —
because the snapshot round-trips every float exactly, the recovered
run adopts the same plans at the same costs as an uninterrupted one.

Ported from ``repro.serve.trace``: the port's workloads are bit-equal to the
reference's, so one seed gives the same requests, array for array, in both
packages.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..workload.gct import gct_like_instance, gct_pool
from ..workload.jobs import (BUILTIN_DEMANDS, HBM_PER_CHIP_GB,
                             HOST_PER_CHIP_GB, _SKU_CHIPS, fleet_problem)

from .queue import Request

__all__ = ["TraceSpec", "gct_trace", "jobs_trace", "replay",
           "replay_with_crash"]

_MIN_FLEET_TASKS = 8  # departures never shrink a fleet below this


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Shape of a generated arrival trace (``requests`` counts every
    request, admissions included)."""

    fleets: int = 4
    requests: int = 200
    seed: int = 0
    n0: int = 48                   # tasks per fleet at admission
    m: int = 6                     # node-types per fleet
    arrive_frac: float = 0.5
    depart_frac: float = 0.25
    burst_frac: float = 0.25
    max_batch: int = 6             # tasks per arrival/departure/burst
    burst_span: tuple[float, float] = (1.2, 1.8)
    cost_model: str = "gce"
    cost_e: float = 0.9

    def __post_init__(self):
        if self.fleets < 1 or self.requests < self.fleets:
            raise ValueError(
                f"need >= 1 fleet and requests >= fleets, got "
                f"fleets={self.fleets} requests={self.requests}")
        mix = self.arrive_frac + self.depart_frac + self.burst_frac
        if not math.isclose(mix, 1.0, abs_tol=1e-9):
            raise ValueError(
                f"arrive/depart/burst fractions must sum to 1, got {mix}")


def _perturbations(rng, live: dict, next_id: dict, pool_sample, spec,
                   count: int) -> list[Request]:
    """The shared post-admission stream: arrivals/departures/bursts
    against the tracked live-id sets (mirroring the service)."""
    names = list(live)
    kinds = np.array(["arrive", "depart", "burst"])
    probs = np.array([spec.arrive_frac, spec.depart_frac,
                      spec.burst_frac])
    out: list[Request] = []
    while len(out) < count:
        name = names[int(rng.integers(len(names)))]
        kind = str(rng.choice(kinds, p=probs))
        k = int(rng.integers(1, spec.max_batch + 1))
        if kind == "depart" and len(live[name]) - k < _MIN_FLEET_TASKS:
            kind = "arrive"  # keep fleets non-trivial
        if kind == "arrive":
            dem, start, end = pool_sample(rng, name, k)
            out.append(Request(fleet=name, kind="arrive", dem=dem,
                               start=start, end=end))
            live[name].extend(range(next_id[name], next_id[name] + k))
            next_id[name] += k
        elif kind == "depart":
            picked = sorted(
                rng.choice(live[name], size=k, replace=False).tolist())
            out.append(Request(fleet=name, kind="depart",
                               ids=tuple(int(i) for i in picked)))
            live[name] = [i for i in live[name] if i not in set(picked)]
        else:
            k = min(k, len(live[name]))
            picked = sorted(
                rng.choice(live[name], size=k, replace=False).tolist())
            factor = float(rng.uniform(*spec.burst_span))
            out.append(Request(fleet=name, kind="burst",
                               ids=tuple(int(i) for i in picked),
                               factor=factor))
    return out


def gct_trace(spec: TraceSpec = TraceSpec()) -> list[Request]:
    """GCT-pool trace: each fleet is a paper-protocol instance
    (``gct_like_instance``), arrivals draw fresh tasks from the pool."""
    rng = np.random.default_rng(spec.seed)
    pool = gct_pool()
    requests: list[Request] = []
    live: dict[str, list[int]] = {}
    next_id: dict[str, int] = {}
    for f in range(spec.fleets):
        name = f"gct-{f}"
        prob = gct_like_instance(n=spec.n0, m=spec.m,
                                 seed=spec.seed * 1009 + f,
                                 cost_model=spec.cost_model, e=spec.cost_e)
        requests.append(Request(
            fleet=name, kind="admit", dem=prob.dem, start=prob.start,
            end=prob.end, node_types=prob.node_types, T=prob.T))
        live[name] = list(range(prob.n))
        next_id[name] = prob.n

    def pool_sample(rng, name, k):
        rows = rng.integers(0, len(pool["dem"]), size=k)
        return (pool["dem"][rows], pool["start"][rows], pool["end"][rows])

    requests += _perturbations(rng, live, next_id, pool_sample, spec,
                               spec.requests - spec.fleets)
    return requests


def jobs_trace(spec: TraceSpec = TraceSpec(fleets=2, n0=0),
               dryrun_dir: str = "results/dryrun") -> list[Request]:
    """LM-job trace: fleets are demand-scaled variants of the job
    schedule's fleet problem; arrivals are job-shaped tasks sampled
    from the builtin (arch, shape) catalogue with random hour windows."""
    rng = np.random.default_rng(spec.seed)
    base, _ = fleet_problem(dryrun_dir=dryrun_dir)
    requests: list[Request] = []
    live: dict[str, list[int]] = {}
    next_id: dict[str, int] = {}
    for f in range(spec.fleets):
        name = f"jobs-{f}"
        scale = float(rng.uniform(0.7, 1.3))
        dem = np.clip(base.dem * scale, 0.0,
                      base.node_types.cap.max(axis=0))
        requests.append(Request(
            fleet=name, kind="admit", dem=dem, start=base.start,
            end=base.end, node_types=base.node_types, T=base.T))
        live[name] = list(range(base.n))
        next_id[name] = base.n

    menu = sorted(BUILTIN_DEMANDS.items())
    max_chips = max(_SKU_CHIPS)

    def job_sample(rng, name, k):
        dems, starts, ends = [], [], []
        for _ in range(k):
            _, total_gb = menu[int(rng.integers(len(menu)))]
            chips = min(max_chips,
                        max(1, math.ceil(total_gb / (HBM_PER_CHIP_GB
                                                     * 0.85))))
            dems.append([chips, chips * HBM_PER_CHIP_GB * 0.95,
                         chips * HOST_PER_CHIP_GB * 0.5])
            s = int(rng.integers(0, 20))
            ends.append(min(23, s + int(rng.integers(2, 9))))
            starts.append(s)
        return (np.asarray(dems, dtype=float),
                np.asarray(starts, dtype=np.int64),
                np.asarray(ends, dtype=np.int64))

    requests += _perturbations(rng, live, next_id, job_sample, spec,
                               spec.requests - spec.fleets)
    return requests


def replay(service, requests: list[Request],
           push_per_tick: int = 8) -> dict:
    """Feed a trace into a service in chunks of ``push_per_tick``
    (sustained queue pressure), tick until drained, and return the
    service ``report()``."""
    i = 0
    while i < len(requests) or service.queue.pending:
        chunk = requests[i:i + push_per_tick]
        for req in chunk:
            service.submit(req)
        i += len(chunk) if chunk else 0
        if service.tick() is None and i >= len(requests):
            break
    return service.report()


def replay_with_crash(service, requests: list[Request], *,
                      crash_after_ticks: int, snapshot_dir: str,
                      push_per_tick: int = 8,
                      engine=None) -> tuple[dict, bool]:
    """``replay``, interrupted: after ``crash_after_ticks`` ticks the
    service is checkpointed to ``snapshot_dir``, the live object is
    DISCARDED (simulating a process crash — only the snapshot
    survives), a fresh service is restored from disk, and the replay
    finishes from the same trace position with the restored service's
    recovered queue.

    Returns ``(report, crashed)`` — ``crashed`` is False when the
    trace drained in fewer than ``crash_after_ticks`` ticks, in which
    case the report is just an uninterrupted replay's.  Snapshots
    round-trip all plan/warm-state floats exactly, so a crashed-and-
    recovered replay reports the same ``total_cost`` and
    ``proposed_cost_total`` as an uninterrupted one (wall-clock
    telemetry differs; downtime is excluded from re-plan latency).
    """
    from .service import RightsizingService

    if crash_after_ticks < 1:
        raise ValueError(
            f"crash_after_ticks must be >= 1, got {crash_after_ticks!r}")
    svc = service
    i = ticks = 0
    crashed = False
    while i < len(requests) or svc.queue.pending:
        chunk = requests[i:i + push_per_tick]
        for req in chunk:
            svc.submit(req)
        i += len(chunk) if chunk else 0
        if svc.tick() is None and i >= len(requests):
            break
        ticks += 1
        if not crashed and ticks >= crash_after_ticks:
            svc.snapshot(snapshot_dir)
            restore_engine = engine if engine is not None else svc.engine
            faults = svc.faults
            del svc  # the crash: all in-memory state is gone
            svc = RightsizingService.restore(
                snapshot_dir, engine=restore_engine, faults=faults)
            crashed = True
    return svc.report(), crashed
