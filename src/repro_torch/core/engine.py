"""FleetEngine: the typed-config session API of the fleet evaluation path.

A ``FleetEngine`` session, configured by three frozen dataclasses, runs the
paper's §VI protocol over a fleet of instances on one device:

  * ``SolverConfig``    — LP phase: the stopping regime (legacy fixed
                          ``iters``, or ``tol`` with ``iters`` as the cap),
                          the tol-mode machinery (adaptive steps, restarts,
                          Ruiz scaling, primal weight, precision) and the
                          congestion operator form (``dense``/``cumsum``/
                          ``pallas``, the last one the hand-written CUDA
                          kernel).
  * ``PlacementConfig`` — greedy phase: the numpy lockstep engine
                          (``batched``), the compiled stepper
                          (``compiled``: one CUDA launch per sub-phase) or
                          the per-instance loop (``loop``), the fit-policy
                          scan, and the scoring backend (``kernel`` = the
                          CUDA fit kernel).
  * ``SweepConfig``     — fleet shape: shape-bucketed packing, the shard
                          size of the LP dispatch, and warm-started sweep
                          chains (one host call with ``pipeline``).
  * ``FleetEngine``     — ``pack(problems)``, ``solve(...)``,
                          ``place(...)``, ``evaluate(...)`` ->
                          ``FleetResult``.

Ported from ``repro.core.engine``.  What this port does not have yet raises
``NotImplementedError`` naming the ROADMAP entry that brings it: a sweep
pipeline sharded over more than one card (``SweepConfig(devices>1)``,
"multi-card pipeline sharding"), scenario groups (``solve_scenarios``,
Queue 1 item 11), and instances with active constraints (item 8).

``device`` (None = the CUDA card) is where the LP solve runs, where the
``kernel`` backend scores placements and where the compiled stepper keeps
its pools; the placement bookkeeping stays float64 numpy on the host.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from ..device import resolve_device
from .api import ALGORITHMS
from .batch import (DEFAULT_CHECK_EVERY, OPERATORS, PRECISIONS, SCALINGS,
                    ProblemBatch, _sweep_impl, _check_devices, pack_problems,
                    solve_lp_many)
from .constraints import expand_solution, lower_constraints
from .lp_pdhg import PDHGResult, PDHGState, SolveStats
from .penalty import penalty_map
from .place_batch import place_many
from .placement import FIT_POLICIES, two_phase
from .problem import Problem, trim_timeline
from .solution import Solution, verify

__all__ = [
    "SolverConfig", "PlacementConfig", "SweepConfig", "FleetEngine",
    "FleetResult", "PackPlan", "Bucket", "plan_buckets",
    "DEFAULT_BUCKET_OVERHEAD",
]

_PLACEMENT_ENGINES = ("batched", "compiled", "loop")
# the place_many stepper behind each batched placement engine
_ENGINE_STEPPER = {"batched": "lockstep", "compiled": "compiled"}
_PLACEMENT_BACKENDS = ("numpy", "kernel")

# Planner cost of one extra shape bucket, as a fraction of the
# single-bucket padded cell count.
DEFAULT_BUCKET_OVERHEAD = 0.03


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, item {item})")


# --- typed configs ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Mapping-LP phase configuration (``core.batch.solve_lp_many``).

    tol=None runs the legacy fixed-step, fixed-``iters`` solve at
    ``step_scale`` times the largest stable step; tol=<float> runs the
    adaptive restarted engine until every lane's normalized duality gap is
    below tol, with ``iters`` as the cap.  ``adaptive`` / ``restart``
    ablate the PDLP machinery; ``check_every`` is the tol-mode
    convergence-check cadence; ``operator`` picks the congestion-operator
    form.  The tol-mode speed knobs (legacy mode ignores them):
    ``scaling='ruiz'`` equilibrates the operator by an exact change of
    variables, ``precision='mixed'`` iterates in f32 with an f64
    certificate and a final f64 polish ('f64' iterates in f64), ``omega``
    balances the primal weight.

    >>> SolverConfig().tol is None
    True
    >>> SolverConfig(scaling="log")
    Traceback (most recent call last):
        ...
    ValueError: scaling must be one of ('none', 'ruiz'), got 'log'
    >>> SolverConfig(iters=0)
    Traceback (most recent call last):
        ...
    ValueError: iters must be >= 1, got 0
    """

    tol: float | None = None
    iters: int = 2000
    adaptive: bool = True
    restart: bool = True
    operator: str = "auto"
    step_scale: float = 0.9
    check_every: int = DEFAULT_CHECK_EVERY
    scaling: str = "ruiz"
    precision: str = "mixed"
    omega: bool = True

    def __post_init__(self):
        if self.tol is not None and not self.tol > 0:
            raise ValueError(f"tol must be positive or None, got {self.tol!r}")
        if self.iters < 1:
            raise ValueError(f"iters must be >= 1, got {self.iters!r}")
        if self.operator not in OPERATORS:
            raise ValueError(
                f"operator must be one of {OPERATORS}, got {self.operator!r}")
        if not self.step_scale > 0:
            raise ValueError(
                f"step_scale must be positive, got {self.step_scale!r}")
        if self.check_every < 1:
            raise ValueError(
                f"check_every must be >= 1, got {self.check_every!r}")
        if self.scaling not in SCALINGS:
            raise ValueError(
                f"scaling must be one of {SCALINGS}, got {self.scaling!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, "
                f"got {self.precision!r}")


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """Greedy placement phase configuration.

    engine='batched' advances all instances in lockstep (``place_many``);
    'compiled' runs the same lockstep as one CUDA stepper launch per
    node-type sub-phase (``place_many(placement='compiled')``); 'loop' runs
    the per-instance ``two_phase`` loop.  Placements and costs are
    identical across engines.  fit='best' scans every fit policy and
    keeps the per-instance minimum (the paper's §VI protocol); a concrete
    policy narrows the scan.  ``filling`` only applies to direct
    ``FleetEngine.place`` calls.  ``backend='kernel'`` scores placements
    with the hand-written CUDA fit kernel.  ``check`` verifies every
    returned placement.

    >>> PlacementConfig(fit="similarity").fits
    ('similarity',)
    """

    engine: str = "batched"
    fit: str = "best"
    filling: bool = False
    backend: str = "numpy"
    check: bool = True

    def __post_init__(self):
        if self.engine not in _PLACEMENT_ENGINES:
            raise ValueError(
                f"placement engine must be one of {_PLACEMENT_ENGINES}, "
                f"got {self.engine!r}")
        if self.fit != "best" and self.fit not in FIT_POLICIES:
            raise ValueError(
                f"fit must be 'best' or one of {FIT_POLICIES}, "
                f"got {self.fit!r}")
        if self.backend not in _PLACEMENT_BACKENDS:
            raise ValueError(
                f"placement backend must be one of {_PLACEMENT_BACKENDS}, "
                f"got {self.backend!r}")

    @property
    def fits(self) -> tuple[str, ...]:
        return FIT_POLICIES if self.fit == "best" else (self.fit,)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Fleet-shape configuration: bucketing, sharding, warm starts.

    max_buckets caps the shape-bucket partition of the packing planner
    (1 = single-bucket packing); bucket_overhead is the planner's cost of
    one extra bucket as a fraction of the single-bucket padded cells.
    shard_size splits each bucket's LP solve into dispatches of at most
    that many instances (results unchanged).  warm_start=k treats the
    instances as a grid-adjacent sweep chained in consecutive groups of k
    (None = off; when k does not divide B the trailing group is smaller
    and cold-starts).  pipeline=True runs the whole chain as one host call
    with the state kept on the device (k must divide B).  ``devices``
    needs ``pipeline``; None or 1 runs on the session's device, and more
    than one card raises ``NotImplementedError`` (ROADMAP: multi-card
    pipeline sharding).  warm_start excludes max_buckets > 1 and
    shard_size: the chain packs every group to one common shape.

    >>> SweepConfig(warm_start=2, max_buckets=3)
    Traceback (most recent call last):
        ...
    ValueError: SweepConfig.warm_start and SweepConfig.max_buckets > 1 are mutually exclusive: ...
    """

    warm_start: int | None = None
    shard_size: int | None = None
    max_buckets: int = 1
    bucket_overhead: float = DEFAULT_BUCKET_OVERHEAD
    pipeline: bool = False
    devices: int | None = None

    def __post_init__(self):
        if self.warm_start is not None and self.warm_start <= 0:
            raise ValueError(
                f"warm_start must be a positive group size, got "
                f"{self.warm_start!r}; use warm_start=None to disable "
                f"warm-started sweep chaining")
        if self.shard_size is not None and self.shard_size <= 0:
            raise ValueError(
                f"shard_size must be a positive instance count, got "
                f"{self.shard_size!r}")
        if self.max_buckets < 1:
            raise ValueError(
                f"max_buckets must be >= 1, got {self.max_buckets!r}")
        if self.bucket_overhead < 0:
            raise ValueError(
                f"bucket_overhead must be >= 0, got {self.bucket_overhead!r}")
        if self.warm_start is not None and self.max_buckets > 1:
            raise ValueError(
                "SweepConfig.warm_start and SweepConfig.max_buckets > 1 "
                "are mutually exclusive: warm-started sweep chaining "
                "packs every group to one common shape (states must "
                "align lane-for-lane), while bucketing splits shapes apart")
        if self.warm_start is not None and self.shard_size is not None:
            raise ValueError(
                "SweepConfig.warm_start and SweepConfig.shard_size are "
                "mutually exclusive: the warm chain already dispatches "
                "one group at a time (warm_start IS its shard size), so "
                "a separate shard size would be silently ignored")
        if self.pipeline and self.warm_start is None:
            raise ValueError(
                "SweepConfig.pipeline=True requires warm_start: the "
                "pipeline IS the warm-started sweep chain run as one host "
                "call; set warm_start=<group size> to enable it")
        if self.devices is not None and not self.pipeline:
            raise ValueError(
                "SweepConfig.devices requires pipeline=True: it shards the "
                "sweep pipeline's lanes; sequential dispatches don't shard")
        if self.devices is not None and self.devices < 1:
            raise ValueError(
                f"devices must be >= 1 or None, got {self.devices!r}")
        _check_devices(self.devices)


# --- shape-bucketed packing planner ----------------------------------------

def _own_cells(t: Problem) -> int:
    return t.n * t.m * t.D * t.T


def plan_buckets(problems, max_buckets: int = 1,
                 overhead: float = DEFAULT_BUCKET_OVERHEAD) -> list[list[int]]:
    """Partition (trimmed) instances into <= max_buckets shape buckets.

    Minimizes total padded cells ``sum_b B_b * n̂_b * m̂_b * D̂_b * T̂_b``
    (hats = per-bucket dimension maxima — the padded footprint every
    batched array and operator apply scales with) plus ``overhead *
    single_bucket_cells`` per bucket beyond the first (the extra-compile
    cost).  Instances are sorted by their own cell count and the DP
    finds the optimal contiguous partition of that order, which captures
    the ragged-sweep structure (shapes grow along sweep axes) without a
    4-D clustering pass.  Ties prefer fewer buckets; each returned
    bucket lists its instance indices in ascending submission order.
    """
    B = len(problems)
    if B == 0:
        raise ValueError("plan_buckets needs at least one instance")
    dims = np.array([(t.n, t.m, t.D, t.T) for t in problems], np.int64)
    if max_buckets <= 1 or B == 1:
        return [list(range(B))]
    cells = dims.prod(axis=1)
    order = sorted(range(B), key=lambda i: (int(cells[i]),
                                            tuple(dims[i]), i))
    sd = dims[order]  # (B, 4) in planning order
    single = float(B * sd.max(axis=0).prod())
    pay = overhead * single

    K = min(max_buckets, B)
    INF = float("inf")
    # dp[j] = min padded cells of the first j planned instances split
    # into exactly k buckets; the last bucket [i, j) has its per-dim
    # maxima accumulated by walking i downward, so one layer is O(B^2)
    dp_prev = [0.0] + [INF] * B  # k=0 layer: only 0 instances coverable
    best_cost, best_k = INF, 1
    cuts: list[list[int | None]] = []
    for k in range(1, K + 1):
        dp: list[float] = [INF] * (B + 1)
        cut: list[int | None] = [None] * (B + 1)
        for j in range(k, B + 1):
            mx = sd[j - 1].copy()
            for i in range(j - 1, k - 2, -1):
                np.maximum(mx, sd[i], out=mx)
                if dp_prev[i] == INF:
                    continue
                cand = dp_prev[i] + float((j - i) * mx.prod())
                if cand < dp[j]:
                    dp[j] = cand
                    cut[j] = i
        cuts.append(cut)
        total = dp[B] + pay * (k - 1)
        if total < best_cost:  # strict: exact ties keep fewer buckets
            best_cost, best_k = total, k
        dp_prev = dp

    # reconstruct the best_k-bucket partition
    segs = []
    j, k = B, best_k
    while j > 0:
        i = cuts[k - 1][j]
        segs.append((i, j))
        j, k = i, k - 1
    segs.reverse()
    return [sorted(order[i:j]) for i, j in segs]



@dataclasses.dataclass(frozen=True)
class Bucket:
    """One shape bucket: submission-order indices + their packed batch."""

    indices: tuple[int, ...]
    batch: ProblemBatch

    @property
    def B(self) -> int:
        return self.batch.B

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return self.batch.shape

    @property
    def cells(self) -> int:
        """Padded cells of this bucket's batched arrays."""
        b = self.batch
        return b.B * b.n * b.m * b.D * b.Tp

    @property
    def own_cells(self) -> int:
        return sum(_own_cells(t) for t in self.batch.problems)


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """A bucketed packing of one fleet: the output of ``FleetEngine.pack``.

    ``buckets[b].indices`` are submission-order instance indices; their
    concatenation is a permutation of ``range(n_instances)`` (the merge
    key ``FleetEngine.evaluate`` uses to restore submission order).
    ``cells_single`` is the padded cell count of legacy single-bucket
    packing, the baseline every waste metric compares against.
    """

    buckets: tuple[Bucket, ...]
    n_instances: int
    cells_single: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def cells_packed(self) -> int:
        return sum(b.cells for b in self.buckets)

    @property
    def cells_own(self) -> int:
        return sum(b.own_cells for b in self.buckets)

    @property
    def waste_single(self) -> float:
        """Padded-cell waste fraction of single-bucket packing."""
        return 1.0 - self.cells_own / max(self.cells_single, 1)

    @property
    def waste_packed(self) -> float:
        """Padded-cell waste fraction of this bucketed packing."""
        return 1.0 - self.cells_own / max(self.cells_packed, 1)

    @property
    def waste_reduction(self) -> float:
        """Fraction of single-bucket WASTED cells this plan eliminates."""
        wasted_single = self.cells_single - self.cells_own
        wasted_packed = self.cells_packed - self.cells_own
        if wasted_single <= 0:
            return 0.0
        return 1.0 - wasted_packed / wasted_single

    def summary(self) -> dict:
        return {
            "buckets": self.n_buckets,
            "bucket_sizes": [b.B for b in self.buckets],
            "bucket_shapes": [list(b.shape) for b in self.buckets],
            "cells_single": int(self.cells_single),
            "cells_packed": int(self.cells_packed),
            "cells_own": int(self.cells_own),
            "waste_frac_single": round(self.waste_single, 4),
            "waste_frac_bucketed": round(self.waste_packed, 4),
            "waste_reduction": round(self.waste_reduction, 4),
        }


# --- structured results ----------------------------------------------------

@dataclasses.dataclass
class FleetResult:
    """Structured output of ``FleetEngine.evaluate``.

    entries: one §VI protocol dict per instance, in submission order —
        {'lb', 'costs': {algo: cost}, 'normalized': {algo: cost/lb},
        'wall_s': {algo: s}} plus a 'solver' telemetry block in tol
        mode (iters/restarts/kkt/converged per instance).
    stats: the ``SolveStats`` of each batched LP dispatch (one per bucket
        shard, or one per warm-started group); empty in legacy
        fixed-iters mode.
    plan: the bucketed ``PackPlan`` (None on the warm-sweep path, which
        packs to one common shape by construction).
    timings: phase breakdown — pack_s / lp_s / place_s / total_s plus
        per-bucket lists bucket_lp_s / bucket_place_s and a
        ``placement`` block (which placement engine ran, stepper calls
        and waves, summed per-wave seconds).
    lp_results: each instance's ``PDHGResult`` (mapping and bounds), in
        submission order, so a caller can place or re-check an instance
        with the fleet's own LP solution.

    >>> r = FleetResult(
    ...     entries=[{"lb": 1.0, "costs": {"lp-map": 2.0},
    ...               "normalized": {"lp-map": 2.0},
    ...               "wall_s": {"lp-map": 0.1}}],
    ...     stats=[], plan=None, timings={})
    >>> r.algos, r.costs("lp-map")
    (('lp-map',), [2.0])
    >>> r.to_rows()[0]["cost[lp-map]"]
    2.0
    """

    entries: list[dict]
    stats: list[SolveStats]
    plan: PackPlan | None
    timings: dict
    lp_results: list = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def algos(self) -> tuple[str, ...]:
        return tuple(self.entries[0]["costs"]) if self.entries else ()

    def costs(self, algo: str) -> list[float]:
        return [e["costs"][algo] for e in self.entries]

    def to_rows(self) -> list[dict]:
        """Flat benchmark rows, one per instance (JSON/CSV-ready)."""
        rows = []
        for i, e in enumerate(self.entries):
            row: dict = {"instance": i, "lb": e["lb"]}
            for algo in e["costs"]:
                row[f"cost[{algo}]"] = e["costs"][algo]
                row[f"normalized[{algo}]"] = e["normalized"][algo]
                row[f"wall_s[{algo}]"] = e["wall_s"][algo]
            for key, val in e.get("solver", {}).items():
                row[f"solver.{key}"] = val
            rows.append(row)
        return rows

    def to_json(self, indent: int | None = None) -> str:
        """Whole-result JSON: rows + plan summary + timings + solver
        aggregates (what the benchmark drivers persist)."""
        blob = {
            "entries": self.to_rows(),
            "timings": self.timings,
            "plan": self.plan.summary() if self.plan is not None else None,
            "solver": [s.summary() for s in self.stats],
        }
        return json.dumps(blob, indent=indent)



# --- the protocol engine ---------------------------------------------------

def _protocol_batched(batch: ProblemBatch, lp_results, algos, fits,
                      backend: str, device, check: bool = True,
                      stepper: str = "lockstep",
                      tels: list | None = None) -> list[dict]:
    """Batched placement protocol: every (mapping, fit, filling) combo of
    every algorithm runs as ONE lockstep ``place_many`` over the grid;
    per-call stepper telemetry is appended to ``tels``."""
    from .api import rightsize

    B = batch.B
    out = [{"lb": res.lower_bound, "costs": {}, "normalized": {},
            "wall_s": {}} for res in lp_results]
    for algo in algos:
        t0 = time.perf_counter()
        filling = algo.endswith("-f")
        if algo in ("penalty-map", "penalty-map-f"):
            mapsets = [[penalty_map(t, kind) for t in batch.problems]
                       for kind in ("avg", "max")]
        elif algo in ("lp-map", "lp-map-f"):
            mapsets = [[res.mapping for res in lp_results]]
        else:
            # extended algos (e.g. "+ls") keep the per-instance path
            for b, t in enumerate(batch.problems):
                sol = rightsize(t, algo, backend=backend,
                                lp_result=lp_results[b], check=check,
                                device=device)
                out[b]["costs"][algo] = sol.cost(t)
                out[b]["wall_s"][algo] = sol.meta["wall_s"]
            continue
        best: list[Solution | None] = [None] * B
        best_cost = [float("inf")] * B
        for maps in mapsets:
            for fit in fits:
                tel: dict = {}
                sols = place_many(batch, maps, fit=fit, filling=filling,
                                  backend=backend, meta={"algo": algo},
                                  placement=stepper, telemetry=tel,
                                  device=device)
                if tels is not None:
                    tels.append(tel)
                for b, (t, s) in enumerate(zip(batch.problems, sols)):
                    c = s.cost(t)
                    if c < best_cost[b]:
                        best_cost[b], best[b] = c, s
        wall = (time.perf_counter() - t0) / B
        for b, t in enumerate(batch.problems):
            if check:
                verify(t, best[b])
            out[b]["costs"][algo] = best_cost[b]
            out[b]["wall_s"][algo] = wall
    for entry in out:
        lb = max(entry["lb"], 1e-12)
        entry["normalized"] = {a: c / lb
                               for a, c in entry["costs"].items()}
    return out


def _placement_telemetry(engine: str, tels: list) -> dict:
    """Aggregate per-call stepper telemetry into the ``FleetResult``
    timings block: which engine ran, how many calls and waves, the summed
    per-wave seconds and, for the compiled stepper, its device dispatches,
    how often it fell back, the modes it ran in and the lanes whose open
    rows outgrew the kernel's shared memory."""
    out: dict = {"engine": engine, "calls": len(tels)}
    if engine == "loop" or not tels:
        return out
    out["waves"] = max((t.get("waves", 0) for t in tels), default=0)
    out["wave_s_total"] = sum(sum(t.get("wave_s", ())) for t in tels)
    if engine == "compiled":
        out["dispatches"] = sum(t.get("dispatches", 0) for t in tels)
        out["fallbacks"] = sum(1 for t in tels
                               if t.get("engine") != "compiled")
        out["modes"] = sorted({t["mode"] for t in tels if "mode" in t})
        out["spilled_lanes"] = sum(t.get("spilled_lanes", 0) for t in tels)
    return out


class FleetEngine:
    """One configured fleet-evaluation session (the §VI protocol at fleet
    scale) on one device: ``pack`` plans the shape buckets, ``solve`` runs
    the mapping-LP phase, ``place`` runs one greedy placement pass, and
    ``evaluate`` runs the whole protocol into a ``FleetResult``.

        engine = FleetEngine(
            solver=SolverConfig(tol=5e-3, iters=4000, operator="pallas"),
            placement=PlacementConfig(engine="compiled"),
        )                                   # device=None: the CUDA card
        result = engine.evaluate(problems)
        result.entries[0]["normalized"]     # cost / LP lower bound
        result.entries[0]["solver"]         # iters, restarts, kkt, converged

    >>> from repro_torch.core import FleetEngine, SolverConfig
    >>> from repro_torch.workload import SyntheticSpec, synthetic_instance
    >>> fleet = [synthetic_instance(SyntheticSpec(n=10, m=2, D=2, T=6,
    ...                                           seed=s))
    ...          for s in (0, 1)]
    >>> engine = FleetEngine(solver=SolverConfig(iters=40),
    ...                      algos=("penalty-map",), device="cpu")
    >>> result = engine.evaluate(fleet)
    >>> len(result), result.algos
    (2, ('penalty-map',))
    """

    def __init__(self, solver: SolverConfig | None = None,
                 placement: PlacementConfig | None = None,
                 sweep: SweepConfig | None = None,
                 algos=ALGORITHMS, device=None):
        self.solver = solver if solver is not None else SolverConfig()
        self.placement = placement if placement is not None \
            else PlacementConfig()
        self.sweep = sweep if sweep is not None else SweepConfig()
        self.algos = tuple(algos)
        self.device = resolve_device(device)
        if self.sweep.warm_start is not None and self.solver.tol is None:
            raise ValueError(
                "warm_start requires a tolerance-stopped solver "
                "(SolverConfig(tol=...)); fixed-iteration solves gain "
                "nothing from a warm start")
        if self.placement.engine == "loop" and self.placement.fit != "best":
            raise ValueError(
                "the per-instance 'loop' placement engine always scans "
                "every fit policy (the legacy protocol); narrowing "
                "PlacementConfig.fit requires engine='batched'")

    def with_overrides(self, **changes) -> "FleetEngine":
        """Derive a new engine with field-level changes routed across the
        config family: any field of ``SolverConfig`` / ``PlacementConfig``
        / ``SweepConfig`` by name, whole configs via ``solver=`` /
        ``placement=`` / ``sweep=``, and ``algos=`` / ``device=``.  The
        base engine is untouched.

        >>> eng = FleetEngine(device="cpu")
        >>> eng.with_overrides(iters=50, fit="first").solver.iters
        50
        """
        changes = dict(changes)
        parts = {
            "solver": changes.pop("solver", self.solver),
            "placement": changes.pop("placement", self.placement),
            "sweep": changes.pop("sweep", self.sweep),
        }
        algos = changes.pop("algos", self.algos)
        device = changes.pop("device", self.device)
        owner = {f.name: g for g, cfg in parts.items()
                 for f in dataclasses.fields(cfg)}
        grouped: dict[str, dict] = {g: {} for g in parts}
        for name, value in changes.items():
            if name not in owner:
                known = ", ".join(sorted(owner))
                raise ValueError(
                    f"with_overrides got unknown field {name!r}; "
                    f"expected solver=/placement=/sweep=/algos=/device= or "
                    f"one of the config fields: {known}")
            grouped[owner[name]][name] = value
        return FleetEngine(
            solver=dataclasses.replace(parts["solver"],
                                       **grouped["solver"]),
            placement=dataclasses.replace(parts["placement"],
                                          **grouped["placement"]),
            sweep=dataclasses.replace(parts["sweep"], **grouped["sweep"]),
            algos=algos, device=device)

    # -- phase 0: pack -------------------------------------------------

    def pack(self, problems) -> PackPlan:
        """Trim, bucket (``plan_buckets``), and pad-and-stack a fleet.

        A pre-packed ``ProblemBatch`` passes through as one bucket."""
        if isinstance(problems, ProblemBatch):
            bucket = Bucket(indices=tuple(range(problems.B)),
                            batch=problems)
            return PackPlan(buckets=(bucket,), n_instances=problems.B,
                            cells_single=bucket.cells)
        trimmed = self._trimmed(problems)
        if not trimmed:
            raise ValueError("FleetEngine.pack needs at least one instance")
        parts = plan_buckets(trimmed, max_buckets=self.sweep.max_buckets,
                             overhead=self.sweep.bucket_overhead)
        buckets = tuple(
            Bucket(indices=tuple(idx),
                   batch=pack_problems([trimmed[i] for i in idx],
                                       assume_trimmed=True))
            for idx in parts)
        n_hat = max(t.n for t in trimmed)
        m_hat = max(t.m for t in trimmed)
        d_hat = max(t.D for t in trimmed)
        t_hat = max(t.T for t in trimmed)
        return PackPlan(
            buckets=buckets, n_instances=len(trimmed),
            cells_single=len(trimmed) * n_hat * m_hat * d_hat * t_hat)

    # -- phase 1: the mapping-LP solve ---------------------------------

    def _solve_batch(self, batch: ProblemBatch, init=None):
        """One LP dispatch under ``self.solver`` -> (results, [stats])."""
        cfg = self.solver
        if cfg.tol is None:
            res = solve_lp_many(batch, iters=cfg.iters,
                                step_scale=cfg.step_scale,
                                operator=cfg.operator, init=init,
                                device=self.device)
            return res, []
        res, st = solve_lp_many(
            batch, iters=cfg.iters, step_scale=cfg.step_scale,
            operator=cfg.operator, tol=cfg.tol, adaptive=cfg.adaptive,
            restart=cfg.restart, check_every=cfg.check_every, init=init,
            scaling=cfg.scaling, precision=cfg.precision, omega=cfg.omega,
            full_output=True, device=self.device)
        return res, [st]

    @staticmethod
    def _slice_state(state: PDHGState | None, lo: int, hi: int):
        if state is None:
            return None
        return PDHGState(
            x=state.x[lo:hi], y=state.y[lo:hi],
            eta=None if state.eta is None else state.eta[lo:hi],
            omega=None if state.omega is None else state.omega[lo:hi])

    def _solve_bucket(self, bucket: Bucket, init: PDHGState | None = None):
        """Solve one bucket, sharded to ``sweep.shard_size`` instances per
        dispatch; an ``init`` state is sliced lane-for-lane."""
        shard = self.sweep.shard_size
        batch = bucket.batch
        if shard is None or batch.B <= shard:
            return self._solve_batch(batch, init=init)
        shape = batch.shape
        results: list[PDHGResult] = []
        stats: list[SolveStats] = []
        for i in range(0, batch.B, shard):
            sub = pack_problems(batch.problems[i : i + shard],
                                pad_to=shape, assume_trimmed=True)
            res, st = self._solve_batch(
                sub, init=self._slice_state(init, i, i + shard))
            results.extend(res)
            stats.extend(st)
        return results, stats

    def solve(self, problems, init: PDHGState | None = None):
        """Mapping-LP phase only: ``(results, stats)`` with one
        ``PDHGResult`` per instance in submission order (``stats`` is
        empty in legacy mode).  Accepts a problem sequence, a
        ``ProblemBatch`` or a ``PackPlan``; ``init`` starts lane b from
        lane b of a previous ``PDHGState``, needs a single-bucket plan and
        is rejected on the warm-started sweep path, which seeds each
        group from its predecessor."""
        if self.sweep.warm_start is not None:
            if init is not None:
                raise ValueError(
                    "solve(init=...) conflicts with "
                    "SweepConfig.warm_start: the warm-started sweep "
                    "chain seeds each group from its predecessor")
            return self._solve_warm(self._trimmed(problems))
        plan = problems if isinstance(problems, PackPlan) \
            else self.pack(problems)
        if init is not None and plan.n_buckets > 1:
            raise ValueError(
                f"solve(init=...) needs a single-bucket plan (state "
                f"lanes align with one dispatch), got {plan.n_buckets} "
                f"buckets; pack to one bucket or pass a ProblemBatch")
        results: list[PDHGResult | None] = [None] * plan.n_instances
        stats: list[SolveStats] = []
        for bucket in plan.buckets:
            res, st = self._solve_bucket(bucket, init=init)
            for i, r in zip(bucket.indices, res):
                results[i] = r
            stats.extend(st)
        return results, stats

    def solve_scenarios(self, problems, init: PDHGState | None = None):
        """Same-shape scenario groups are ROADMAP Queue 1, item 11."""
        raise _not_ported("solve_scenarios (scenario groups)", "11")

    def _trimmed(self, problems) -> list[Problem]:
        if isinstance(problems, ProblemBatch):
            return list(problems.problems)
        if isinstance(problems, PackPlan):
            raise ValueError(
                "this call takes the problem sequence itself (in "
                "grid-adjacent order for a warm-started sweep), not a "
                "PackPlan")
        return [trim_timeline(lower_constraints(p).lowered)[0]
                for p in problems]

    def _solve_warm(self, trimmed: list[Problem]):
        """Warm-started sweep chain over consecutive groups of
        ``sweep.warm_start`` instances; under ``pipeline=True`` the group
        size must divide the instance count."""
        cfg, k = self.solver, self.sweep.warm_start
        if self.sweep.pipeline and len(trimmed) % k:
            raise ValueError(
                f"SweepConfig(pipeline=True) needs warm_start "
                f"({k}) to divide the instance count ({len(trimmed)}): "
                f"the pipeline chains equal-shaped groups; pad the fleet "
                f"or adjust the group size")
        groups = [trimmed[i : i + k] for i in range(0, len(trimmed), k)]
        return _sweep_impl(
            groups, tol=cfg.tol, iters=cfg.iters,
            step_scale=cfg.step_scale, operator=cfg.operator,
            adaptive=cfg.adaptive, restart=cfg.restart,
            check_every=cfg.check_every, scaling=cfg.scaling,
            precision=cfg.precision, omega=cfg.omega,
            pipeline=self.sweep.pipeline, devices=self.sweep.devices,
            device=self.device)

    # -- phase 2: greedy placement -------------------------------------

    def place(self, problems, mappings, fit: str | None = None,
              filling: bool | None = None) -> list[Solution]:
        """One placement pass of given mappings under ``self.placement``
        (fit/filling overridable per call; fit defaults to the config's
        policy, or 'first' under 'best').  ``mappings[b]`` is in trimmed
        task order, which is the input's task order."""
        if isinstance(problems, PackPlan):
            raise ValueError(
                "place() takes a problem sequence or a ProblemBatch "
                "(mappings align with submission order), not a PackPlan")
        cfg = self.placement
        fit = fit if fit is not None else (
            "first" if cfg.fit == "best" else cfg.fit)
        filling = cfg.filling if filling is None else filling
        lows = None
        if not isinstance(problems, ProblemBatch):
            lows = [lower_constraints(p) for p in problems]
            problems = [low.lowered for low in lows]
        if cfg.engine == "loop":
            sols = [two_phase(t, mp, fit=fit, filling=filling,
                              backend=cfg.backend, device=self.device)
                    for t, mp in zip(self._trimmed(problems), mappings)]
        else:
            batch = problems if isinstance(problems, ProblemBatch) \
                else pack_problems(self._trimmed(problems),
                                   assume_trimmed=True)
            sols = place_many(batch, mappings, fit=fit, filling=filling,
                              backend=cfg.backend,
                              placement=_ENGINE_STEPPER[cfg.engine],
                              device=self.device)
        if lows is not None:
            sols = [expand_solution(low, s) for low, s in zip(lows, sols)]
        return sols

    def _evaluate_bucket(self, batch: ProblemBatch, lp_results,
                         tels: list | None = None):
        """§VI protocol entries for one packed bucket."""
        cfg = self.placement
        if cfg.engine in _ENGINE_STEPPER:
            return _protocol_batched(batch, lp_results, self.algos,
                                     cfg.fits, cfg.backend, self.device,
                                     check=cfg.check,
                                     stepper=_ENGINE_STEPPER[cfg.engine],
                                     tels=tels)
        from .api import _protocol_entry

        return [_protocol_entry(t, res, res.lower_bound, self.algos,
                                cfg.backend, self.device)
                for t, res in zip(batch.problems, lp_results)]

    # -- the full protocol ---------------------------------------------

    def evaluate(self, problems) -> FleetResult:
        """§VI protocol over a fleet: bucketed pack -> per-bucket LP
        solve -> per-bucket lockstep placement -> entries merged back
        into submission order, as a ``FleetResult``."""
        t_start = time.perf_counter()
        if self.sweep.warm_start is not None:
            return self._evaluate_warm(problems, t_start)
        plan = problems if isinstance(problems, PackPlan) \
            else self.pack(problems)
        pack_s = time.perf_counter() - t_start

        entries: list[dict | None] = [None] * plan.n_instances
        lp_results: list[PDHGResult | None] = [None] * plan.n_instances
        stats: list[SolveStats] = []
        bucket_lp_s, bucket_place_s = [], []
        tels: list[dict] = []
        for bucket in plan.buckets:
            t0 = time.perf_counter()
            res, st = self._solve_bucket(bucket)
            bucket_lp_s.append(time.perf_counter() - t0)
            stats.extend(st)
            t0 = time.perf_counter()
            part = self._evaluate_bucket(bucket.batch, res, tels=tels)
            bucket_place_s.append(time.perf_counter() - t0)
            if self.solver.tol is not None:
                self._attach_solver(part, res)
            for i, entry, r in zip(bucket.indices, part, res):
                entries[i] = entry
                lp_results[i] = r
        timings = {
            "pack_s": pack_s,
            "lp_s": sum(bucket_lp_s),
            "place_s": sum(bucket_place_s),
            "bucket_lp_s": bucket_lp_s,
            "bucket_place_s": bucket_place_s,
            "placement": _placement_telemetry(self.placement.engine, tels),
            "total_s": time.perf_counter() - t_start,
        }
        return FleetResult(entries=entries, stats=stats, plan=plan,
                           timings=timings, lp_results=lp_results)

    def _evaluate_warm(self, problems, t_start: float) -> FleetResult:
        """The warm-started sweep path: one chained LP solve, then one
        single-shape placement pass over the whole grid."""
        trimmed = self._trimmed(problems)
        t0 = time.perf_counter()
        lp_results, stats = self._solve_warm(trimmed)
        lp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch = problems if isinstance(problems, ProblemBatch) \
            else pack_problems(trimmed, assume_trimmed=True)
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tels: list[dict] = []
        entries = self._evaluate_bucket(batch, lp_results, tels=tels)
        place_s = time.perf_counter() - t0
        self._attach_solver(entries, lp_results)
        timings = {
            "pack_s": pack_s, "lp_s": lp_s, "place_s": place_s,
            "bucket_lp_s": [lp_s], "bucket_place_s": [place_s],
            "placement": _placement_telemetry(self.placement.engine, tels),
            "total_s": time.perf_counter() - t_start,
        }
        return FleetResult(entries=entries, stats=stats, plan=None,
                           timings=timings, lp_results=lp_results)

    @staticmethod
    def _attach_solver(entries, lp_results):
        for entry, res in zip(entries, lp_results):
            entry["solver"] = {"iters": res.iters,
                               "restarts": res.restarts,
                               "kkt": res.kkt,
                               "converged": res.converged}
