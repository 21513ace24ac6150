"""``RightsizingService``: a long-lived serving loop over ``FleetEngine``.

The paper solves one cold-start rightsizing instance; this module keeps
MANY live fleets rightsized under a stream of perturbations.  One tick:

  1. **Drain + coalesce** — pop a bounded FIFO prefix off the admission
     queue and fold it per fleet, so a fleet hit by several requests
     re-solves once with all of them applied.
  2. **Micro-batch** — shape-bucket the touched fleets' trimmed
     problems with the engine's own ``plan_buckets`` planner; the
     bucket holding the *oldest* pending request becomes the tick's
     batch, everything else requeues at the front (FIFO fairness, one
     padded shape, ONE ``FleetEngine`` LP dispatch per tick).
  3. **Warm re-solve** — each batched lane re-enters PDHG from its
     fleet's previous ``PDHGState``, with task rows and trimmed time
     slots re-aligned by id; lanes whose shape drifted past
     ``ServiceConfig.max_shape_drift`` (or whose fleet is new) cold
     start automatically.
  4. **Place + decide** — one lockstep placement scan proposes node
     counts; the flag-gated decision loop (``serve.scale``) adopts or
     holds them, logging a structured ``ScaleEvent``.
  5. **Account** — per-request re-plan latency, per-lane iteration
     counts split warm/cold, dispatch counts, and wall-time phases all
     land in the tick record; ``report()`` aggregates them into the
     requests/sec + p99-latency telemetry the benchmarks gate.

The loop is hardened for unattended operation:

  * **Shedding** — with ``ServiceConfig.max_pending`` set, each tick
    first sheds stale queued ``replan``s (never state-changing kinds)
    through ``AdmissionQueue.shed``, logging ``ShedEvent``s.
  * **Retry + quarantine** — a request whose application raises, or a
    lane whose solve/verify fails (for real or via ``serve.faults``
    injection), is retried up to ``max_request_retries`` times and then
    quarantined with its error (``service.quarantined``) instead of
    poisoning every subsequent tick; the rest of the tick's fleets are
    unaffected.  Requests are folded one at a time, so the poison item
    is identified exactly and already-folded prefixes still serve.
  * **Pre-provisioning** — ``preprovision(fleet)`` fans the fleet's
    demand into K scenarios (``repro_torch.stochastic``, one batched
    dispatch through the service's engine) and adopts the CVaR-selected
    headroom, growth-only.
  * **Checkpointing** — ``snapshot(path)`` / ``restore(path, engine)``
    persist every fleet's state (including the warm ``PDHGState``
    chain), the pending queue, and the telemetry counters, so a
    restarted service resumes mid-trace with warm lanes intact
    (``serve.snapshot``).

Ported from ``repro.serve.service``: the same tick, step for step, over the
port's ``FleetEngine`` on its device (None = the CUDA card; ``device="cpu"``
runs the plain PyTorch versions of the kernels).  With
``SolverConfig(operator="pallas")`` every LP forward apply of a tick is one
launch of the congestion kernel, and with
``PlacementConfig(engine="compiled")`` every placement sub-phase is one
launch of the stepper.  The warm ``PDHGState`` is host numpy, so each tick
copies its final iterates from the device once, inside ``solve_s``.  Errors
of the engine (a kernel that does not build or launch, a missing card)
propagate out of ``tick``: only request application and the verification
of a placement are routed through retry and quarantine.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.batch import pack_problems
from ..core.checker import assert_feasible
from ..core.constraints import (TaskConstraints, expand_solution,
                                lower_constraints)
from ..core.engine import (FleetEngine, SolverConfig, SweepConfig,
                           plan_buckets)
from ..core.lp_pdhg import PDHGState
from ..core.problem import Problem, trim_timeline
from ..core.solution import Solution, verify

from .config import ServiceConfig
from .faults import FaultInjector, InjectedFault
from .queue import AdmissionQueue, PendingRequest, Request, ShedEvent
from .scale import ScaleEvent, evaluate_scale

__all__ = ["RightsizingService", "TickRecord", "FleetView",
           "QuarantineRecord"]


@dataclasses.dataclass
class _LaneState:
    """One fleet's stored solver state, cropped to its own trimmed
    shape, plus the alignment keys (task ids, kept slot ids) the next
    warm start re-maps it with."""

    x: np.ndarray            # (n_f, m) float32, trimmed task rows
    y: np.ndarray            # (T'_f, m, D) float32, trimmed slots
    eta: float | None
    omega: float | None      # adapted primal weight (None in old states)
    ids: np.ndarray          # (n_f,) task ids, ascending
    kept: np.ndarray         # (T'_f,) original slot ids, ascending


@dataclasses.dataclass
class _FleetState:
    problem: Problem          # current task set, original timeline
    ids: np.ndarray           # (n,) task ids, ascending
    next_id: int
    warm: _LaneState | None = None
    plan: np.ndarray | None = None       # adopted node counts (m,)
    plan_cost: float = 0.0
    last_scale_in_tick: int = -(10**9)
    solution: Solution | None = None


@dataclasses.dataclass(frozen=True)
class FleetView:
    """Read-only snapshot of one fleet (what ``fleet()`` returns)."""

    name: str
    n_tasks: int
    plan: np.ndarray
    plan_cost: float
    solution: Solution | None


@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    """One quarantined request: what failed, with which error, after
    how many attempts (JSON-ready via ``to_dict``)."""

    seq: int
    fleet: str
    kind: str
    tick: int
    attempts: int
    error: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "QuarantineRecord":
        return QuarantineRecord(
            seq=int(d["seq"]), fleet=d["fleet"], kind=d["kind"],
            tick=int(d["tick"]), attempts=int(d["attempts"]),
            error=d["error"])


@dataclasses.dataclass
class TickRecord:
    """Telemetry of one tick: who re-solved, how warm, how fast."""

    tick: int
    fleets: tuple[str, ...]
    requests: int
    deferred: int
    dispatches: int
    warm_lanes: int
    cold_lanes: int
    drift_fallbacks: int
    iters: tuple[int, ...]
    converged: int
    solve_s: float
    place_s: float
    total_s: float
    shed: int = 0
    retried: int = 0
    quarantined: int = 0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fleets"] = list(self.fleets)
        d["iters"] = list(self.iters)
        return d

    @staticmethod
    def from_dict(d: dict) -> "TickRecord":
        return TickRecord(
            tick=int(d["tick"]), fleets=tuple(d["fleets"]),
            requests=int(d["requests"]), deferred=int(d["deferred"]),
            dispatches=int(d["dispatches"]),
            warm_lanes=int(d["warm_lanes"]),
            cold_lanes=int(d["cold_lanes"]),
            drift_fallbacks=int(d["drift_fallbacks"]),
            iters=tuple(int(i) for i in d["iters"]),
            converged=int(d["converged"]), solve_s=float(d["solve_s"]),
            place_s=float(d["place_s"]), total_s=float(d["total_s"]),
            shed=int(d.get("shed", 0)), retried=int(d.get("retried", 0)),
            quarantined=int(d.get("quarantined", 0)))


class RightsizingService:
    """A long-lived rightsizing loop: ``submit`` requests, ``tick``
    until drained (or forever), read ``report()`` / ``events``.

    The service derives its per-tick engine from the one it is given
    with ``FleetEngine.with_overrides``: the sweep config is replaced
    outright because the admission queue owns micro-batching (bucketing
    per tick) and the per-fleet state chain owns warm starts — the
    engine-level ``SweepConfig(warm_start=..., max_buckets=...)`` knobs
    describe offline sweeps, not a serving loop.  The solver must be
    tolerance-stopped: warm starts only pay off when lanes may exit
    early.  ``device`` places the default engine (None = the CUDA card,
    which raises without one; ``"cpu"`` runs on the CPU); a given engine
    brings its own device.
    """

    def __init__(self, engine: FleetEngine | None = None,
                 config: ServiceConfig | None = None,
                 faults: FaultInjector | None = None, device=None):
        if engine is not None and device is not None:
            raise ValueError(
                "RightsizingService(device=...) places the default engine; "
                "a given engine brings its own device")
        self.config = config if config is not None else ServiceConfig()
        base = engine if engine is not None else FleetEngine(
            solver=SolverConfig(tol=5e-3, iters=4000),
            algos=("lp-map-f",), device=device)
        if base.solver.tol is None:
            raise ValueError(
                "RightsizingService needs a tolerance-stopped solver "
                "(warm-started re-solves only pay off when lanes can "
                "exit early); derive one with "
                "engine.with_overrides(tol=5e-3)")
        # the queue owns micro-batching; neutralize sweep-level knobs
        self.engine = base.with_overrides(sweep=SweepConfig())
        self.faults = faults
        self.queue = AdmissionQueue()
        self.events: list[ScaleEvent] = []
        self.shed_events: list[ShedEvent] = []
        self.quarantined: list[QuarantineRecord] = []
        self.ticks: list[TickRecord] = []
        self._fleets: dict[str, _FleetState] = {}
        self._tick = 0
        self._latencies: list[float] = []
        self._iters: dict[str, list[int]] = {
            "warm": [], "cold": [], "drift": [], "admit": []}
        self._converged: list[bool] = []
        self._proposed_cost = 0.0  # pre-decision placement cost total
        self._attempts: dict[int, int] = {}  # seq -> failed attempts
        self._retries = 0
        self._deadline_misses = 0

    # -- admission -----------------------------------------------------

    def submit(self, request: Request) -> PendingRequest:
        return self.queue.push(request, now_s=time.perf_counter())

    @property
    def fleets(self) -> tuple[str, ...]:
        return tuple(self._fleets)

    def fleet(self, name: str) -> FleetView:
        st = self._fleets[name]
        return FleetView(name=name, n_tasks=st.problem.n,
                         plan=st.plan.copy(), plan_cost=st.plan_cost,
                         solution=st.solution)

    # -- request application (pure w.r.t. stored fleet state) ----------

    @staticmethod
    def _fit_demands(dem: np.ndarray, cap: np.ndarray) -> np.ndarray:
        """Admission control: any task fitting NO node type is scaled
        down onto its best-fitting type (smallest max demand/capacity
        ratio), so perturbed fleets always stay feasible."""
        dem = np.asarray(dem, dtype=float)
        ratios = np.max(dem[:, None, :] / np.maximum(cap[None, :, :],
                                                     1e-12), axis=2)
        r = ratios.min(axis=1)
        over = r > 1.0
        if over.any():
            dem = dem.copy()
            dem[over] /= r[over, None] * (1.0 + 1e-9)
        return dem

    @staticmethod
    def _known_ids(req: Request, ids: np.ndarray) -> np.ndarray:
        """The request's target ids as int64, or ValueError naming the
        unknown ones — an ``np.isin`` that silently matches nothing
        would turn a client typo into a silent no-op."""
        target = np.asarray(req.ids, dtype=np.int64)
        unknown = target[~np.isin(target, ids)]
        if unknown.size:
            raise ValueError(
                f"{req.kind} for fleet {req.fleet!r} references "
                f"unknown task ids {sorted(unknown.tolist())} "
                f"(live ids run 0..{int(ids.max())} minus departures)")
        return target

    def _apply_one(self, problem: Problem | None, ids, next_id: int,
                   req: Request):
        """Fold ONE request into (problem, ids, next_id); raises on an
        invalid request and never mutates its inputs."""
        if req.kind == "admit":
            if problem is not None:
                raise ValueError(
                    f"fleet {req.fleet!r} is already admitted")
            dem = self._fit_demands(req.dem, req.node_types.cap)
            problem = Problem(
                dem=dem,
                start=np.asarray(req.start, dtype=np.int64),
                end=np.asarray(req.end, dtype=np.int64),
                node_types=req.node_types, T=int(req.T))
            return problem, np.arange(dem.shape[0], dtype=np.int64), \
                dem.shape[0]
        if problem is None:
            raise ValueError(
                f"fleet {req.fleet!r} got a {req.kind!r} request "
                f"before being admitted")
        cap = problem.node_types.cap
        constraints = problem.constraints
        if req.kind == "arrive":
            dem = self._fit_demands(req.dem, cap)
            k = dem.shape[0]
            problem = Problem(
                dem=np.concatenate([problem.dem, dem]),
                start=np.concatenate([
                    problem.start,
                    np.asarray(req.start, dtype=np.int64)]),
                end=np.concatenate([
                    problem.end,
                    np.asarray(req.end, dtype=np.int64)]),
                node_types=problem.node_types, T=problem.T,
                constraints=(None if constraints is None
                             else constraints.extend(k)))
            ids = np.concatenate([
                ids, np.arange(next_id, next_id + k, dtype=np.int64)])
            next_id += k
        elif req.kind == "depart":
            keep = ~np.isin(ids, self._known_ids(req, ids))
            if not keep.any():
                raise ValueError(
                    f"depart would empty fleet {req.fleet!r}")
            problem = Problem(
                dem=problem.dem[keep], start=problem.start[keep],
                end=problem.end[keep],
                node_types=problem.node_types, T=problem.T,
                constraints=(None if constraints is None
                             else constraints.take(keep)))
            ids = ids[keep]
        elif req.kind == "burst":
            hit = np.isin(ids, self._known_ids(req, ids))
            dem = problem.dem.copy()
            dem[hit] = self._fit_demands(dem[hit] * req.factor, cap)
            problem = Problem(
                dem=dem, start=problem.start, end=problem.end,
                node_types=problem.node_types, T=problem.T,
                constraints=constraints)
        elif req.kind == "constrain":
            hit = np.isin(ids, self._known_ids(req, ids))
            c = (TaskConstraints.vacuous(problem.n)
                 if constraints is None else constraints)
            c = c.constrain(np.flatnonzero(hit), affinity=req.affinity,
                            anti_affinity=req.anti_affinity,
                            exclusive=req.exclusive,
                            deadline=req.deadline)
            problem = Problem(
                dem=problem.dem, start=problem.start, end=problem.end,
                node_types=problem.node_types, T=problem.T,
                constraints=c)
            # validate eagerly: an unmeetable deadline, a contradictory
            # group, or an unplaceable merged row fails HERE (poison
            # isolation path) instead of poisoning the whole tick solve
            lower_constraints(problem)
        # 'replan' applies no perturbation
        return problem, ids, next_id

    def _apply(self, st: _FleetState | None, items: list[PendingRequest]):
        """Fold a fleet's coalesced requests one at a time into
        (problem, ids, next_id) without mutating the stored state.

        Returns ``(problem, ids, next_id, applied, poison, rest)``:
        ``applied`` is the folded prefix, and when an item raises (a
        real validation error or an injected 'apply-raise' fault) it
        becomes ``poison = (item, error)`` with the unapplied tail in
        ``rest`` — the caller serves the prefix and routes the poison
        through retry/quarantine, so one bad request never blocks the
        stream behind it."""
        if st is None:
            problem, ids, next_id = None, None, 0
        else:
            problem, ids, next_id = st.problem, st.ids, st.next_id
        applied: list[PendingRequest] = []
        for pos, item in enumerate(items):
            req = item.request
            try:
                if self.faults is not None and self.faults.fire(
                        "apply-raise", fleet=req.fleet, tick=self._tick):
                    raise InjectedFault(
                        f"injected failure applying {req.kind!r} to "
                        f"fleet {req.fleet!r}")
                problem, ids, next_id = self._apply_one(
                    problem, ids, next_id, req)
            except Exception as error:
                return (problem, ids, next_id, applied, (item, error),
                        items[pos + 1:])
            applied.append(item)
        return problem, ids, next_id, applied, None, []

    def _note_failure(self, items: list[PendingRequest],
                      error: Exception):
        """Retry/quarantine bookkeeping for failed requests: each item
        is retried (requeued by the caller) until it has failed
        ``max_request_retries + 1`` times, then quarantined with its
        error.  Returns ``(retry_items, n_quarantined)``."""
        retry: list[PendingRequest] = []
        n_quarantined = 0
        for item in items:
            fails = self._attempts.get(item.seq, 0) + 1
            if fails > self.config.max_request_retries:
                self._attempts.pop(item.seq, None)
                self.quarantined.append(QuarantineRecord(
                    seq=item.seq, fleet=item.request.fleet,
                    kind=item.request.kind, tick=self._tick,
                    attempts=fails,
                    error=f"{type(error).__name__}: {error}"))
                n_quarantined += 1
            else:
                self._attempts[item.seq] = fails
                self._retries += 1
                retry.append(item)
        return retry, n_quarantined

    # -- warm-start assembly -------------------------------------------

    def _lane_init(self, st: _FleetState | None, ids, trimmed, kept,
                   x0, y0, lane: int):
        """Fill one lane of the batch init from the fleet's stored
        state, task rows and kept slots re-aligned by id.  Returns the
        lane mode, step size, and primal weight: ('warm', eta, omega),
        or (mode, None, None) with mode 'admit' (fresh fleet), 'cold'
        (warm starts off), or 'drift' (shape drifted past the fallback
        bound)."""
        if st is None:
            return "admit", None, None
        if not self.config.warm_start or st.warm is None:
            return "cold", None, None
        ws = st.warm
        if ws.x.shape[1] != trimmed.m or ws.y.shape[2] != trimmed.D:
            return "drift", None, None
        row_pos = np.searchsorted(ws.ids, ids)
        row_pos = np.clip(row_pos, 0, len(ws.ids) - 1)
        row_ok = ws.ids[row_pos] == ids
        slot_pos = np.searchsorted(ws.kept, kept)
        slot_pos = np.clip(slot_pos, 0, len(ws.kept) - 1)
        slot_ok = ws.kept[slot_pos] == kept
        overlap = min(row_ok.mean(), slot_ok.mean())
        if overlap < 1.0 - self.config.max_shape_drift:
            return "drift", None, None
        m, d = trimmed.m, trimmed.D
        x0[lane, np.flatnonzero(row_ok), :m] = ws.x[row_pos[row_ok]]
        y0[lane, np.flatnonzero(slot_ok), :m, :d] = ws.y[slot_pos[slot_ok]]
        return "warm", ws.eta, ws.omega

    # -- one tick ------------------------------------------------------

    @staticmethod
    def _aggregate_stats(stats):
        """Per-lane telemetry across ALL of the solve's stats entries.

        A sharded dispatch partitions the batch's lanes across several
        ``SolveStats`` in order, so reading ``stats[0]`` for iteration
        counts but ``stats[-1]`` for the warm state silently mixes
        lanes.  Returns ``(iters (B,), converged (B,), lane_state)``
        where ``lane_state[b]`` is ``(state, local_index)`` for lane
        ``b`` (or None), or ``None`` when there are no stats at all.
        """
        if not stats:
            return None
        iters = np.concatenate(
            [np.asarray(s.iterations).reshape(-1) for s in stats])
        conv = np.concatenate(
            [np.asarray(s.converged).reshape(-1) for s in stats])
        lane_state = []
        for s in stats:
            b = int(np.asarray(s.iterations).reshape(-1).shape[0])
            for j in range(b):
                lane_state.append(
                    None if s.state is None else (s.state, j))
        return iters, conv, lane_state

    def tick(self) -> TickRecord | None:
        """Process one micro-batch; returns its ``TickRecord``, or
        None when the queue is empty.

        A tick whose every drained request fails application still
        returns a (solve-free) record — returning None there would
        stall ``drain`` with poison retries left in the queue.
        """
        t_tick = time.perf_counter()
        n_shed = 0
        if self.config.max_pending is not None:
            shed = self.queue.shed(
                now_s=time.perf_counter(),
                max_pending=self.config.max_pending, tick=self._tick)
            self.shed_events.extend(shed)
            n_shed = len(shed)
        taken = self.queue.take(self.config.max_requests_per_tick)
        if not taken:
            return None
        groups = AdmissionQueue.coalesce(taken)

        proposals = {}
        served_items: dict[str, list[PendingRequest]] = {}
        n_retried = n_quarantined = 0
        for name in list(groups):
            st = self._fleets.get(name)
            problem, ids, next_id, applied, poison, rest = self._apply(
                st, groups[name])
            if poison is not None:
                item, error = poison
                retry, nq = self._note_failure([item], error)
                n_retried += len(retry)
                n_quarantined += nq
                self.queue.requeue(retry + rest)
            if problem is None or (not applied and st is not None):
                # nothing new to solve: the fleet's only requests this
                # tick failed (or a fresh fleet's admit did)
                continue
            low = lower_constraints(problem)
            trimmed, kept = trim_timeline(low.lowered)
            proposals[name] = (problem, ids, next_id, trimmed, kept, low)
            served_items[name] = applied
        names = list(proposals)
        if not names:
            record = TickRecord(
                tick=self._tick, fleets=(), requests=0, deferred=0,
                dispatches=0, warm_lanes=0, cold_lanes=0,
                drift_fallbacks=0, iters=(), converged=0, solve_s=0.0,
                place_s=0.0, total_s=time.perf_counter() - t_tick,
                shed=n_shed, retried=n_retried,
                quarantined=n_quarantined)
            self.ticks.append(record)
            self._tick += 1
            return record

        # shape-bucket the touched fleets; serve the oldest request's
        # bucket this tick, defer the rest with their order intact
        # (deferral requeues only the successfully-applied items — a
        # poisoned item was already routed through retry/quarantine)
        parts = plan_buckets([proposals[n][3] for n in names],
                             max_buckets=self.config.max_buckets,
                             overhead=self.config.bucket_overhead)
        chosen_idx = next(p for p in parts if 0 in p)
        chosen = [names[i] for i in chosen_idx]
        deferred = [item for i, n in enumerate(names) if i not in chosen_idx
                    for item in served_items[n]]
        self.queue.requeue(deferred)

        # pad task/slot dims up to the shape quantum so consecutive
        # ticks reuse one compiled solve (padding is exact)
        chosen_trimmed = [proposals[n][3] for n in chosen]
        q = self.config.shape_quantum
        pad_to = (-(-max(t.n for t in chosen_trimmed) // q) * q,
                  max(t.m for t in chosen_trimmed),
                  max(t.D for t in chosen_trimmed),
                  -(-max(t.T for t in chosen_trimmed) // q) * q)
        batch = pack_problems(chosen_trimmed, pad_to=pad_to,
                              assume_trimmed=True)
        x0 = np.zeros((batch.B, batch.n, batch.m), np.float32)
        y0 = np.zeros((batch.B, batch.Tp, batch.m, batch.D), np.float32)
        modes, etas, omegas = [], [], []
        for lane, name in enumerate(chosen):
            _, ids, _, trimmed, kept, low = proposals[name]
            st_l = self._fleets.get(name)
            if not low.identity:
                # constrained lanes always cold-start: the lowered rows
                # (merged groups, virtual dims) no longer align with the
                # per-task-id warm state
                mode, eta, om = (("admit" if st_l is None else "cold"),
                                 None, None)
            else:
                mode, eta, om = self._lane_init(st_l, ids, trimmed,
                                                kept, x0, y0, lane)
            modes.append(mode)
            etas.append(eta)
            omegas.append(om)
        init = None
        if any(m == "warm" for m in modes):
            eta_arr = None
            if all(e is not None for e in etas):
                eta_arr = np.asarray(etas, np.float32)
            omega_arr = None
            if all(o is not None for o in omegas):
                omega_arr = np.asarray(omegas, np.float32)
            init = PDHGState(x=x0, y=y0, eta=eta_arr, omega=omega_arr)

        t0 = time.perf_counter()
        lp_results, stats = self.engine.solve(batch, init=init)
        solve_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        maps = [r.mapping for r in lp_results]
        best: list[Solution | None] = [None] * batch.B
        best_cost = [float("inf")] * batch.B
        for fit in self.engine.placement.fits:
            sols = self.engine.place(batch, maps, fit=fit,
                                     filling=self.config.filling)
            for lane, (t, s) in enumerate(zip(batch.problems, sols)):
                c = s.cost(t)
                if c < best_cost[lane]:
                    best_cost[lane], best[lane] = c, s
        place_s = time.perf_counter() - t0

        agg = self._aggregate_stats(stats)
        lane_iters_all, lane_conv, lane_state = (
            agg if agg is not None else (None, None, None))
        now = time.perf_counter()
        served: list[PendingRequest] = []
        committed = [False] * len(chosen)
        for lane, name in enumerate(chosen):
            problem, ids, next_id, trimmed, kept, low = proposals[name]
            st = self._fleets.get(name)
            sol = best[lane]
            failure: Exception | None = None
            if self.faults is not None and self.faults.fire(
                    "nonconverge", fleet=name, tick=self._tick):
                failure = InjectedFault(
                    f"injected solver non-convergence for fleet "
                    f"{name!r}")
            elif self.faults is not None and self.faults.fire(
                    "verify-fail", fleet=name, tick=self._tick):
                failure = InjectedFault(
                    f"injected placement verify failure for fleet "
                    f"{name!r}")
            elif self.engine.placement.check:
                try:
                    verify(trimmed, sol)
                    if not low.identity:
                        # independent second opinion: the expanded plan
                        # against the ORIGINAL constraint semantics
                        assert_feasible(problem,
                                        expand_solution(low, sol))
                except AssertionError as e:
                    failure = e
            if failure is not None:
                # do NOT commit; drop the stored warm state so the
                # retry cold-starts with a fresh step size, and route
                # the lane's requests through retry/quarantine
                if st is not None:
                    st.warm = None
                retry, nq = self._note_failure(served_items[name],
                                               failure)
                n_retried += len(retry)
                n_quarantined += nq
                self.queue.requeue(retry)
                continue
            committed[lane] = True
            required = sol.nodes_per_type(trimmed)
            self._proposed_cost += float(
                required @ trimmed.node_types.cost)
            decision = evaluate_scale(
                None if st is None else st.plan, required,
                trimmed.node_types.cost, tick=self._tick,
                last_scale_in_tick=(-(10**9) if st is None
                                    else st.last_scale_in_tick),
                cfg=self.config)
            cost_before = 0.0 if st is None else st.plan_cost
            if st is None:
                st = _FleetState(problem=problem, ids=ids,
                                 next_id=next_id)
                self._fleets[name] = st
            else:
                st.problem, st.ids, st.next_id = problem, ids, next_id
            if decision.scaled_in:
                st.last_scale_in_tick = self._tick
            st.plan, st.plan_cost = decision.adopted, decision.cost
            st.solution = expand_solution(low, sol)
            if not low.identity:
                # lowered-row state would misalign with task ids on a
                # later (possibly unconstrained) tick — never store it
                st.warm = None
            elif lane_state is not None and lane_state[lane] is not None:
                state, local = lane_state[lane]
                st.warm = _LaneState(
                    x=np.array(state.x[local, :trimmed.n, :trimmed.m]),
                    y=np.array(state.y[local, :trimmed.T, :trimmed.m,
                                       :trimmed.D]),
                    eta=(None if state.eta is None
                         else float(state.eta[local])),
                    omega=(None if state.omega is None
                           else float(state.omega[local])),
                    ids=ids.copy(), kept=kept.copy())
            if decision.scope != "hold" or decision.checks:
                self.events.append(ScaleEvent(
                    tick=self._tick, fleet=name, scope=decision.scope,
                    cost_before=cost_before, cost_after=decision.cost,
                    checks=decision.checks))
            served.extend(served_items[name])

        for item in served:
            self._latencies.append(now - item.submitted_s)
            self._attempts.pop(item.seq, None)
            if item.expired(now):
                self._deadline_misses += 1
        iters = []
        for lane, mode in enumerate(modes):
            lane_iters = (int(lane_iters_all[lane])
                          if lane_iters_all is not None else 0)
            iters.append(lane_iters)
            if committed[lane]:
                self._iters[mode].append(lane_iters)
        if lane_conv is not None:
            self._converged.extend(
                bool(lane_conv[lane]) for lane in range(len(chosen))
                if committed[lane])

        record = TickRecord(
            tick=self._tick, fleets=tuple(
                n for lane, n in enumerate(chosen) if committed[lane]),
            requests=len(served),
            deferred=len(deferred), dispatches=len(stats),
            warm_lanes=sum(m == "warm" for lane, m in enumerate(modes)
                           if committed[lane]),
            cold_lanes=sum(m != "warm" for lane, m in enumerate(modes)
                           if committed[lane]),
            drift_fallbacks=sum(
                m == "drift" for lane, m in enumerate(modes)
                if committed[lane]),
            iters=tuple(iters),
            converged=(int(lane_conv.sum()) if lane_conv is not None
                       else 0),
            solve_s=solve_s, place_s=place_s,
            total_s=time.perf_counter() - t_tick,
            shed=n_shed, retried=n_retried,
            quarantined=n_quarantined)
        self.ticks.append(record)
        self._tick += 1
        return record

    def drain(self, max_ticks: int = 10**6) -> int:
        """Tick until the queue is empty; returns ticks executed."""
        n = 0
        while self.queue.pending and n < max_ticks:
            if self.tick() is None:
                break
            n += 1
        return n

    # -- stochastic pre-provisioning -----------------------------------

    def preprovision(self, fleet: str, forecast=None, config=None):
        """Buy burst headroom ahead of demand: fan the fleet's current
        task set (or a caller-supplied ``DemandForecast``) into K
        scenarios, CVaR-select a robust fleet (``repro_torch.stochastic``,
        one batched dispatch), and adopt ``max(current plan, robust)``.

        Growth-only by design — releases stay owned by the flag-gated
        scale-in loop, so pre-provisioning can never fight the cooldown
        or payback checks.  The adoption is logged as a
        ``scope='preprovision'`` ScaleEvent; the full
        ``StochasticResult`` (frontier, per-scenario overloads) is
        returned for telemetry.  The fleet's *current plan* anchors the
        Eva-style reconfiguration term, so a ``config`` with
        ``recfg_weight > 0`` biases selection toward fleets near what
        is already deployed."""
        from ..stochastic import (DemandForecast, StochasticConfig,
                                  plan_stochastic)

        st = self._fleets[fleet]
        if forecast is None:
            forecast = DemandForecast(base=st.problem)
        if config is None:
            config = StochasticConfig(scenarios=16)
        current = (st.plan if st.plan is not None
                   else np.zeros(st.problem.m, dtype=np.int64))
        res = plan_stochastic(forecast, config, engine=self.engine,
                              current_fleet=current)
        adopted = np.maximum(current, res.fleet)
        cost_before = st.plan_cost
        st.plan = adopted
        st.plan_cost = float(adopted @ st.problem.node_types.cost)
        self.events.append(ScaleEvent(
            tick=self._tick, fleet=fleet, scope="preprovision",
            cost_before=cost_before, cost_after=st.plan_cost,
            checks=()))
        return res

    # -- checkpoint / recovery -----------------------------------------

    def snapshot(self, path: str) -> dict:
        """Write a versioned checkpoint (JSON manifest + npz arrays) of
        every fleet's state — problem, task ids, adopted plan, the
        cropped warm ``PDHGState`` with its alignment keys — plus the
        pending queue and telemetry counters.  Returns the manifest.
        See ``serve.snapshot`` for the format."""
        from .snapshot import save_snapshot
        return save_snapshot(self, path)

    @classmethod
    def restore(cls, path: str, engine: FleetEngine | None = None,
                config: ServiceConfig | None = None,
                faults: FaultInjector | None = None, device=None
                ) -> "RightsizingService":
        """Rebuild a service from ``snapshot(path)`` and resume: warm
        lanes, adopted plans, queue contents, and report() counters all
        carry over.  ``engine`` defaults to the service default on
        ``device`` (the snapshot does not capture engine internals);
        ``config`` overrides the snapshotted ``ServiceConfig``."""
        from .snapshot import restore_service
        return restore_service(path, engine=engine, config=config,
                               faults=faults, device=device)

    # -- telemetry -----------------------------------------------------

    def report(self) -> dict:
        """Aggregate serving telemetry (JSON-ready): sustained
        requests/sec, re-plan latency percentiles, warm-vs-cold
        iteration medians, decision-loop event counts, and the
        deterministic total adopted plan cost."""
        lat = np.asarray(self._latencies, dtype=float)
        wall = sum(t.total_s for t in self.ticks)
        scopes: dict[str, int] = {}
        for e in self.events:
            scopes[e.scope] = scopes.get(e.scope, 0) + 1
        shed_reasons: dict[str, int] = {}
        for s in self.shed_events:
            shed_reasons[s.reason] = shed_reasons.get(s.reason, 0) + 1
        resolve_cold = self._iters["cold"] + self._iters["drift"]

        def _median(vals):
            return float(np.median(vals)) if vals else None

        return {
            "ticks": len(self.ticks),
            "fleets": len(self._fleets),
            "requests": int(lat.size),
            "wall_s": round(wall, 4),
            "requests_per_s": (round(float(lat.size) / wall, 3)
                               if wall > 0 else 0.0),
            "p50_replan_s": (round(float(np.percentile(lat, 50)), 4)
                             if lat.size else 0.0),
            "p99_replan_s": (round(float(np.percentile(lat, 99)), 4)
                             if lat.size else 0.0),
            "dispatches_per_tick": (max(t.dispatches for t in self.ticks)
                                    if self.ticks else 0),
            "warm_lanes": len(self._iters["warm"]),
            "cold_lanes": (len(resolve_cold) + len(self._iters["admit"])),
            "drift_fallbacks": sum(t.drift_fallbacks for t in self.ticks),
            "median_iters_warm": _median(self._iters["warm"]),
            "median_iters_cold": _median(resolve_cold),
            "median_iters_admit": _median(self._iters["admit"]),
            "converged_frac": (round(float(np.mean(self._converged)), 4)
                               if self._converged else 1.0),
            "events": scopes,
            "shed": len(self.shed_events),
            "shed_reasons": shed_reasons,
            "retries": self._retries,
            "quarantined": len(self.quarantined),
            "deadline_misses": self._deadline_misses,
            "total_cost": round(sum(st.plan_cost
                                    for st in self._fleets.values()), 6),
            "proposed_cost_total": round(self._proposed_cost, 6),
        }
