"""Admission queue: rightsizing requests in, per-tick micro-batches out.

A ``Request`` is one fleet perturbation — admit a new fleet, a batch of
task arrivals, task departures, or a demand burst (the online
arrival/departure regime of Dynamic Vector Bin Packing).  The
``AdmissionQueue`` keeps them in strict FIFO order; each service tick
drains a bounded prefix, coalesces it per fleet (so one fleet hit by
five requests re-solves ONCE with all five applied), and whatever the
tick's shape bucket cannot carry is requeued at the front with its
original submission order — deferral never reorders a fleet's stream.

Under sustained overload the queue would otherwise grow without bound,
so ``shed`` implements the SLO admission policy: when the backlog
exceeds ``ServiceConfig.max_pending``, queued ``replan`` requests — and
ONLY ``replan``s, which carry no perturbation — are dropped with a
structured ``ShedEvent``.  State-changing kinds (``admit``/``arrive``/
``depart``/``burst``/``constrain``) are never shed: dropping one would
silently fork the client's view of the fleet from the service's.

Ported from ``repro.serve.queue``: pure numpy, the same requests, order,
events and JSON.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np

__all__ = ["Request", "PendingRequest", "AdmissionQueue", "ShedEvent",
           "KINDS", "NEVER_SHED_KINDS"]

KINDS = ("admit", "arrive", "depart", "burst", "constrain", "replan")

# state-changing kinds: shedding one would desynchronize the client's
# fleet view, so the shed policy may only ever drop 'replan's
NEVER_SHED_KINDS = ("admit", "arrive", "depart", "burst", "constrain")


@dataclasses.dataclass(frozen=True)
class Request:
    """One rightsizing request against one fleet.

    kind='admit'  — create the fleet: dem (k, D), start/end (k,),
        node_types, T (the fleet's node catalogue and horizon are fixed
        at admission; task ids 0..k-1 are assigned in row order).
    kind='arrive' — append k tasks: dem (k, D), start/end (k,); the
        service assigns the next k ids in order.
    kind='depart' — remove tasks by id (``ids``).
    kind='burst'  — scale the demands of tasks ``ids`` by ``factor``
        (clamped to the fleet's largest per-dimension capacity).
    kind='constrain' — attach hard constraints to tasks ``ids``: any of
        ``affinity``/``anti_affinity`` (named groups, created on first
        use), ``exclusive`` (whole-node isolation), ``deadline`` (an
        inclusive finish slot).  Constraint semantics live in
        ``core.constraints``; ids must reference live tasks
        (unknown ids raise at apply time, like depart/burst).
    kind='replan' — no perturbation; force a re-solve.

    ``deadline_s`` is an optional per-request SLO: the seconds the
    client allows between submission and service.  Requests served past
    their deadline feed the deadline-miss telemetry, and an expired
    queued ``replan`` is the first thing the shed policy drops.

    >>> import numpy as np
    >>> Request(fleet="a", kind="arrive", dem=np.ones((2, 2)),
    ...         start=np.zeros(2), end=np.ones(2)).n_tasks
    2
    >>> Request(fleet="a", kind="burst", ids=(1, 2))
    Traceback (most recent call last):
        ...
    ValueError: burst requests need ids and factor, got factor=None
    >>> Request(fleet="a", kind="burst", ids=(1,), factor=float("inf"))
    Traceback (most recent call last):
        ...
    ValueError: factor must be positive and finite, got inf
    """

    fleet: str
    kind: str
    dem: np.ndarray | None = None
    start: np.ndarray | None = None
    end: np.ndarray | None = None
    node_types: object | None = None
    T: int | None = None
    ids: tuple[int, ...] | None = None
    factor: float | None = None
    deadline_s: float | None = None
    affinity: str | None = None
    anti_affinity: str | None = None
    exclusive: bool | None = None
    deadline: int | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"request kind must be one of {KINDS}, got {self.kind!r}")
        if self.kind in ("admit", "arrive"):
            if self.dem is None or self.start is None or self.end is None:
                raise ValueError(
                    f"{self.kind} requests need dem/start/end arrays")
            if self.kind == "admit" and (self.node_types is None
                                         or self.T is None):
                raise ValueError(
                    "admit requests need node_types and T (the fleet's "
                    "catalogue and horizon are fixed at admission)")
            # non-finite payloads would flow silently through
            # _fit_demands (inf demand scales to zero) — reject here
            for field in ("dem", "start", "end"):
                vals = np.asarray(getattr(self, field), dtype=float)
                if not np.isfinite(vals).all():
                    raise ValueError(
                        f"{self.kind} request {field} must be finite, "
                        f"got non-finite entries")
        if self.kind == "depart" and not self.ids:
            raise ValueError("depart requests need a non-empty ids tuple")
        if self.kind == "burst" and (not self.ids or self.factor is None):
            raise ValueError(
                f"burst requests need ids and factor, got "
                f"factor={self.factor!r}")
        if self.kind == "constrain":
            if not self.ids:
                raise ValueError(
                    "constrain requests need a non-empty ids tuple")
            if (self.affinity is None and self.anti_affinity is None
                    and self.exclusive is None and self.deadline is None):
                raise ValueError(
                    "constrain requests need at least one of affinity/"
                    "anti_affinity/exclusive/deadline")
        if self.deadline is not None and self.deadline < 0:
            raise ValueError(
                f"deadline must be a slot index >= 0, got {self.deadline}")
        # 'not inf > 0' is False, so a bare positivity test would let
        # factor=inf through and _fit_demands would zero the demands
        if self.factor is not None and not (
                math.isfinite(self.factor) and self.factor > 0):
            raise ValueError(
                f"factor must be positive and finite, got {self.factor!r}")
        if self.deadline_s is not None and not (
                math.isfinite(self.deadline_s) and self.deadline_s > 0):
            raise ValueError(
                f"deadline_s must be positive and finite, got "
                f"{self.deadline_s!r}")

    @property
    def n_tasks(self) -> int:
        """Tasks this request adds (0 for depart/burst/replan)."""
        return 0 if self.dem is None else int(np.asarray(self.dem).shape[0])


@dataclasses.dataclass(frozen=True)
class PendingRequest:
    """A queued request plus its admission bookkeeping: the global FIFO
    sequence number and the submission timestamp the per-request re-plan
    latency is measured from."""

    seq: int
    submitted_s: float
    request: Request

    def deadline_at(self) -> float | None:
        """Absolute deadline on the submission clock (None = no SLO)."""
        if self.request.deadline_s is None:
            return None
        return self.submitted_s + self.request.deadline_s

    def expired(self, now_s: float) -> bool:
        deadline = self.deadline_at()
        return deadline is not None and now_s > deadline


@dataclasses.dataclass(frozen=True)
class ShedEvent:
    """One structured shed-log entry: which queued request the overload
    policy dropped, and why (JSON-ready via ``to_dict``).

    reason: 'deadline' (a queued replan's SLO already expired),
        'coalesced' (the same fleet has another pending request that
        forces the re-solve anyway), or 'pressure' (backlog still above
        ``max_pending`` — stalest replans go first).
    """

    tick: int
    seq: int
    fleet: str
    kind: str
    reason: str
    waited_s: float

    def __post_init__(self):
        # the never-drop guarantee, enforced structurally: only
        # perturbation-free replans are sheddable
        if self.kind in NEVER_SHED_KINDS:
            raise ValueError(
                f"shed events may only ever name 'replan' requests, "
                f"got kind={self.kind!r} (dropping a state-changing "
                f"request would desynchronize the fleet)")

    def to_dict(self) -> dict:
        return {"tick": self.tick, "seq": self.seq, "fleet": self.fleet,
                "kind": self.kind, "reason": self.reason,
                "waited_s": round(float(self.waited_s), 6)}

    @staticmethod
    def from_dict(d: dict) -> "ShedEvent":
        return ShedEvent(tick=int(d["tick"]), seq=int(d["seq"]),
                         fleet=d["fleet"], kind=d["kind"],
                         reason=d["reason"],
                         waited_s=float(d["waited_s"]))


class AdmissionQueue:
    """Strict-FIFO request queue with front-requeue for deferrals.

    >>> q = AdmissionQueue()
    >>> for f in ("a", "b", "a"):
    ...     _ = q.push(Request(fleet=f, kind="replan"), now_s=0.0)
    >>> taken = q.take(2)
    >>> [p.request.fleet for p in taken], len(q)
    (['a', 'b'], 1)
    >>> groups = AdmissionQueue.coalesce(taken)
    >>> list(groups)
    ['a', 'b']
    >>> q.requeue(taken)          # deferred tick: back to the front
    >>> [p.request.fleet for p in q.take(3)]
    ['a', 'b', 'a']
    """

    def __init__(self):
        self._pending: deque[PendingRequest] = deque()
        self._seq = 0

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def push(self, request: Request, now_s: float) -> PendingRequest:
        item = PendingRequest(seq=self._seq, submitted_s=now_s,
                              request=request)
        self._seq += 1
        self._pending.append(item)
        return item

    def take(self, cap: int) -> list[PendingRequest]:
        """Pop the up-to-``cap`` oldest pending requests (FIFO)."""
        out = []
        while self._pending and len(out) < cap:
            out.append(self._pending.popleft())
        return out

    def requeue(self, items: list[PendingRequest]) -> None:
        """Push deferred requests back to the FRONT, preserving their
        original submission order (they stay the oldest work)."""
        for item in sorted(items, key=lambda p: p.seq, reverse=True):
            self._pending.appendleft(item)

    # -- overload shedding --------------------------------------------

    def shed(self, now_s: float, max_pending: int,
             tick: int) -> list[ShedEvent]:
        """SLO admission under queue pressure: drop sheddable queued
        requests until the backlog fits ``max_pending`` again.

        Only ``replan``s are ever dropped (they carry no perturbation —
        the fleet simply stays at its current adopted plan), in three
        escalating waves:

          1. 'deadline'  — queued replans whose SLO already expired are
             dead on arrival regardless of pressure;
          2. 'coalesced' — replans whose fleet has ANOTHER pending
             request (that request forces the re-solve anyway);
          3. 'pressure'  — stalest remaining replans, oldest first.

        Waves 2 and 3 only run while the backlog exceeds
        ``max_pending``; ``admit``/``arrive``/``depart``/``burst`` are
        never touched, so the backlog can legitimately stay above the
        bound when it is made of state-changing work.
        """
        events: list[ShedEvent] = []

        def _drop(item: PendingRequest, reason: str) -> ShedEvent:
            return ShedEvent(tick=tick, seq=item.seq,
                             fleet=item.request.fleet,
                             kind=item.request.kind, reason=reason,
                             waited_s=max(0.0, now_s - item.submitted_s))

        # wave 1: expired replans are useless whatever the pressure
        keep: deque[PendingRequest] = deque()
        for item in self._pending:
            if item.request.kind == "replan" and item.expired(now_s):
                events.append(_drop(item, "deadline"))
            else:
                keep.append(item)
        self._pending = keep
        if len(self._pending) <= max_pending:
            return events

        # wave 2: replans another same-fleet request makes redundant
        fleets_with_other = {
            item.request.fleet for item in self._pending
            if item.request.kind != "replan"}
        keep = deque()
        over = len(self._pending) - max_pending
        for item in self._pending:
            if (over > 0 and item.request.kind == "replan"
                    and item.request.fleet in fleets_with_other):
                events.append(_drop(item, "coalesced"))
                over -= 1
            else:
                keep.append(item)
        self._pending = keep
        if len(self._pending) <= max_pending:
            return events

        # wave 3: stalest remaining replans, oldest (front) first
        keep = deque()
        over = len(self._pending) - max_pending
        for item in self._pending:
            if over > 0 and item.request.kind == "replan":
                events.append(_drop(item, "pressure"))
                over -= 1
            else:
                keep.append(item)
        self._pending = keep
        return events

    # -- snapshot plumbing --------------------------------------------

    def dump(self) -> tuple[int, list[PendingRequest]]:
        """(next seq, pending items oldest-first) for checkpointing."""
        return self._seq, list(self._pending)

    def load(self, seq: int, items: list[PendingRequest]) -> None:
        """Restore a dumped queue (replaces any current contents)."""
        self._seq = int(seq)
        self._pending = deque(items)

    @staticmethod
    def coalesce(items: list[PendingRequest]) -> dict:
        """Group a drained prefix per fleet, preserving both the
        per-fleet request order and the fleets' oldest-first order."""
        groups: dict[str, list[PendingRequest]] = {}
        for item in items:
            groups.setdefault(item.request.fleet, []).append(item)
        return groups
