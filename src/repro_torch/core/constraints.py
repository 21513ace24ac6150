"""Hard task constraints and their lowering into plain TL instances,
ported from ``repro.core.constraints`` (host numpy, the same arithmetic).

The paper fixes every task's demand vector and active window; the
related work (Task Scheduling on the Cloud with Hard Constraints,
arXiv 1507.05470; Divide (CPU Load) and Conquer, arXiv 2206.05035)
generalizes both.  ``TaskConstraints`` carries four per-task hard
constraints on top of a ``Problem``:

  * **deadline** — the task must *finish* by an inclusive slot.  A
    task whose window already ends in time is untouched; one that
    would finish late may be widened (below) or is rejected.
  * **malleable width** — ``max_width``/``serial_frac`` define an
    Amdahl-style speedup law: at width ``w`` the task runs for
    ``dur(w) = max(1, ceil(dur0 * (f + (1 - f) / w)))`` slots with
    demand ``w * dem`` (the cluster-size-vs-time trade-off of the
    bpmn-parser cost model).  Widths are resolved at lowering time:
    the *minimal* width meeting the deadline wins.
  * **affinity** — tasks sharing a named affinity group must be
    placed on the SAME node.
  * **anti-affinity** — tasks sharing a named anti-affinity group
    must not share a node while their windows overlap in time
    (non-overlapping members may reuse a node: the separation
    constraint is physical co-tenancy, not node identity).
  * **exclusive** — the task tolerates no co-tenants at all while it
    runs (a whole-node / whole-slice reservation).

Rather than teaching every engine a constraint mask, this module
**lowers** a constrained instance into an ordinary ``Problem`` that the
existing (bit-identical) LP + placement stack solves unchanged:

  1. *Width resolve* — each deadlined task picks the minimal feasible
     width; its demand and duration are rewritten.
  2. *Affinity merge* — each affinity group collapses into one
     super-task row spanning the group's hull window, whose demand is
     the per-dimension PEAK of the summed member demands over the
     hull (a conservative reservation: members land on one node by
     construction).
  3. *Virtual dimensions* — one shared unit-capacity dimension
     encodes exclusivity (exclusive rows demand 1.0, everyone else a
     δ = 1e-6 sliver, so an exclusive tenant exhausts the node for
     all others and vice versa), and one unit-capacity dimension per
     anti-affinity group (members demand 1.0, so two overlapping
     members can never co-locate).

Vacuous constraints take an identity fast path: ``lower_constraints``
returns the *original problem object*, so unconstrained behavior —
including the committed golden tables — is bit-for-bit untouched.
The independent feasibility oracle for the ORIGINAL constraint
semantics lives in ``repro_torch.core.checker`` and shares no code with
this lowering or the engines.  The lowered instance goes to the engines,
and through them to the card's kernels, unchanged: lowering widens ``D``
by the virtual dimensions and shortens ``n`` by the merges.

>>> import numpy as np
>>> from repro_torch.core import NodeTypes, Problem
>>> nt = NodeTypes(cap=np.array([[4.0]]), cost=np.array([1.0]))
>>> c = TaskConstraints.from_groups(2, affinity={"pair": (0, 1)})
>>> p = Problem(dem=np.ones((2, 1)), start=np.array([0, 1]),
...             end=np.array([1, 2]), node_types=nt, T=3, constraints=c)
>>> low = lower_constraints(p)
>>> low.lowered.n, low.row_of.tolist()      # one merged super-task
(1, [0, 0])
>>> float(low.lowered.dem[0, 0])            # peak of summed demands
2.0
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .problem import NodeTypes, Problem

__all__ = [
    "TaskConstraints", "Lowering", "lower_constraints",
    "expand_solution", "width_duration", "DELTA",
]

# Virtual-dimension demand of a NON-exclusive task on the shared
# exclusivity dimension.  Must exceed the placement feasibility slack
# (solution.EPS = 1e-7): a node drained to 0.0 by an exclusive tenant
# must reject a δ-demand, and a node nibbled by any δ must reject an
# exclusive 1.0-demand.
DELTA = 1e-6


def width_duration(dur0, width, serial_frac):
    """Amdahl-style duration law: ``max(1, ceil(dur0 * (f + (1-f)/w)))``.

    ``width=1`` always returns ``dur0`` exactly (the law is anchored at
    the unwidened duration); a tiny pre-ceil epsilon absorbs float
    fuzz so exact integer products never round up spuriously.

    >>> int(width_duration(6, 1, 0.5)), int(width_duration(6, 2, 0.5))
    (6, 5)
    >>> int(width_duration(6, 100, 0.0))   # perfectly parallel
    1
    """
    dur0 = np.asarray(dur0, dtype=np.float64)
    w = np.asarray(width, dtype=np.float64)
    f = np.asarray(serial_frac, dtype=np.float64)
    dur = np.ceil(dur0 * (f + (1.0 - f) / w) - 1e-9).astype(np.int64)
    return np.maximum(1, dur)


def _names_for(ids: np.ndarray, names, label: str) -> tuple[str, ...]:
    """Validated (auto-generated if empty) group-name tuple."""
    n_groups = int(ids.max()) + 1 if ids.size and ids.max() >= 0 else 0
    if not names:
        return tuple(f"{label}{g}" for g in range(n_groups))
    names = tuple(str(s) for s in names)
    if len(names) < n_groups:
        raise ValueError(
            f"{label} group ids reference {n_groups} groups but only "
            f"{len(names)} names were given")
    return names


@dataclasses.dataclass(frozen=True)
class TaskConstraints:
    """Per-task hard constraints, aligned with a ``Problem``'s task rows.

    deadline:      (n,) int64, inclusive latest FINISH slot; -1 = none.
    affinity:      (n,) int64 group id into ``affinity_names``; -1 = none.
    anti_affinity: (n,) int64 group id into ``anti_names``; -1 = none.
    exclusive:     (n,) bool — no co-tenants while the task runs.
    max_width:     (n,) int64 >= 1 — malleable-width ceiling (1 = rigid).
    serial_frac:   (n,) float64 in [0, 1] — Amdahl serial fraction.

    >>> TaskConstraints.vacuous(3).is_vacuous()
    True
    >>> c = TaskConstraints.from_groups(3, exclusive=(2,),
    ...                                 deadlines={0: 5})
    >>> c.is_vacuous(), int(c.deadline[0]), bool(c.exclusive[2])
    (False, 5, True)
    """

    deadline: np.ndarray
    affinity: np.ndarray
    anti_affinity: np.ndarray
    exclusive: np.ndarray
    max_width: np.ndarray
    serial_frac: np.ndarray
    affinity_names: tuple[str, ...] = ()
    anti_names: tuple[str, ...] = ()

    def __post_init__(self):
        deadline = np.asarray(self.deadline, dtype=np.int64)
        affinity = np.asarray(self.affinity, dtype=np.int64)
        anti = np.asarray(self.anti_affinity, dtype=np.int64)
        exclusive = np.asarray(self.exclusive, dtype=bool)
        max_width = np.asarray(self.max_width, dtype=np.int64)
        serial = np.asarray(self.serial_frac, dtype=np.float64)
        n = deadline.shape[0]
        for name, arr in (("affinity", affinity),
                          ("anti_affinity", anti),
                          ("exclusive", exclusive),
                          ("max_width", max_width),
                          ("serial_frac", serial)):
            if arr.shape != (n,):
                raise ValueError(
                    f"constraint arrays must share one (n,) shape; "
                    f"{name} is {arr.shape}, deadline is {(n,)}")
        if (deadline < -1).any():
            raise ValueError("deadline must be >= 0, or -1 for none")
        if (affinity < -1).any() or (anti < -1).any():
            raise ValueError("group ids must be >= 0, or -1 for none")
        if (max_width < 1).any():
            raise ValueError("max_width must be >= 1 (1 = rigid task)")
        if ((serial < 0.0) | (serial > 1.0)).any():
            raise ValueError("serial_frac must lie in [0, 1]")
        object.__setattr__(self, "deadline", deadline)
        object.__setattr__(self, "affinity", affinity)
        object.__setattr__(self, "anti_affinity", anti)
        object.__setattr__(self, "exclusive", exclusive)
        object.__setattr__(self, "max_width", max_width)
        object.__setattr__(self, "serial_frac", serial)
        object.__setattr__(
            self, "affinity_names",
            _names_for(affinity, self.affinity_names, "aff"))
        object.__setattr__(
            self, "anti_names", _names_for(anti, self.anti_names, "anti"))

    # -- constructors --------------------------------------------------

    @classmethod
    def vacuous(cls, n: int) -> "TaskConstraints":
        """Constraints that constrain nothing (the identity element)."""
        return cls(
            deadline=np.full(n, -1, dtype=np.int64),
            affinity=np.full(n, -1, dtype=np.int64),
            anti_affinity=np.full(n, -1, dtype=np.int64),
            exclusive=np.zeros(n, dtype=bool),
            max_width=np.ones(n, dtype=np.int64),
            serial_frac=np.ones(n, dtype=np.float64))

    @classmethod
    def from_groups(cls, n: int, *, deadlines=None, affinity=None,
                    anti_affinity=None, exclusive=(),
                    widths=None) -> "TaskConstraints":
        """Build from named groups and per-task dicts.

        deadlines:     {task: inclusive finish slot}
        affinity:      {group name: iterable of task indices}
        anti_affinity: {group name: iterable of task indices}
        exclusive:     iterable of task indices
        widths:        {task: (max_width, serial_frac)}
        """
        c = cls.vacuous(n)
        dl, aff, anti = c.deadline, c.affinity, c.anti_affinity
        excl, mw, sf = c.exclusive, c.max_width, c.serial_frac
        for u, slot in (deadlines or {}).items():
            dl[u] = int(slot)
        aff_names, anti_names = [], []
        for names, ids_arr, groups in ((aff_names, aff, affinity),
                                       (anti_names, anti, anti_affinity)):
            for name, members in (groups or {}).items():
                gid = len(names)
                names.append(str(name))
                for u in members:
                    if ids_arr[u] >= 0:
                        raise ValueError(
                            f"task {u} belongs to two groups "
                            f"({names[ids_arr[u]]!r} and {name!r}); a "
                            f"task carries at most one group per kind")
                    ids_arr[u] = gid
        for u in exclusive:
            excl[u] = True
        for u, (w, f) in (widths or {}).items():
            mw[u], sf[u] = int(w), float(f)
        return cls(deadline=dl, affinity=aff, anti_affinity=anti,
                   exclusive=excl, max_width=mw, serial_frac=sf,
                   affinity_names=tuple(aff_names),
                   anti_names=tuple(anti_names))

    # -- queries -------------------------------------------------------

    @property
    def n(self) -> int:
        return self.deadline.shape[0]

    def is_vacuous(self) -> bool:
        """True when lowering would be the identity: no deadlines, no
        groups, no exclusivity, every task rigid."""
        return bool(
            (self.deadline < 0).all() and (self.affinity < 0).all()
            and (self.anti_affinity < 0).all()
            and not self.exclusive.any() and (self.max_width == 1).all())

    # -- row surgery (the serving loop's arrive/depart/constrain path) --

    def take(self, index) -> "TaskConstraints":
        """Constraints of a task subset (boolean mask or index array)."""
        return TaskConstraints(
            deadline=self.deadline[index],
            affinity=self.affinity[index],
            anti_affinity=self.anti_affinity[index],
            exclusive=self.exclusive[index],
            max_width=self.max_width[index],
            serial_frac=self.serial_frac[index],
            affinity_names=self.affinity_names,
            anti_names=self.anti_names)

    def extend(self, k: int) -> "TaskConstraints":
        """Append ``k`` unconstrained task rows."""
        fresh = TaskConstraints.vacuous(k)
        return TaskConstraints(
            deadline=np.concatenate([self.deadline, fresh.deadline]),
            affinity=np.concatenate([self.affinity, fresh.affinity]),
            anti_affinity=np.concatenate(
                [self.anti_affinity, fresh.anti_affinity]),
            exclusive=np.concatenate([self.exclusive, fresh.exclusive]),
            max_width=np.concatenate([self.max_width, fresh.max_width]),
            serial_frac=np.concatenate(
                [self.serial_frac, fresh.serial_frac]),
            affinity_names=self.affinity_names,
            anti_names=self.anti_names)

    def constrain(self, index, *, affinity: str | None = None,
                  anti_affinity: str | None = None,
                  exclusive: bool | None = None,
                  deadline: int | None = None) -> "TaskConstraints":
        """A copy with the given constraints applied to tasks ``index``
        (named groups are created on first use, joined thereafter)."""
        dl, aff, anti = (self.deadline.copy(), self.affinity.copy(),
                         self.anti_affinity.copy())
        excl = self.exclusive.copy()
        aff_names, anti_names = (list(self.affinity_names),
                                 list(self.anti_names))
        if deadline is not None:
            dl[index] = int(deadline)
        if affinity is not None:
            if affinity not in aff_names:
                aff_names.append(affinity)
            aff[index] = aff_names.index(affinity)
        if anti_affinity is not None:
            if anti_affinity not in anti_names:
                anti_names.append(anti_affinity)
            anti[index] = anti_names.index(anti_affinity)
        if exclusive is not None:
            excl[index] = bool(exclusive)
        return TaskConstraints(
            deadline=dl, affinity=aff, anti_affinity=anti,
            exclusive=excl, max_width=self.max_width.copy(),
            serial_frac=self.serial_frac.copy(),
            affinity_names=tuple(aff_names),
            anti_names=tuple(anti_names))


@dataclasses.dataclass(frozen=True)
class Lowering:
    """The result of ``lower_constraints``: the lowered instance plus
    everything needed to expand its solutions back to original tasks.

    original: the constrained input ``Problem`` (original task rows).
    lowered:  the plain ``Problem`` the engines solve (merged rows,
              possibly extra virtual dimensions; ``constraints=None``).
    row_of:   (n,) lowered row index of each original task.
    widths:   (n,) resolved widths (1 for rigid tasks).
    end_eff:  (n,) resolved inclusive finish slots on the ORIGINAL
              timeline (shrunk for widened tasks).
    identity: True when the lowering was a no-op (``lowered`` shares
              every array with — or IS — ``original``).
    """

    original: Problem
    lowered: Problem
    row_of: np.ndarray
    widths: np.ndarray
    end_eff: np.ndarray
    identity: bool


def _resolve_widths(problem: Problem, c: TaskConstraints):
    """(widths, end_eff): minimal width meeting each deadline, or
    ValueError when even ``max_width`` finishes late."""
    n = problem.n
    dur0 = problem.end - problem.start + 1
    widths = np.ones(n, dtype=np.int64)
    for u in np.flatnonzero(c.deadline >= 0):
        dl, s = int(c.deadline[u]), int(problem.start[u])
        if dl >= problem.T:
            raise ValueError(
                f"task {u} deadline {dl} lies beyond the horizon "
                f"T={problem.T} (slots are 0-based)")
        if dl < s:
            raise ValueError(
                f"task {u} deadline {dl} precedes its start slot {s}")
        cap_w = int(c.max_width[u])
        for w in range(1, cap_w + 1):
            fin = s + int(width_duration(dur0[u], w, c.serial_frac[u])) - 1
            if fin <= dl:
                widths[u] = w
                break
        else:
            fin = s + int(width_duration(dur0[u], cap_w,
                                         c.serial_frac[u])) - 1
            raise ValueError(
                f"task {u} cannot meet deadline {dl}: even at "
                f"max_width={cap_w} it finishes at slot {fin}; raise "
                f"max_width, lower serial_frac, or relax the deadline")
    end_eff = problem.start + width_duration(dur0, widths,
                                             c.serial_frac) - 1
    return widths, end_eff


def _check_contradictions(problem: Problem, c: TaskConstraints,
                          end_eff: np.ndarray) -> None:
    """Affinity ∩ anti-affinity with overlapping windows is
    unsatisfiable (must co-locate AND separate at once)."""
    for g in np.unique(c.affinity[c.affinity >= 0]):
        members = np.flatnonzero(c.affinity == g)
        for a in np.unique(c.anti_affinity[members]):
            if a < 0:
                continue
            both = members[c.anti_affinity[members] == a]
            for i, u in enumerate(both):
                for v in both[i + 1:]:
                    if (problem.start[u] <= end_eff[v]
                            and problem.start[v] <= end_eff[u]):
                        raise ValueError(
                            f"tasks {u} and {v} share affinity group "
                            f"{c.affinity_names[g]!r} AND anti-affinity "
                            f"group {c.anti_names[a]!r} with overlapping "
                            f"windows — they would have to co-locate "
                            f"and separate at once")


def lower_constraints(problem: Problem) -> Lowering:
    """Lower a (possibly constrained) instance to a plain ``Problem``.

    Vacuous or absent constraints take the identity fast path (the
    returned ``lowered`` IS the input, minus a dropped vacuous
    constraints field), which keeps unconstrained pipelines bit-stable.
    Active constraints produce a new instance per the module docstring;
    a merged super-task or widened task that no longer fits any
    node-type raises ``ValueError`` here with the group/task named,
    instead of a generic infeasibility later.
    """
    c = problem.constraints
    n = problem.n
    if c is None or n == 0 or c.is_vacuous():
        lowered = problem if c is None else dataclasses.replace(
            problem, constraints=None)
        return Lowering(
            original=problem, lowered=lowered,
            row_of=np.arange(n, dtype=np.int64),
            widths=np.ones(n, dtype=np.int64),
            end_eff=problem.end.copy(), identity=True)

    widths, end_eff = _resolve_widths(problem, c)
    _check_contradictions(problem, c, end_eff)
    dem_eff = problem.dem * widths[:, None].astype(np.float64)

    # affinity merge: one row per group (leader = lowest member index),
    # singleton rows for ungrouped tasks, rows ordered by leader
    row_of = np.empty(n, dtype=np.int64)
    row_members: list[list[int]] = []
    group_row: dict[int, int] = {}
    for u in range(n):
        g = int(c.affinity[u])
        if g >= 0 and g in group_row:
            row_of[u] = group_row[g]
            row_members[group_row[g]].append(u)
            continue
        row_of[u] = len(row_members)
        if g >= 0:
            group_row[g] = len(row_members)
        row_members.append([u])

    R, D = len(row_members), problem.D
    r_start = np.empty(R, dtype=np.int64)
    r_end = np.empty(R, dtype=np.int64)
    r_dem = np.zeros((R, D))
    r_excl = np.zeros(R, dtype=bool)
    anti_ids = np.unique(c.anti_affinity[c.anti_affinity >= 0])
    anti_col = {int(a): j for j, a in enumerate(anti_ids)}
    r_anti = np.zeros((R, len(anti_ids)))
    for r, members in enumerate(row_members):
        ms = np.asarray(members)
        s = int(problem.start[ms].min())
        e = int(end_eff[ms].max())
        acc = np.zeros((e - s + 1, D))
        for u in members:
            acc[problem.start[u] - s : end_eff[u] - s + 1] += dem_eff[u]
        r_start[r], r_end[r] = s, e
        r_dem[r] = acc.max(axis=0)  # peak-over-hull reservation
        r_excl[r] = bool(c.exclusive[ms].any())
        for u in members:
            a = int(c.anti_affinity[u])
            if a >= 0:
                r_anti[r, anti_col[a]] = 1.0

    # virtual unit-capacity dimensions: [exclusivity?] + one per anti
    # group, appended AFTER the merge so reservations never double-count
    nt = problem.node_types
    cols = [r_dem]
    vdims = 0
    if c.exclusive.any():
        cols.append(np.where(r_excl, 1.0, DELTA)[:, None])
        vdims += 1
    if len(anti_ids):
        cols.append(r_anti)
        vdims += len(anti_ids)
    new_dem = np.hstack(cols)
    new_cap = np.hstack([nt.cap, np.ones((nt.m, vdims))]) if vdims \
        else nt.cap
    new_nt = NodeTypes(cap=new_cap, cost=nt.cost, names=nt.names) \
        if vdims else nt

    fits = (new_dem[:, None, :] <= new_cap[None, :, :] + 1e-12
            ).all(axis=2).any(axis=1)
    for r in np.flatnonzero(~fits):
        members = row_members[r]
        if len(members) > 1:
            g = int(c.affinity[members[0]])
            raise ValueError(
                f"affinity group {c.affinity_names[g]!r} (tasks "
                f"{members}) reserves demand {r_dem[r].tolist()} at its "
                f"peak, which fits no node-type")
        u = members[0]
        raise ValueError(
            f"task {u} at resolved width {int(widths[u])} demands "
            f"{r_dem[r].tolist()}, which fits no node-type; its "
            f"deadline cannot be met by widening")

    lowered = Problem(dem=new_dem, start=r_start, end=r_end,
                      node_types=new_nt, T=problem.T)
    return Lowering(original=problem, lowered=lowered, row_of=row_of,
                    widths=widths, end_eff=end_eff, identity=False)


def expand_solution(lowering: Lowering, solution) -> "object":
    """Map a solution of ``lowering.lowered`` back to original tasks.

    Identity lowerings return the solution object unchanged (bit-stable
    unconstrained path).  Otherwise every original task inherits its
    merged row's node, and the resolved widths / effective finish slots
    ride in ``meta`` (the checker's inputs).  Works for solutions in
    trimmed coordinates too: trimming never reorders task rows, and
    node assignments are time-coordinate-free.
    """
    if lowering.identity:
        return solution
    from .solution import Solution

    return Solution(
        node_type=solution.node_type.copy(),
        assign=solution.assign[lowering.row_of],
        meta=dict(solution.meta, constrained=True,
                  widths=lowering.widths.copy(),
                  end_eff=lowering.end_eff.copy()))
