"""Independent brute-force feasibility oracle for rightsizing plans,
ported from ``repro.core.checker`` (it imports only ``numpy`` and
``math``).

This module is the repo's second opinion.  It validates a
``Solution`` against a ``Problem`` — including every hard constraint
in ``problem.constraints`` — by brute force over the ORIGINAL,
untrimmed timeline, and it deliberately shares **no code** with the
placement engines, the LP stack, or the constraint lowering:

  * capacity is re-accumulated slot by slot from scratch (no reuse of
    ``solution.verify``'s dense tensor or the engines' remaining-
    capacity bookkeeping);
  * the width/duration speedup law is re-derived with ``math.ceil``
    (not ``repro_torch.core.constraints.width_duration``);
  * group semantics are checked directly on the original task rows
    (no affinity merge, no virtual dimensions).

An engine bug and an identical oracle bug would have to be written
twice, independently, to slip through.  ``check_plan`` returns a list
of human-readable violation strings (empty = feasible);
``assert_feasible`` raises ``FeasibilityError`` with all of them.

>>> import numpy as np
>>> from repro_torch.core import NodeTypes, Problem, Solution
>>> nt = NodeTypes(cap=np.array([[2.0]]), cost=np.array([1.0]))
>>> p = Problem(dem=np.ones((2, 1)), start=np.zeros(2, dtype=int),
...             end=np.ones(2, dtype=int), node_types=nt, T=2)
>>> sol = Solution(node_type=np.array([0]), assign=np.array([0, 0]))
>>> check_plan(p, sol)
[]
>>> tight = Problem(dem=np.full((2, 1), 1.5), start=p.start, end=p.end,
...                 node_types=nt, T=2)
>>> check_plan(tight, sol)[0]
'node 0 (type type0) over capacity at slot 0 dim 0: used 3 > cap 2'
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["FeasibilityError", "check_plan", "assert_feasible"]

# Tolerance for capacity sums only (float accumulation); structural
# checks (windows, widths, group membership) are exact integer logic.
_CAP_EPS = 1e-7


class FeasibilityError(AssertionError):
    """A plan violates capacity or constraint semantics; ``.violations``
    holds every individual violation string."""

    def __init__(self, violations: list[str]):
        self.violations = list(violations)
        head = "\n  ".join(self.violations[:20])
        more = len(self.violations) - 20
        tail = f"\n  ... and {more} more" if more > 0 else ""
        super().__init__(
            f"{len(self.violations)} feasibility violation(s):\n  "
            f"{head}{tail}")


def _task_widths(problem, solution, widths):
    """Resolved per-task widths: explicit arg > solution.meta > all-1."""
    n = problem.n
    if widths is None:
        widths = solution.meta.get("widths") if solution.meta else None
    if widths is None:
        return [1] * n
    widths = [int(w) for w in np.asarray(widths).reshape(-1)]
    if len(widths) != n:
        return None  # reported by caller
    return widths


def check_plan(problem, solution, widths=None, eps=_CAP_EPS):
    """Return every violation of ``solution`` against ``problem``.

    Checks, in order: assignment validity, width bounds, the
    width/duration law vs deadlines and the horizon, per-node capacity
    at EVERY timeslot and dimension, affinity co-location,
    anti-affinity temporal separation, and exclusive no-co-tenancy.
    ``widths`` (per-task, default from ``solution.meta['widths']``,
    else all 1) scales demand and shrinks duration per the law.
    """
    violations: list[str] = []
    n, T = problem.n, problem.T
    nt = problem.node_types
    c = problem.constraints
    node_type = np.asarray(solution.node_type)
    assign = np.asarray(solution.assign)
    num_nodes = node_type.shape[0]

    # -- assignment validity ------------------------------------------
    if assign.shape[0] != n:
        return [f"assign has {assign.shape[0]} entries for {n} tasks"]
    for u in range(n):
        if not 0 <= int(assign[u]) < num_nodes:
            violations.append(
                f"task {u} assigned to node {int(assign[u])} outside "
                f"0..{num_nodes - 1}")
    for b in range(num_nodes):
        if not 0 <= int(node_type[b]) < nt.m:
            violations.append(
                f"node {b} has type {int(node_type[b])} outside "
                f"0..{nt.m - 1}")
    if violations:
        return violations  # later checks index by node

    # -- widths and the duration law ----------------------------------
    w = _task_widths(problem, solution, widths)
    if w is None:
        return [f"widths has wrong length (expected {n})"]
    finish = [0] * n
    for u in range(n):
        dur0 = int(problem.end[u]) - int(problem.start[u]) + 1
        max_w = int(c.max_width[u]) if c is not None else 1
        f = float(c.serial_frac[u]) if c is not None else 1.0
        if not 1 <= w[u] <= max_w:
            violations.append(
                f"task {u} width {w[u]} outside 1..{max_w}")
            w[u] = 1
        # independent re-derivation of the speedup law (math.ceil,
        # not the lowering's width_duration)
        dur = max(1, math.ceil(dur0 * (f + (1.0 - f) / w[u]) - 1e-9))
        finish[u] = int(problem.start[u]) + dur - 1
        if finish[u] >= T:
            violations.append(
                f"task {u} finishes at slot {finish[u]} beyond the "
                f"horizon T={T}")
        if c is not None and int(c.deadline[u]) >= 0 \
                and finish[u] > int(c.deadline[u]):
            violations.append(
                f"task {u} misses its deadline: finishes at slot "
                f"{finish[u]} > deadline {int(c.deadline[u])}")

    # -- capacity at every timeslot, accumulated from scratch ---------
    for b in range(num_nodes):
        cap = nt.cap[int(node_type[b])]
        tasks_on_b = [u for u in range(n) if int(assign[u]) == b]
        for t in range(T):
            used = [0.0] * problem.D
            for u in tasks_on_b:
                if int(problem.start[u]) <= t <= finish[u]:
                    for d in range(problem.D):
                        used[d] += w[u] * float(problem.dem[u, d])
            for d in range(problem.D):
                if used[d] > float(cap[d]) + eps:
                    violations.append(
                        f"node {b} (type {nt.names[int(node_type[b])]})"
                        f" over capacity at slot {t} dim {d}: used "
                        f"{used[d]:g} > cap {float(cap[d]):g}")

    if c is None:
        return violations

    # -- affinity: every group on ONE node ----------------------------
    for g in sorted(set(int(x) for x in c.affinity if x >= 0)):
        members = [u for u in range(n) if int(c.affinity[u]) == g]
        nodes = sorted(set(int(assign[u]) for u in members))
        if len(nodes) > 1:
            violations.append(
                f"affinity group {c.affinity_names[g]!r} split across "
                f"nodes {nodes} (tasks {members})")

    # -- anti-affinity: no two members co-tenant while overlapping ----
    for a in sorted(set(int(x) for x in c.anti_affinity if x >= 0)):
        members = [u for u in range(n) if int(c.anti_affinity[u]) == a]
        for i, u in enumerate(members):
            for v in members[i + 1:]:
                if int(assign[u]) != int(assign[v]):
                    continue
                if int(problem.start[u]) <= finish[v] \
                        and int(problem.start[v]) <= finish[u]:
                    violations.append(
                        f"anti-affinity group {c.anti_names[a]!r}: "
                        f"tasks {u} and {v} share node "
                        f"{int(assign[u])} with overlapping windows")

    # -- exclusivity: no co-tenant overlaps an exclusive task (its own
    # affinity-group members are exempt — the group reserves the node
    # together, and the whole group is exclusive to outsiders) --------
    for u in range(n):
        if not bool(c.exclusive[u]):
            continue
        for v in range(n):
            if v == u or int(assign[v]) != int(assign[u]):
                continue
            if int(c.affinity[u]) >= 0 \
                    and int(c.affinity[u]) == int(c.affinity[v]):
                continue
            if int(problem.start[u]) <= finish[v] \
                    and int(problem.start[v]) <= finish[u]:
                violations.append(
                    f"exclusive task {u} shares node {int(assign[u])} "
                    f"with task {v} during overlapping slots")
    return violations


def assert_feasible(problem, solution, widths=None, eps=_CAP_EPS):
    """Raise ``FeasibilityError`` listing every violation, if any."""
    violations = check_plan(problem, solution, widths=widths, eps=eps)
    if violations:
        raise FeasibilityError(violations)
