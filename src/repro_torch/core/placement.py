"""Greedy placement engine (paper §III phase 2 and §V-D cross-fill).

The engine packs tasks into node replicas of a single node-type, maintaining
each open node's remaining capacity over the (trimmed) timeline.  Two
fitting policies (paper §III):

  * ``first``      — among feasible nodes, the earliest purchased.
  * ``similarity`` — among feasible nodes, the one whose capacity-normalized
                     remaining capacity is most *cosine-similar* to the
                     task's capacity-normalized demand over its span
                     (the dot-product/best-fit strategy of [25], [12]).

The per-task scoring pass is the algorithm's hot loop
(O(n * |S| * D * T) total).  ``backend='numpy'`` runs ``two_phase`` as the
reference (``repro.core.placement``) does: a host loop over tasks, the
pools float64 numpy in ``TypePool``, scoring vectorized on the host.
``backend='kernel'`` runs the whole placement on ``device`` in one launch
of the hand-written CUDA ``two_phase`` kernel (``kernels/csrc/
place_step.cu``, wrapper ``kernels.place_step.two_phase_walk``): the host
builds the static task orders once, copies them to the card, and reads
back the node counts and every task's node; the pools never leave the
card.  On the CPU the same call runs the kernel's plain version
(``kernels.ref.two_phase_ref``).  Both backends place bit-identically to
the reference.  ``TypePool``'s own ``kernel`` backend, for callers who use
it directly, scores one task per launch of the B=1 fit kernel
(``kernels.fit.fit_scores``).
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from .problem import Problem, require_lowered
from .solution import EPS, Solution
from . import penalty as penalty_mod

__all__ = ["TypePool", "two_phase", "FIT_POLICIES"]

FIT_POLICIES = ("first", "similarity")


class TypePool:
    """Open nodes of one node-type, with remaining capacity over (T, D)."""

    def __init__(self, cap_vec: np.ndarray, T: int, backend: str = "numpy",
                 device=None):
        self.cap_vec = np.asarray(cap_vec, dtype=np.float64)  # (D,)
        self.T = T
        self.D = len(self.cap_vec)
        self._rem = np.empty((4, T, self.D))
        self.count = 0
        self.global_ids: list[int] = []
        self.backend = backend
        self.device = device  # where backend='kernel' scores

    @property
    def rem(self) -> np.ndarray:
        return self._rem[: self.count]

    def open_node(self, global_id: int) -> int:
        if self.count == len(self._rem):
            grown = np.empty((2 * len(self._rem), self.T, self.D))
            grown[: self.count] = self._rem[: self.count]
            self._rem = grown
        self._rem[self.count] = self.cap_vec
        self.global_ids.append(global_id)
        self.count += 1
        return self.count - 1

    def find_fit(self, dem: np.ndarray, s: int, e: int, fit: str) -> int | None:
        """Local index of the chosen feasible node, or None."""
        if self.count == 0:
            return None
        if self.backend == "kernel":
            from ..kernels import ops as kops

            feas, score = kops.fit_scores(
                self.rem, dem, s, e, self.cap_vec,
                scored=(fit == "similarity"), device=self.device,
            )
            feas = np.asarray(feas)
            score = np.asarray(score)
        else:
            rem_slice = self.rem[:, s : e + 1, :]
            feas = (rem_slice >= dem[None, None, :] - EPS).all(axis=(1, 2))
            if fit == "similarity":
                dem_n = dem / self.cap_vec  # (D,)
                rem_n = rem_slice / self.cap_vec[None, None, :]
                dot = np.einsum("ntd,d->n", rem_n, dem_n)
                # cosine: demand vector is constant across the span
                span = e - s + 1
                dem_norm = np.linalg.norm(dem_n) * np.sqrt(span)
                rem_norm = np.sqrt(np.einsum("ntd,ntd->n", rem_n, rem_n))
                score = dot / (dem_norm * rem_norm + 1e-30)
            else:
                score = None
        if not feas.any():
            return None
        if fit == "first":
            return int(np.argmax(feas))  # lowest index == earliest purchased
        # quantize before the argmax: digits beyond the 9th are float
        # reassociation noise (einsum kernels differ by layout), and
        # rounding makes the first-max tie-break identical across the
        # numpy / kernel / batched-lockstep scoring paths
        masked = np.where(feas, np.round(score, 9), -np.inf)
        return int(np.argmax(masked))

    def place(self, local_idx: int, dem: np.ndarray, s: int, e: int) -> None:
        self._rem[local_idx, s : e + 1, :] -= dem


def _two_phase_kernel(problem: Problem, mapping: np.ndarray, fit: str,
                      filling: bool, device):
    """``two_phase``'s placement in one launch of the ``two_phase`` kernel
    (its plain version on the CPU).  Returns (node_type, assign).

    The host builds, once, what the reference's loop derives as it goes:
    the type order, each type's own tasks in start order and, with filling,
    each type's cross-fill candidates (the tasks mapped to later types) in
    stable h_avg order; the kernel skips tasks placed by then, which is the
    reference's ``~placed`` filter.  A type buys nodes only in its own
    phase, so its nodes are one block of global ids in type order."""
    from ..kernels import place_step as kstep
    from .place_batch import _phases
    from .place_step import _QUANTUM, _upload

    nt = problem.node_types
    n, m, T = problem.n, nt.m, problem.T
    if mapping.shape != (n,) or (n and (mapping.min() < 0
                                        or mapping.max() >= m)):
        raise ValueError(f"mapping must be ({n},) node-types in [0, {m})")
    mapping = mapping.astype(np.int64)
    ph = _phases(problem, mapping, fit, filling)
    parts = [part for k in range(m) for part in (ph.own[k], ph.fill[k])]
    ends = np.cumsum([0] + [len(x) for x in parts])
    bounds = np.stack([ends[0:-1:2], ends[1::2], ends[2::2]], axis=1)
    walk = np.concatenate(parts).astype(np.int32)
    host = [walk, bounds.astype(np.int32),
            np.ascontiguousarray(nt.cap[ph.type_order], np.float64),
            np.ascontiguousarray(problem.dem, np.float64),
            problem.start.astype(np.int32), problem.end.astype(np.int32),
            ph.dem_norm]
    rows = max(len(x) for x in ph.own)
    out = kstep.two_phase_walk(*_upload(host, device), T, _QUANTUM,
                               similarity=fit == "similarity",
                               sequential=filling, rows=rows)
    w, bad, _, phase, node = kstep.split_walk(out.cpu().numpy(), m, n)
    hit = np.flatnonzero(bad >= 0)
    if len(hit):
        k = int(hit[0])  # the sequential loop meets the earliest phase first
        raise RuntimeError(
            f"mapping assigned task {int(bad[k])} to node-type "
            f"{int(ph.type_order[k])} it cannot fit")
    assert (phase >= 0).all(), "two_phase must place every task"
    offsets = np.cumsum(w) - w  # each phase's first global node id
    assign = offsets[phase] + node
    node_type = np.repeat(ph.type_order, w)
    return node_type.astype(np.int64), assign.astype(np.int64)


def _sort_by_start(problem: Problem, tasks: np.ndarray) -> np.ndarray:
    order = np.lexsort((tasks, problem.start[tasks]))
    return tasks[order]


def two_phase(
    problem: Problem,
    mapping: np.ndarray,
    fit: str = "first",
    filling: bool = False,
    backend: str = "numpy",
    meta: dict | None = None,
    device=None,
) -> Solution:
    """Run the placement phase for a given task->node-type ``mapping``.

    ``filling=False`` reproduces Fig. 3's placement (each node-type packed
    independently, tasks in increasing start order, purchase on miss).

    ``filling=True`` reproduces Fig. 6: node-types processed in decreasing
    sum_d cap(B,d)/cost(B); after packing a type's own (still unplaced)
    tasks, the remaining tasks of *later* types piggy-back into this type's
    leftover holes in increasing h_avg(u|B) order (fill only — no purchase).

    ``backend='kernel'`` places in one launch of the ``two_phase`` kernel
    on ``device`` (None = the CUDA card; on the CPU its plain version).
    Instances with active constraints are rejected (``require_lowered``).
    """
    dev = resolve_device(device)
    require_lowered(problem, "two_phase")
    if fit not in FIT_POLICIES:
        raise ValueError(f"fit must be one of {FIT_POLICIES}")
    if backend == "kernel":
        node_type, assign = _two_phase_kernel(
            problem, np.asarray(mapping), fit, filling, dev)
        return Solution(node_type=node_type, assign=assign,
                        meta=dict(meta or {}, fit=fit, filling=filling))
    nt = problem.node_types
    n = problem.n

    if filling:
        type_order = np.argsort(-nt.capacity_per_cost(), kind="stable")
    else:
        type_order = np.arange(nt.m)

    assign = np.full(n, -1, dtype=np.int64)
    node_types_purchased: list[int] = []
    pools = {B: TypePool(nt.cap[B], problem.T) for B in range(nt.m)}
    h_avg = penalty_mod.relative_demand(problem, "avg") if filling else None
    placed = np.zeros(n, dtype=bool)

    def _place_task(u: int, B: int, allow_purchase: bool, fit_policy: str) -> bool:
        pool = pools[B]
        dem, s, e = problem.dem[u], problem.start[u], problem.end[u]
        local = pool.find_fit(dem, s, e, fit_policy)
        if local is None:
            if not allow_purchase:
                return False
            if (dem > pool.cap_vec + EPS).any():
                raise RuntimeError(
                    f"mapping assigned task {u} to node-type {B} it cannot fit"
                )
            gid = len(node_types_purchased)
            node_types_purchased.append(B)
            local = pool.open_node(gid)
        pool.place(local, dem, s, e)
        assign[u] = pool.global_ids[local]
        placed[u] = True
        return True

    for B in type_order:
        own = np.flatnonzero((mapping == int(B)) & ~placed)
        for u in _sort_by_start(problem, own):
            _place_task(int(u), int(B), allow_purchase=True, fit_policy=fit)
        if filling:
            remaining = np.flatnonzero(~placed)
            # increasing space they would occupy in a B-type node
            remaining = remaining[np.argsort(h_avg[remaining, B], kind="stable")]
            for u in remaining:
                # fill-only: never purchase during cross-fill; Fig. 6 places
                # piggy-backers in the earliest-purchased feasible node
                _place_task(int(u), int(B), allow_purchase=False, fit_policy="first")

    assert placed.all(), "two_phase must place every task"
    return Solution(
        node_type=np.asarray(node_types_purchased, dtype=np.int64),
        assign=assign,
        meta=dict(meta or {}, fit=fit, filling=filling),
    )
