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
(O(n * |S| * D * T) total); ``backend='kernel'`` routes it through the
hand-written CUDA fit kernel (``repro_torch.kernels.fit``, its B=1
launch) on ``device``, ``backend='numpy'`` uses the plain vectorized host
path.  The pool bookkeeping stays float64 numpy on the host either way,
as in the reference (``repro.core.placement``), so the numpy backend
places bit-identically to the reference.
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

    ``backend='kernel'`` scores on ``device`` (None = the CUDA card).
    Instances with active constraints are rejected (``require_lowered``).
    """
    dev = resolve_device(device)
    require_lowered(problem, "two_phase")
    if fit not in FIT_POLICIES:
        raise ValueError(f"fit must be one of {FIT_POLICIES}")
    nt = problem.node_types
    n = problem.n

    if filling:
        type_order = np.argsort(-nt.capacity_per_cost(), kind="stable")
    else:
        type_order = np.arange(nt.m)

    assign = np.full(n, -1, dtype=np.int64)
    node_types_purchased: list[int] = []
    pools = {
        B: TypePool(nt.cap[B], problem.T, backend=backend, device=dev)
        for B in range(nt.m)
    }
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
