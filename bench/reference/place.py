"""The paper's greedy placement (§III phase 2, §V-D cross-fill), one task
at a time, on plain ``Instance`` arrays.

Node types are packed one after another; each type's own tasks go in
increasing start order to the first feasible open node (``first``) or to
the feasible node whose capacity-normalized remaining capacity is most
cosine-similar to the task's normalized demand (``similarity``), and a
node is bought when none fits.  With ``filling`` the types go in
decreasing capacity per price, and after a type's own tasks the tasks of
later types fill its holes, smallest first, without buying.

``dtype`` is the arithmetic of the remaining capacities, scores and price
sum: float64 as the configurations state, float32 for the control.
"""

from __future__ import annotations

import numpy as np

from ..gen import Instance
from .instance import relative_demand

EPS = 1e-7       # capacity slack for accumulated float error
FITS = ("first", "similarity")


class _Pool:
    """Open nodes of one type: remaining capacity over (T, D)."""

    def __init__(self, cap_vec: np.ndarray, T: int, dtype):
        self.cap_vec = cap_vec
        self.rem = np.empty((4, T, len(cap_vec)), dtype)
        self.count = 0
        self.ids: list[int] = []

    def open(self, node_id: int) -> int:
        if self.count == len(self.rem):
            grown = np.empty((2 * len(self.rem),) + self.rem.shape[1:],
                             self.rem.dtype)
            grown[: self.count] = self.rem[: self.count]
            self.rem = grown
        self.rem[self.count] = self.cap_vec
        self.ids.append(node_id)
        self.count += 1
        return self.count - 1

    def find(self, dem: np.ndarray, s: int, e: int, fit: str):
        if self.count == 0:
            return None
        rem = self.rem[: self.count, s : e + 1, :]
        feas = (rem >= dem[None, None, :] - EPS).all(axis=(1, 2))
        if not feas.any():
            return None
        if fit == "first":
            return int(np.argmax(feas))
        dem_n = dem / self.cap_vec
        rem_n = rem / self.cap_vec[None, None, :]
        dot = np.einsum("ntd,d->n", rem_n, dem_n)
        dem_norm = np.linalg.norm(dem_n) * np.sqrt(e - s + 1)
        rem_norm = np.sqrt(np.einsum("ntd,ntd->n", rem_n, rem_n))
        score = dot / (dem_norm * rem_norm + 1e-30)
        # scores rounded to 9 decimals before the first-max argmax: the
        # digits past that are reassociation noise
        return int(np.argmax(np.where(feas, np.round(score, 9), -np.inf)))


def place(inst: Instance, mapping: np.ndarray, fit: str, filling: bool,
          dtype=np.float64):
    """(node types bought in purchase order, node of every task) for the
    trimmed instance ``inst`` under ``mapping``."""
    dem = inst.dem.astype(dtype)
    cap = inst.cap.astype(dtype)
    if filling:
        order = np.argsort(-(inst.cap.sum(axis=1) / inst.cost),
                           kind="stable")
    else:
        order = np.arange(inst.m)
    assign = np.full(inst.n, -1, np.int64)
    bought: list[int] = []
    pools = [_Pool(cap[B], inst.T, dtype) for B in range(inst.m)]
    h_avg = relative_demand(inst, "avg") if filling else None
    placed = np.zeros(inst.n, bool)

    def put(u: int, B: int, buy: bool, policy: str) -> None:
        pool = pools[B]
        s, e = int(inst.start[u]), int(inst.end[u])
        local = pool.find(dem[u], s, e, policy)
        if local is None:
            if not buy:
                return
            if (dem[u] > pool.cap_vec + EPS).any():
                raise ValueError(f"task {u} cannot fit node type {B}")
            local = pool.open(len(bought))
            bought.append(B)
        pool.rem[local, s : e + 1, :] -= dem[u]
        assign[u] = pool.ids[local]
        placed[u] = True

    for B in order:
        own = np.flatnonzero((mapping == int(B)) & ~placed)
        own = own[np.lexsort((own, inst.start[own]))]
        for u in own:
            put(int(u), int(B), True, fit)
        if filling:
            rest = np.flatnonzero(~placed)
            rest = rest[np.argsort(h_avg[rest, B], kind="stable")]
            for u in rest:
                put(int(u), int(B), False, "first")
    if not placed.all():
        raise ValueError("the greedy left a task unplaced")
    return np.asarray(bought, np.int64), assign


def plan_cost(inst: Instance, bought: np.ndarray, dtype=np.float64) -> float:
    """The plan's price: the sum of its nodes' prices in purchase order."""
    return float(inst.cost.astype(dtype)[bought].sum())


def overload(inst: Instance, bought: np.ndarray, assign: np.ndarray) -> float:
    """The largest load above capacity over every node, slot and
    dimension (<= EPS for a feasible plan); infinite where a task is on
    no node that was bought."""
    if assign.shape != (inst.n,) or not (
            (assign >= 0) & (assign < len(bought))).all():
        return float("inf")
    usage = np.zeros((len(bought), inst.T + 1, inst.D))
    np.add.at(usage, (assign, inst.start), inst.dem)
    np.add.at(usage, (assign, inst.end + 1), -inst.dem)
    usage = np.cumsum(usage, axis=1)[:, : inst.T]
    return float((usage - inst.cap[bought][:, None, :]).max())
