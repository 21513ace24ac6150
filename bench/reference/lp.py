"""The mapping LP's certificate arithmetic (paper §V), in float64.

The LP relaxes the paper's integer program: x(u, B) >= 0 with
sum_B x(u, B) = 1 (zero where u fits no empty B node), and
alpha_B >= W_B(x)[t, d] = sum_{u active at t} x(u, B) dem(u, d) / cap(B, d)
for every slot and dimension, minimizing sum_B cost(B) alpha_B.

* Any feasible x gives an upper bound on the optimum:
  F(x) = sum_B cost(B) max_{t,d} W_B(x)[t, d].
* Any y >= 0 with sum_{t,d} y_B[t, d] <= cost(B) gives a lower bound:
  G(y) = sum_u min_{B feasible} (W^T y)(u, B).

A solver's reported lower bound is certified by the dual it returns when it
does not exceed G of that dual; its gap is how far F of its primal lies
above that bound.  The mapping rounds x: among the feasible types within
``MARGIN`` of a task's largest x, the cheapest (then lowest index) wins.
"""

from __future__ import annotations

import numpy as np

from ..gen import Instance
from .instance import feasible_types

MARGIN = 0.05   # the rounding's candidate band below a row's largest x


def weights(inst: Instance) -> np.ndarray:
    """(n, m, D) operator weights dem(u, d) / cap(B, d)."""
    return inst.dem[:, None, :] / inst.cap[None, :, :]


def forward(inst: Instance, x: np.ndarray) -> np.ndarray:
    """(T, m, D) congestion W(x) of the trimmed instance, by a difference
    array over the slots."""
    xw = (x[:, :, None] * weights(inst)).reshape(inst.n, -1)
    delta = np.zeros((inst.T + 1, xw.shape[1]))
    np.add.at(delta, inst.start, xw)
    np.add.at(delta, inst.end + 1, -xw)
    return np.cumsum(delta, axis=0)[: inst.T].reshape(inst.T, inst.m,
                                                        inst.D)


def adjoint(inst: Instance, y: np.ndarray) -> np.ndarray:
    """(n, m) W^T y: each task's weighted sum of y over its span."""
    c = np.concatenate([np.zeros((1, inst.m * inst.D)),
                        np.cumsum(y.reshape(inst.T, -1), axis=0)])
    span = (c[inst.end + 1] - c[inst.start]).reshape(inst.n, inst.m, inst.D)
    return (span * weights(inst)).sum(axis=2)


def primal_bound(inst: Instance, x: np.ndarray) -> float:
    """F of x made exactly feasible (clipped at 0, zero on infeasible
    pairs, rows scaled to sum 1): an upper bound on the LP optimum."""
    x = np.where(feasible_types(inst), np.clip(x, 0.0, None), 0.0)
    x = x / x.sum(axis=1, keepdims=True)
    return float((inst.cost * forward(inst, x).max(axis=(0, 2))).sum())


def dual_bound(inst: Instance, y: np.ndarray) -> tuple[float, float]:
    """(G of y made exactly feasible, its rounding slack).  y is clipped at
    0 and each type's y scaled down to its price.  The slack bounds how far
    G can move when every element of y moves by a float32 rounding
    (2**-24 relative), with a factor 4 of room."""
    y = np.clip(np.asarray(y, np.float64), 0.0, None)
    tot = y.sum(axis=(0, 2))
    y = y * np.minimum(1.0, inst.cost / np.maximum(tot, 1e-300))[None, :,
                                                                  None]
    feas = feasible_types(inst)
    wty = adjoint(inst, y)
    g = float(np.where(feas, wty, np.inf).min(axis=1).sum())
    big = np.where(feas, wty, 0.0).max(axis=1)
    return g, 4.0 * 2.0**-24 * float(big.sum()) + 1e-12


def rounding(inst: Instance, x: np.ndarray) -> np.ndarray:
    """(n,) mapping: the cheapest feasible type within MARGIN of the row's
    largest x."""
    feas = feasible_types(inst)
    masked = np.where(feas, x, -np.inf)
    top = masked.max(axis=1, keepdims=True)
    cand = feas & (masked >= top - MARGIN)
    return np.where(cand, inst.cost[None, :], np.inf).argmin(axis=1)
