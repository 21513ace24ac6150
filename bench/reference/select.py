"""CVaR fleet selection over per-scenario fleets (the stochastic planner's
selection stage), float64.

Candidates are the scenario fleets, their pairwise elementwise maxima, the
per-type quantile chain and (when given) the current fleet.  Each is
priced as purchase + premium * mean overload + lambda * CVaR_alpha of the
overload, where a scenario's overload is the price of the nodes it needs
beyond the candidate; ties go to the lower worst overload, then the lower
purchase, then the lexicographically smaller fleet.
"""

from __future__ import annotations

import math

import numpy as np


def cvar(x: np.ndarray, alpha: float) -> float:
    """Mean of the worst ceil((1 - alpha) K) of K equal-weight values."""
    k = max(1, math.ceil((1.0 - alpha) * len(x)))
    return float(np.mean(np.sort(np.asarray(x, np.float64))[len(x) - k:]))


def candidates(plans: np.ndarray, quantiles: int) -> np.ndarray:
    """The candidate fleets, deduplicated and sorted by (size, fleet)."""
    plans = np.asarray(plans, np.int64)
    qs = np.linspace(0.0, 1.0, quantiles)
    chain = np.quantile(plans, qs, axis=0, method="higher").astype(np.int64)
    uniq = np.unique(plans, axis=0)
    pairs = np.maximum(uniq[:, None, :], uniq[None, :, :]).reshape(
        -1, plans.shape[1])
    rows = {tuple(int(v) for v in r) for r in pairs} \
        | {tuple(int(v) for v in r) for r in chain}
    return np.asarray(sorted(rows, key=lambda r: (sum(r), r)), np.int64)


def select(plans: np.ndarray, node_cost: np.ndarray, quantiles: int,
           alpha: float, lam: float, premium: float) -> np.ndarray:
    """The selected fleet (node counts per type)."""
    fleets = candidates(plans, quantiles)
    short = np.maximum(plans[:, None, :] - fleets[None, :, :], 0)
    ov = (short * node_cost[None, None, :]).sum(axis=2)
    price = (fleets * node_cost[None, :]).sum(axis=1)
    obj = price + premium * ov.mean(axis=0)
    if lam > 0:
        obj = obj + lam * np.array([cvar(ov[:, j], alpha)
                                    for j in range(len(fleets))])
    keys = [(float(obj[j]), float(ov[:, j].max()), float(price[j]),
             tuple(fleets[j])) for j in range(len(fleets))]
    return fleets[min(range(len(fleets)), key=keys.__getitem__)]
