"""Timeline trimming, feasible node types and penalty mappings (paper §II,
§III) on plain ``Instance`` arrays."""

from __future__ import annotations

import numpy as np

from ..gen import Instance


def trim(inst: Instance) -> Instance:
    """Keep only the slots where some task starts: congestion only grows
    at a start, so capacity checked there holds everywhere.  Spans are
    renumbered to the kept slots."""
    kept = np.unique(inst.start)
    start = np.searchsorted(kept, inst.start)
    end = np.searchsorted(kept, inst.end, side="right") - 1
    return inst._replace(start=start.astype(np.int64),
                         end=end.astype(np.int64), T=len(kept))


def feasible_types(inst: Instance) -> np.ndarray:
    """(n, m) bool: the task fits an empty node of the type."""
    return (inst.dem[:, None, :] <= inst.cap[None, :, :] + 1e-12).all(axis=2)


def relative_demand(inst: Instance, kind: str) -> np.ndarray:
    """(n, m) heights h(u|B): the mean or max over d of dem / cap."""
    ratios = inst.dem[:, None, :] / inst.cap[None, :, :]
    return ratios.mean(axis=2) if kind == "avg" else ratios.max(axis=2)


def penalty_map(inst: Instance, kind: str) -> np.ndarray:
    """(n,) least-penalty feasible node type, penalty cost(B) * h(u|B)."""
    p = relative_demand(inst, kind) * inst.cost[None, :]
    return np.where(feasible_types(inst), p, np.inf).argmin(axis=1)
