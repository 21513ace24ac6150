"""The metrics -> flags -> scale decision loop.

Each tick's re-solve proposes ``required`` node counts per type for
every re-planned fleet.  This module decides what the fleet actually
adopts, the way managed autoscalers do it: every precondition of a
scale-in is evaluated as a named flag with a human-readable message,
the decision is the conjunction, and the whole evaluation is logged as
a structured event.  Growing is never gated — a fleet below its
required counts is infeasible — but releasing nodes must pass a
cooldown window, a minimum-savings threshold, and an Eva-style
reconfiguration payback test (projected savings over a payback horizon
must beat the churn cost of changing nodes), so the plan does not
thrash between epsilon-different placements.

Ported from ``repro.serve.scale``: pure numpy, the same flags, messages
and events.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ScaleCheck", "ScaleDecision", "ScaleEvent", "evaluate_scale"]


@dataclasses.dataclass(frozen=True)
class ScaleCheck:
    """One named scale-in precondition: flag=True means it passed."""

    name: str
    flag: bool
    message: str

    def to_dict(self) -> dict:
        return {"name": self.name, "flag": bool(self.flag),
                "message": self.message}

    @staticmethod
    def from_dict(d: dict) -> "ScaleCheck":
        return ScaleCheck(name=d["name"], flag=bool(d["flag"]),
                          message=d["message"])


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """The adopted plan of one fleet after flag evaluation.

    scope: 'admit' (first plan), 'hold' (no change), 'scale-out'
        (forced growth only), 'scale-in' (release adopted), or
        'hold-release' (a proposed release rejected by the flags —
        the fleet holds ``max(current, required)``).
    adopted: (m,) node counts the fleet runs with after this tick.
    cost: adopted counts priced at the node-type costs.
    checks: every evaluated flag (empty when no release was proposed).
    """

    scope: str
    adopted: np.ndarray
    cost: float
    checks: tuple[ScaleCheck, ...] = ()

    @property
    def scaled_in(self) -> bool:
        return self.scope == "scale-in"


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One structured decision-log entry (JSON-ready via ``to_dict``)."""

    tick: int
    fleet: str
    scope: str
    cost_before: float
    cost_after: float
    checks: tuple[ScaleCheck, ...]

    def to_dict(self) -> dict:
        return {
            "tick": self.tick, "fleet": self.fleet, "scope": self.scope,
            "cost_before": round(float(self.cost_before), 6),
            "cost_after": round(float(self.cost_after), 6),
            "checks": [c.to_dict() for c in self.checks],
        }

    @staticmethod
    def from_dict(d: dict) -> "ScaleEvent":
        return ScaleEvent(
            tick=int(d["tick"]), fleet=d["fleet"], scope=d["scope"],
            cost_before=float(d["cost_before"]),
            cost_after=float(d["cost_after"]),
            checks=tuple(ScaleCheck.from_dict(c) for c in d["checks"]))


def evaluate_scale(current: np.ndarray | None, required: np.ndarray,
                   node_cost: np.ndarray, *, tick: int,
                   last_scale_in_tick: int, cfg) -> ScaleDecision:
    """Flag-gated scale decision for one fleet.

    ``current`` is the fleet's adopted per-type node counts (None for a
    fresh fleet), ``required`` the counts the tick's placement needs,
    ``node_cost`` the per-type hourly cost, ``cfg`` a ``ServiceConfig``.

    >>> import numpy as np
    >>> from repro_torch.serve.config import ServiceConfig
    >>> cfg = ServiceConfig(scale_in_cooldown=2, min_scale_in_savings=0.01)
    >>> cost = np.array([1.0, 2.0])
    >>> d = evaluate_scale(np.array([2, 1]), np.array([1, 1]), cost,
    ...                    tick=0, last_scale_in_tick=-10, cfg=cfg)
    >>> d.scope, d.adopted.tolist()
    ('scale-in', [1, 1])
    >>> d = evaluate_scale(np.array([2, 1]), np.array([1, 1]), cost,
    ...                    tick=1, last_scale_in_tick=0, cfg=cfg)
    >>> d.scope, d.adopted.tolist()        # cooldown holds the release
    ('hold-release', [2, 1])
    """
    required = np.asarray(required, dtype=np.int64)
    node_cost = np.asarray(node_cost, dtype=float)
    if current is None:
        return ScaleDecision(scope="admit", adopted=required,
                             cost=float(required @ node_cost))
    current = np.asarray(current, dtype=np.int64)
    hold = np.maximum(current, required)   # feasible without releases
    hold_cost = float(hold @ node_cost)
    required_cost = float(required @ node_cost)
    releases = hold - required
    if not releases.any():
        scope = "scale-out" if (required > current).any() else "hold"
        return ScaleDecision(scope=scope, adopted=hold, cost=hold_cost)

    savings = hold_cost - required_cost
    savings_frac = savings / max(hold_cost, 1e-12)
    churn = float(np.abs(required - current) @ node_cost)
    since = tick - last_scale_in_tick
    checks = (
        ScaleCheck(
            "cooldown", since >= cfg.scale_in_cooldown,
            f"{since} tick(s) since last scale-in "
            f"(need >= {cfg.scale_in_cooldown})"),
        ScaleCheck(
            "savings", savings_frac >= cfg.min_scale_in_savings,
            f"release saves {savings_frac:.2%} of the current plan "
            f"(need >= {cfg.min_scale_in_savings:.2%})"),
        ScaleCheck(
            "payback", savings * cfg.payback_ticks
            >= cfg.reconfig_weight * churn,
            f"savings over {cfg.payback_ticks} tick(s) = "
            f"{savings * cfg.payback_ticks:.3f} vs reconfiguration "
            f"cost {cfg.reconfig_weight:.2f} x {churn:.3f} node churn"),
    )
    if all(c.flag for c in checks):
        return ScaleDecision(scope="scale-in", adopted=required,
                             cost=required_cost, checks=checks)
    return ScaleDecision(scope="hold-release", adopted=hold,
                         cost=hold_cost, checks=checks)
