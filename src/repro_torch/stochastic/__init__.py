"""Stochastic rightsizing: plan under demand uncertainty.

The paper buys a minimum-cost cluster for a *known* timeline; this
layer plans for a demand *distribution*: a ``DemandForecast`` (point-
forecast base instance + load/diurnal/burst uncertainty channels) is
fanned into K seeded Monte-Carlo scenario instances on ONE shared
trimmed shape (``fan_out``), all K mapping LPs solve in a single
batched dispatch (``FleetEngine.solve_scenarios`` — the shape the
batched engine was built for), and ``plan_stochastic`` selects the
fleet minimizing ``E[cost] + lambda * CVaR_alpha(overload)`` with an
Eva-style reconfiguration penalty against the currently deployed
fleet.  See docs/stochastic.md for the model, the objective, and a
frontier walkthrough.

Ported from ``repro.stochastic`` with the same modules and public names.
The fan-out and the selection are float64 numpy on the host, bit-equal to
the reference's from the same seed; the K-lane solve and the placements run
through the port's ``FleetEngine`` on its device (None = the CUDA card).
"""

from .forecast import DemandForecast, fit_forecast, gct_forecast
from .scenarios import ScenarioSet, fan_out
from .select import (StochasticConfig, StochasticResult,
                     candidate_fleets, cvar, overload_costs,
                     plan_stochastic)

__all__ = [
    "DemandForecast", "fit_forecast", "gct_forecast",
    "ScenarioSet", "fan_out",
    "StochasticConfig", "StochasticResult", "candidate_fleets",
    "cvar", "overload_costs", "plan_stochastic",
]
