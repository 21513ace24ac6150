"""PyTorch/CUDA port of the TL-Rightsizing package (``repro``).

The port mirrors the JAX package's layout and public names
(``repro_torch.core``, ``repro_torch.kernels``, ``repro_torch.workload``,
``repro_torch.serve``, ``repro_torch.stochastic``, ``repro_torch.models``,
``repro_torch.configs``, ``repro_torch.launch``)
and imports neither JAX nor the JAX package.  Its kernels are hand-written CUDA
for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.  Entry
points run on the CUDA card unless given ``device="cpu"``, where every
kernel is replaced by its plain PyTorch version.

The port covers the fleet evaluation path (``FleetEngine.evaluate``: pack,
the batched PDHG solve in legacy and tolerance mode, the placement engines),
constraints and the feasibility oracle, the workloads, the serving loop
(``repro_torch.serve.RightsizingService``), stochastic planning
(``repro_torch.stochastic.plan_stochastic``: a demand forecast fanned into K
scenarios, solved in one dispatch by ``FleetEngine.solve_scenarios``, and a
CVaR-selected fleet; ``RightsizingService.preprovision``), the rightsizing
CLI (``python -m repro_torch.launch.rightsize {plan,compare,fleet,serve}``)
and the LM substrate's serving path (``repro_torch.models``,
``repro_torch.configs``, ``python -m repro_torch.launch.serve``).
"""

from .core import (
    ALGORITHMS,
    FleetEngine,
    FleetResult,
    NodeTypes,
    PlacementConfig,
    Problem,
    Solution,
    SolverConfig,
    SweepConfig,
    evaluate,
    pack_problems,
    place_many,
    rightsize,
    solve_lp_many,
    two_phase,
    verify,
)
from .device import resolve_device

__all__ = [
    "ALGORITHMS", "FleetEngine", "FleetResult", "NodeTypes",
    "PlacementConfig", "Problem", "Solution", "SolverConfig", "SweepConfig",
    "evaluate", "pack_problems", "place_many", "rightsize", "solve_lp_many",
    "two_phase", "verify", "resolve_device",
]
