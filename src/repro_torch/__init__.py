"""PyTorch/CUDA port of the TL-Rightsizing package (``repro``).

The port mirrors the JAX package's layout and public names
(``repro_torch.core``, ``repro_torch.kernels``, ``repro_torch.workload``) and
imports neither JAX nor the JAX package.  Its kernels are hand-written CUDA
for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.  Entry
points run on the CUDA card unless given ``device="cpu"``, where every
kernel is replaced by its plain PyTorch version.

The port covers the fleet evaluation path (``FleetEngine.evaluate``: pack,
the batched PDHG solve in legacy and tolerance mode, the placement engines),
constraints and the feasibility oracle, the workloads, and the serving loop
(``repro_torch.serve.RightsizingService``).
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
