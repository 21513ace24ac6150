"""Drivers of the program under test, one file per kind of traffic.  A mix
file names its driver (``"driver"``), and the harness loads
``drivers/<name>.py`` and builds its ``Driver``."""

from __future__ import annotations

from ..gen import Instance


def to_problem(t: Instance):
    """The program's ``Problem`` for an instance."""
    from repro_torch.core import NodeTypes, Problem

    return Problem(dem=t.dem, start=t.start, end=t.end,
                   node_types=NodeTypes(cap=t.cap, cost=t.cost), T=t.T)


def engine(cls, mix: dict, device):
    """The mix's engine (its solver and placement settings) on ``device``."""
    from repro_torch.core import PlacementConfig, SolverConfig

    cfg = mix["engine"]
    return cls(solver=SolverConfig(**cfg["solver"]),
               placement=PlacementConfig(**cfg["placement"]), device=device)
