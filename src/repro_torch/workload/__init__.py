"""Workload generators of the port: the paper's Table-I synthetic
instances and node-type cost models (mirrors ``repro.workload``)."""

from .cost_models import gce_like_cost, heterogeneous_cost, homogeneous_cost
from .synthetic import (
    SyntheticSpec,
    sweep_specs,
    synthetic_batch,
    synthetic_instance,
)

__all__ = [
    "homogeneous_cost", "heterogeneous_cost", "gce_like_cost",
    "synthetic_instance", "synthetic_batch", "sweep_specs", "SyntheticSpec",
]
