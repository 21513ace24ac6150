"""Workload generators of the port (mirrors ``repro.workload``): the paper's
Table-I synthetic instances, node-type cost models, the GCT-2019-like trace
emulation and the LM-job schedule adapter."""

from .cost_models import gce_like_cost, heterogeneous_cost, homogeneous_cost
from .synthetic import (
    SyntheticSpec,
    sweep_specs,
    synthetic_batch,
    synthetic_instance,
)
from .gct import gct_like_instance, gct_pool, load_trace_csv
from .jobs import (
    BUILTIN_DEMANDS,
    DEFAULT_SCHEDULE,
    Job,
    TPU_SKUS,
    fleet_problem,
    jobs_from_dryrun,
)

__all__ = [
    "homogeneous_cost", "heterogeneous_cost", "gce_like_cost",
    "synthetic_instance", "synthetic_batch", "sweep_specs", "SyntheticSpec",
    "gct_pool", "gct_like_instance", "load_trace_csv",
    "DEFAULT_SCHEDULE", "Job", "TPU_SKUS", "fleet_problem",
    "jobs_from_dryrun", "BUILTIN_DEMANDS",
]
