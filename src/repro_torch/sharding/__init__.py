"""Distribution: partitioning rules for params, batches and decode state."""

from .partitioning import (
    batch_specs,
    decode_state_specs,
    named,
    param_specs,
    tree_named,
)

__all__ = ["batch_specs", "decode_state_specs", "named", "param_specs",
           "tree_named"]
