"""Training/serving substrate: optimizer, step factories, data,
checkpointing, fault tolerance, gradient compression.

Ported from ``repro.train`` with the reference's exports.  The port's step
updates the model and its state in place (``make_train_step``)."""

from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm
from .train_step import (
    TrainConfig,
    init_train_state,
    make_serve_steps,
    make_train_step,
)
from .data import DataConfig, SyntheticLMData, make_batch
from . import checkpoint, compression, fault

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "global_norm",
    "TrainConfig", "init_train_state", "make_serve_steps",
    "make_train_step", "DataConfig", "SyntheticLMData", "make_batch",
    "checkpoint", "compression", "fault",
]
