"""Data pipeline: deterministic synthetic LM token streams.

Ported from ``repro.train.data``; ``make_batch`` is the reference's numpy
generator, copied, so a batch is bit-equal to the reference's from the same
seed and step.  Batches are numpy arrays, as there; ``to_device`` moves one
onto a device as tensors.  Deterministic per-(step, host) batches make
restart-exactness testable: after a crash and restore at step k, the
pipeline regenerates exactly the batch the failed run would have seen.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import ModelConfig

__all__ = ["DataConfig", "SyntheticLMData", "make_batch", "to_device"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    seed: int = 1234


class SyntheticLMData:
    """Zipfian token stream with enough structure for loss to fall:
    each sequence is a repeating random n-gram pattern with noise, so a
    model can learn local statistics quickly."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig,
                 host_id: int = 0, num_hosts: int = 1):
        if dc.batch % num_hosts:
            raise ValueError(f"batch {dc.batch} does not split over "
                             f"{num_hosts} hosts")
        self.cfg = cfg
        self.dc = dc
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = dc.batch // num_hosts

    def batch_at(self, step: int) -> dict:
        return make_batch(self.cfg, self.dc, step, self.host_id,
                          self.num_hosts)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch(cfg: ModelConfig, dc: DataConfig, step: int,
               host_id: int = 0, num_hosts: int = 1) -> dict:
    local_batch = dc.batch // num_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, host_id]))
    B, S, V = local_batch, dc.seq_len, cfg.vocab_size
    period = 16
    # motifs draw from a small head vocabulary so the marginal is
    # learnable quickly (Zipf-like head), on top of the induction pattern
    motif = rng.integers(0, min(V, 1024), size=(B, period))
    reps = -(-S // period) + 1
    stream = np.tile(motif, (1, reps))[:, : S + 1]
    noise = rng.random((B, S + 1)) < 0.1
    stream = np.where(noise, rng.integers(0, V, size=(B, S + 1)), stream)
    tokens = stream[:, :S].astype(np.int32)
    labels = stream[:, 1:].astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.vision_seq:
        batch["vision"] = rng.standard_normal(
            (B, cfg.vision_seq, cfg.d_model)).astype(np.float32)
        batch["mrope_positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None, :], (3, B, S)).copy()
    return batch


def to_device(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device`` (one copy each)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
