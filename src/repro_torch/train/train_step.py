"""Train / serve step factories.

Ported from ``repro.train.train_step``.  ``make_train_step(model, tc)``
builds a step that updates ``model`` in place:

  * remat (activation checkpointing) per repeat of each segment's unit,
    as ``loss_fn(remat=True)``;
  * optional microbatch gradient accumulation: the batch's leading axis
    split into ``tc.microbatch`` contiguous parts (batch axis 1 of
    "mrope_positions"), one backward each, the gradients summed in float32
    buffers and averaged, as the reference's ``zero_grads`` scan;
  * optional int8 error-feedback gradient compression
    (``compression.compress_decompress`` leaf by leaf, carrying
    ``state["err"]``);
  * AdamW with clipping and warmup.

Gradients come from ``torch.autograd.grad``, never from ``.grad``: with
``microbatch=1`` they keep the parameters' dtype, as the reference's
``jax.value_and_grad``; with more they are float32 means.

``make_serve_steps(model, max_len)`` builds (prefill_fn, decode_fn).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import decode_step, loss_fn, prefill
from . import compression
from .data import to_device
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainConfig", "make_train_step", "init_train_state",
           "make_serve_steps"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    remat: bool = True
    microbatch: int = 1          # gradient-accumulation factor
    loss_chunk: int = 512
    compress_grads: bool = False  # int8 error-feedback compression


def init_train_state(model, tc: TrainConfig) -> dict:
    """``{"opt": AdamW state by parameter name}`` and, with compression,
    ``"err"``: float32 residuals by parameter name."""
    params = dict(model.named_parameters())
    state = {"opt": adamw_init(params, tc.optimizer)}
    if tc.compress_grads:
        state["err"] = compression.init_error_state(params)
    return state


def _microbatches(batch: dict, n: int) -> list[dict]:
    """``n`` contiguous parts of the batch axis (axis 1 of
    "mrope_positions", (3, B, S); axis 0 of everything else)."""
    B = batch["tokens"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    b = B // n
    return [{k: (v[:, i * b:(i + 1) * b] if k == "mrope_positions"
                 else v[i * b:(i + 1) * b]) for k, v in batch.items()}
            for i in range(n)]


def make_train_step(model, tc: TrainConfig):
    """Returns step(state, batch) -> (state, metrics).  The step updates
    ``model``'s parameters and ``state`` in place (``state`` returned is
    the dict passed).  ``batch`` is a dict of numpy arrays or tensors,
    moved to the model's device.  ``metrics`` holds 0-d tensors: "loss",
    "xent", "aux" (with ``microbatch=1``), "grad_norm" and "lr"."""
    params = dict(model.named_parameters())
    names, plist = list(params), list(params.values())

    def value_and_grad(batch):
        loss, metrics = loss_fn(model, batch, remat=tc.remat,
                                loss_chunk=tc.loss_chunk)
        grads = torch.autograd.grad(loss, plist)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def grads_of(batch):
        if tc.microbatch <= 1:
            loss, metrics, grads = value_and_grad(batch)
            return loss, metrics, dict(zip(names, grads))
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in plist]
        loss_sum = torch.zeros((), dtype=torch.float32, device=plist[0].device)
        for mb in _microbatches(batch, tc.microbatch):
            loss, _m, grads = value_and_grad(mb)
            for a, g in zip(acc, grads):
                a.add_(g)
            loss_sum = loss_sum + loss
            del grads
        inv = 1.0 / tc.microbatch
        for a in acc:
            a.mul_(inv)
        loss = loss_sum * inv
        return loss, {"xent": loss}, dict(zip(names, acc))

    def step(state, batch):
        loss, metrics, grads = grads_of(to_device(batch, plist[0].device))
        if tc.compress_grads:
            for name, g in grads.items():
                grads[name], err = compression.compress_decompress(
                    g, state["err"][name])
                state["err"][name].copy_(err)
        _p, _opt, opt_metrics = adamw_update(params, grads, state["opt"],
                                             tc.optimizer)
        return state, {"loss": loss, **metrics, **opt_metrics}

    return step


def make_serve_steps(model, max_len: int):
    """Returns (prefill_fn(batch), decode_fn(state, tokens)) on ``model``."""

    def prefill_fn(batch):
        return prefill(model, batch, max_len=max_len)

    def decode_fn(state, tokens):
        return decode_step(model, state, tokens)

    return prefill_fn, decode_fn
