"""AdamW with global-norm clipping, as plain functions over a
``{parameter name: tensor}`` dict.

Ported from ``repro.train.optimizer``.  ``torch.optim.AdamW`` is not used:
it decays as ``p * (1 - lr * wd)`` and corrects the bias in another order,
and it has neither the global-norm clip nor the warmup of ``_schedule``.
The bias corrections and the schedule are float32, each leaf's update is
computed in float32 and rounded once to the parameter's dtype, and the
moments are kept in ``state_dtype`` (float32 default; bf16 halves their
memory), as the reference's.

**Weight decay follows the reference's stacked rank.**  The reference decays
a leaf when ``p.ndim >= 2`` ("no decay on norms/scalars"), but it stacks
every parameter of a segment (and of the encoder) along a leading
``repeats`` axis, so its per-layer norm scales and biases have rank 2 and
are decayed; only top-level 1-D leaves (``final_norm``,
``encoder.final_norm``) escape.  The port holds one module per layer, so
its own ranks would stop decaying every norm and bias: ``decays`` gives the
reference's rank from the parameter's name instead.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "decays"]

# names of the parameters the reference stacks along a leading axis
_STACKED = ("layers.", "encoder.blocks.")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    state_dtype: str = "float32"   # 'float32' | 'bfloat16'


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether the reference decays the parameter ``name``: its leaf there
    has rank >= 2, counting the stacking axis of per-layer parameters."""
    return p.ndim + name.startswith(_STACKED) >= 2


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, the leaves
    added one after another."""
    sq = None
    for g in tree.values():
        s = torch.sum(torch.square(g.float()))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each parameter, and the
    step count (an int32 tensor)."""
    dt = getattr(torch, cfg.state_dtype)
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _schedule(cfg: AdamWConfig, step):
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig):
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}): the
    parameters and the moments are updated in place (the dicts returned are
    the ones passed), and ``state["step"]`` is the step after this one."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * torch.square(g)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay and decays(name, p):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    state["step"] = step
    return params, state, {"grad_norm": gn, "lr": lr}
