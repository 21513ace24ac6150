"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The recurrence  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
with input/recurrence gates is linear in h.  Ported from
``repro.models.rglru``: the gates are computed in float32 as there, and the
full-sequence path scans time sequentially in float32 (the
``repro_torch::linear_scan`` operator, ``kernels.scan``: the hand-written
kernel on the card, the plain loop on the CPU) where the reference uses
``lax.associative_scan``; the two sum in another order (float32 rounding,
well inside 1e-4 at the tests' sizes).  Decode keeps O(1) state per layer.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.scan import linear_scan
from ..sharding.ctx import constrain, shard_local
from .layers import init_dense

__all__ = ["RGLRU", "rglru_scan", "rglru_step", "temporal_conv",
           "conv_step"]

_C = 8.0  # RG-LRU soft clamp constant from the paper


class RGLRU(nn.Module):
    """The mixer's weights in the reference's layouts: w_x, w_gate (d, W),
    conv_w (K, W), w_input_gate, w_rec_gate (W, W), lam (W,) float32 and
    w_out (W, d)."""

    def __init__(self, d_model: int, width: int, conv_width: int, dtype,
                 device):
        super().__init__()

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.w_x = param(d_model, width)
        self.w_gate = param(d_model, width)
        self.conv_w = param(conv_width, width)
        self.w_input_gate = param(width, width)
        self.w_rec_gate = param(width, width)
        self.lam = param(width, dt=torch.float32)
        self.w_out = param(width, d_model)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for name in ("w_x", "w_gate", "conv_w", "w_input_gate", "w_rec_gate",
                     "w_out"):
            w = getattr(self, name)
            w.copy_(init_dense(generator, tuple(w.shape), w.dtype))
        # a = sigmoid(lam)^(c * r_t); init near 0.9..0.999
        self.lam.copy_(torch.linspace(2.0, 6.0, self.lam.shape[0]))


def temporal_conv(x, conv_w):
    """Depthwise causal conv along time: x (B, S, W), conv_w (K, W)."""
    K = conv_w.shape[0]
    S = x.shape[1]
    pads = [x]
    for k in range(1, K):
        shifted = torch.cat([x.new_zeros((x.shape[0], k, x.shape[2])), x], 1)
        pads.append(shifted[:, :S])
    stack = torch.stack(pads, dim=0)  # (K, B, S, W) — k steps back
    return torch.einsum("kbsw,kw->bsw", stack, conv_w.to(x.dtype))


def conv_step(x_t, conv_state, conv_w):
    """Decode: x_t (B, W); conv_state (B, K-1, W) holds previous inputs."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, K, W)
    out = torch.einsum("bkw,kw->bw", full.flip(1), conv_w.to(x_t.dtype))
    return out, full[:, 1:]


def _gates(x, params):
    """RG-LRU gate computation (fp32): returns (a, gated_input)."""
    xf = x.float()
    r = torch.sigmoid(xf @ params.w_rec_gate.float())
    i = torch.sigmoid(xf @ params.w_input_gate.float())
    # jax.nn.softplus is logaddexp(x, 0)
    softplus = torch.logaddexp(params.lam, torch.zeros_like(params.lam))
    log_a = -_C * r * softplus  # log a_t <= 0
    a = torch.exp(log_a)
    gated_x = xf * i
    # sqrt(1 - a^2) input normalizer
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * gated_x


def rglru_scan(x, params):
    """Full-sequence RG-LRU: x (B, S, W) -> (out (B, S, W), h_final fp32).
    h_0 = 0; a sequential float32 scan over time."""
    x = constrain(x, "batch", None, "model")
    # both (B, S, W) fp32, laid out as the scan needs them: time whole,
    # batch and channels sharded (the gates' products may shard time)
    a, b = (constrain(t, "batch", None, "model") for t in _gates(x, params))
    # elementwise over batch and channels: each device scans its own shards
    h, h_t = shard_local(_scan, a, b, outputs=2)
    return h.to(x.dtype), h_t[:, 0]


def _scan(a, b):
    """h_t = a_t * h_{t-1} + b_t over time from h_0 = 0, on (B, S, W):
    returns (h, the last h as (B, 1, W))."""
    h = linear_scan(a.contiguous(), b.contiguous())
    return h, h[:, -1:].clone()  # a copy: a view would keep all of h alive


def rglru_step(x_t, h_prev, params):
    """Decode: x_t (B, W), h_prev (B, W) fp32 -> (out, h_new)."""
    a, b = _gates(x_t, params)
    h = a * h_prev + b
    return h.to(x_t.dtype), h
