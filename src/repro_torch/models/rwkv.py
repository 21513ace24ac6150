"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free time-mix with
data-dependent decay, plus squared-ReLU channel-mix.

State per head is an (N, N) outer-product accumulator:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(-exp(wproj(x_t))) the data-dependent decay, carried as its
logarithm lw_t = -exp(wproj(x_t)) into the recurrence.  Ported from
``repro.models.rwkv``: the reference's ``lax.scan`` over time is the
``repro_torch::wkv`` operator (``kernels.wkv``: the hand-written kernel on
the card, the plain loop on the CPU, one operator a layer in a trace), and
decode carries O(1) state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ref import wkv_step_ref
from ..kernels.wkv import wkv
from ..sharding.ctx import constrain, shard_local
from .layers import init_dense

__all__ = ["TimeMix", "ChannelMix", "timemix_scan", "timemix_step",
           "channelmix", "channelmix_step"]


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class TimeMix(nn.Module):
    """Time-mix weights in the reference's layouts: five float32 mixes
    (d,), w_r, w_k, w_v, w_g, w_out (d, d), float32 w_decay (d, d),
    decay_bias (d,), u_bonus (H, N) and the group-norm scale ln_x (d,)."""

    def __init__(self, d_model: int, head_dim: int, dtype, device):
        super().__init__()
        d, f32 = d_model, torch.float32
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, name, _param((d,), f32, device))
        for name in ("w_r", "w_k", "w_v", "w_g"):
            setattr(self, name, _param((d, d), dtype, device))
        self.w_decay = _param((d, d), f32, device)
        self.decay_bias = _param((d,), f32, device)
        self.u_bonus = _param((d // head_dim, head_dim), f32, device)
        self.w_out = _param((d, d), dtype, device)
        self.ln_x = _param((d,), f32, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        d = self.w_r.shape[0]
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            getattr(self, name).fill_(0.5)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_out"):
            w = getattr(self, name)
            w.copy_(init_dense(generator, (d, d), w.dtype))
        self.w_decay.copy_(init_dense(generator, (d, d), torch.float32,
                                      scale=0.01 * d ** -0.5))
        self.decay_bias.fill_(-4.0)
        self.u_bonus.zero_()
        self.ln_x.fill_(1.0)  # group-norm scale


class ChannelMix(nn.Module):
    """Channel-mix weights: float32 mu_k, mu_r (d,), w_k (d, ff),
    w_v (ff, d), w_r (d, d)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        f32 = torch.float32
        self.mu_k = _param((d_model,), f32, device)
        self.mu_r = _param((d_model,), f32, device)
        self.w_k = _param((d_model, d_ff), dtype, device)
        self.w_v = _param((d_ff, d_model), dtype, device)
        self.w_r = _param((d_model, d_model), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.mu_k.fill_(0.5)
        self.mu_r.fill_(0.5)
        for name in ("w_k", "w_v", "w_r"):
            w = getattr(self, name)
            w.copy_(init_dense(generator, tuple(w.shape), w.dtype))


def _shift(x, x_prev):
    """Token shift: previous token's features (B, S, d); x_prev (B, d) is
    the last token of the previous segment (zeros at sequence start)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _projections(x, xs, p, head_dim: int):
    B, S, d = x.shape
    H = d // head_dim
    r = _mix(x, xs, p.mu_r) @ p.w_r
    k = _mix(x, xs, p.mu_k) @ p.w_k
    v = _mix(x, xs, p.mu_v) @ p.w_v
    g = _mix(x, xs, p.mu_g) @ p.w_g
    wx = _mix(x, xs, p.mu_w).float() @ p.w_decay
    # the log-decay (B, S, d), <= 0; exp(lw) is the reference's w
    lw = -torch.exp(wx + p.decay_bias)
    shp = (B, S, H, head_dim)
    # keep the head axis sharded over 'model' through the recurrence
    return tuple(
        constrain(a.reshape(shp), "batch", None, "heads", None)
        for a in (r, k, v)
    ) + (g, constrain(lw.reshape(shp), "batch", None, "heads", None))


def _group_norm(y, scale):
    """Per-head layer norm of the wkv output (ln_x in RWKV)."""
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, unbiased=False, keepdim=True)
    yn = (y - mean) * torch.rsqrt(var + 1e-5)
    B, S, H, N = yn.shape
    return yn.reshape(B, S, H * N) * scale


def _wkv_scan(r, k, v, lw, u):
    """The recurrence over time on (B, S, H, N) inputs and log-decays lw,
    from a zero state; ``u`` is the bonus broadcast to that shape.  Returns
    (y (B, S, H, N), the final state as (B, 1, H, N * N)), both float32."""
    B, S, H, N = r.shape
    y, S_state = wkv(r.contiguous(), k.contiguous(), v.contiguous(),
                     lw.contiguous(), u[0, 0].contiguous())
    return y, S_state.reshape(B, 1, H, N * N)


def timemix_scan(x, x_prev, p, head_dim: int):
    """Full-sequence time-mix.  x: (B, S, d); x_prev: (B, d).
    Returns (out (B, S, d), S_final (B, H, N, N), x_last (B, d))."""
    B, S, d = x.shape
    H = d // head_dim
    xs = _shift(x, x_prev)
    r, k, v, g, lw = _projections(x, xs, p, head_dim)
    # the bonus laid out like r (a view): the scan runs on each device's
    # batch rows and heads alone (``shard_local``)
    u = constrain(p.u_bonus.expand(B, S, H, head_dim), "batch", None,
                  "heads", None)
    y, S_state = shard_local(_wkv_scan, r, k, v, lw, u, outputs=2)
    S_state = S_state.reshape(B, H, head_dim, head_dim)
    y = _group_norm(y, p.ln_x).to(x.dtype)
    out = (y * F.silu(g)) @ p.w_out
    return out, S_state, x[:, -1, :]


def timemix_step(x_t, state, p, head_dim: int):
    """Decode: x_t (B, d); state = (S (B,H,N,N) fp32, x_prev (B, d))."""
    S_state, x_prev = state
    r, k, v, g, lw = _projections(x_t[:, None, :], x_prev[:, None, :], p,
                                  head_dim)
    # exp(-exp(.)) in the reference's float32 operations: w bit-equal to it
    y, S_new = wkv_step_ref(S_state, r[:, 0], k[:, 0], v[:, 0],
                            torch.exp(lw[:, 0]), p.u_bonus)
    y = _group_norm(y[:, None], p.ln_x)[:, 0].to(x_t.dtype)
    out = (y * F.silu(g[:, 0])) @ p.w_out
    return out, (S_new, x_t)


def channelmix(x, x_prev, p):
    """x: (B, S, d); returns (out, x_last)."""
    xs = _shift(x, x_prev)
    k = _mix(x, xs, p.mu_k) @ p.w_k
    r = torch.sigmoid(_mix(x, xs, p.mu_r) @ p.w_r)
    out = r * (torch.square(torch.relu(k)) @ p.w_v)
    return out, x[:, -1, :]


def channelmix_step(x_t, x_prev, p):
    """Decode: x_t (B, d), x_prev (B, d) -> (out (B, d), new x_prev)."""
    out, _ = channelmix(x_t[:, None, :], x_prev, p)
    return out[:, 0], x_t
