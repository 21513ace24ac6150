"""Shared layer primitives: RMSNorm, RoPE / M-RoPE, gated MLP, softcap.

Ported from ``repro.models.layers``.  Where the reference computes in
float32 (the norm, the rotary angles) the port does too, and casts back to
the input dtype at the same points.  GELU is the tanh approximation, which
is ``jax.nn.gelu``'s default.  Norm weights start at zero (the residual-from-1
convention): the modules' ``reset_parameters`` zero them, where the
reference calls ``init_norm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm", "rope", "mrope", "gated_mlp", "softcap", "gelu",
    "init_dense",
]


def softcap(x, cap):
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def gelu(x):
    """``jax.nn.gelu`` with its default ``approximate=True``."""
    return F.gelu(x, approximate="tanh")


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in fp32, cast back to input dtype (gemma convention:
    weight is a residual offset from 1)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(dtype)


def _freqs(dim: int, theta: float, device):
    """theta ** (-arange(0, dim, 2) / dim) in float32."""
    exps = -torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return torch.pow(theta, exps)


def _rotate(x, ang):
    """Half-split rotation of x (..., seq, heads, hd) by f32 angles
    (..., seq, hd/2); the result is cast back to x's dtype."""
    half = x.shape[-1] // 2
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta: float = 10_000.0):
    """Rotary position embedding.

    x: (..., seq, heads, head_dim); positions: (..., seq) integers.
    """
    freqs = _freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def mrope(x, positions_thw, sections, theta: float = 10_000.0):
    """Multimodal RoPE (Qwen2-VL): the head_dim/2 frequency slots are split
    into (t, h, w) sections, each rotated by its own position stream.

    x: (batch, seq, heads, head_dim); positions_thw: (3, batch, seq).
    sections: per-axis *pair* counts summing to head_dim // 2.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    freqs = _freqs(2 * half, theta, x.device)
    parts = []
    off = 0
    for i, sec in enumerate(sections):
        pos = positions_thw[i].float()  # (batch, seq)
        parts.append(pos[..., None] * freqs[off: off + sec])
        off += sec
    return _rotate(x, torch.cat(parts, dim=-1))


def init_dense(generator, shape, dtype, scale: float | None = None):
    """Truncated normal in [-2, 2] times ``scale`` (default fan_in ** -0.5,
    fan_in = shape[0]), drawn in float32 on the generator's device and cast
    to ``dtype``."""
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


def gated_mlp(x, params):
    """SwiGLU MLP (gelu(x W_gate) * x W_up) W_down, or plain GELU MLP
    gelu(x W_up) W_down when no gate matrix is present.  ``params`` maps
    ``w_up``, ``w_down`` and optionally ``w_gate`` to tensors."""
    up = x @ params["w_up"]
    if "w_gate" in params:
        return (gelu(x @ params["w_gate"]) * up) @ params["w_down"]
    return gelu(up) @ params["w_down"]
