"""Gradient compression for cross-pod synchronization: int8 block
quantization with error feedback.

Ported from ``repro.train.compression``.  Each tensor is flattened, padded
to blocks of 256 and quantized per block to int8 with a float32 scale
(max |x| / 127, at least 1e-12), rounding half to even (``torch.round``, as
``jnp.round``).  The quantization residual is carried to the next step in
float32, so compression error accumulates to zero instead of biasing the
update (Karimireddy et al., 2019).

``compress_decompress`` is the numerics of one round trip.  The explicit
collective, ``compressed_psum``, is an all-gather over a mesh axis of more
than one card, which the port does not have yet: it raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["quantize_int8", "dequantize_int8", "compress_decompress",
           "compressed_psum", "init_error_state"]

_BLOCK = 256


def _pad_to_block(x):
    n = x.numel()
    return F.pad(x.reshape(-1), (0, (-n) % _BLOCK)), n


def quantize_int8(g):
    """Per-block symmetric int8 quantization: returns (q, scales, n)."""
    flat, n = _pad_to_block(g.float())
    blocks = flat.reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, n


def dequantize_int8(q, scale, n, shape):
    deq = (q.float() * scale).reshape(-1)[:n]
    return deq.reshape(shape)


def compress_decompress(g, err):
    """Error-feedback round trip: returns (g_hat in g's dtype, new float32
    err)."""
    corrected = g.float() + err
    q, scale, n = quantize_int8(corrected)
    g_hat = dequantize_int8(q, scale, n, g.shape)
    return g_hat.to(g.dtype), corrected - g_hat


def compressed_psum(g, err, axis_name: str):
    """The quantized all-reduce over a mesh axis: needs more than one
    card."""
    raise NotImplementedError(
        "compressed_psum is an all-gather across cards: multi-card "
        "gradient compression is not ported (one card only)")


def init_error_state(params: dict) -> dict:
    """Zero float32 residuals beside each parameter of a ``{name: tensor}``
    dict."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
