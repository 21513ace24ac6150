"""Gradient compression for cross-pod synchronization: int8 block
quantization with error feedback.

Ported from ``repro.train.compression``.  Each tensor is flattened, padded
to blocks of 256 and quantized per block to int8 with a float32 scale
(max |x| / 127, at least 1e-12), rounding half to even (``torch.round``, as
``jnp.round``).  The quantization residual is carried to the next step in
float32, so compression error accumulates to zero instead of biasing the
update (Karimireddy et al., 2019).

``compress_decompress`` is the numerics of one round trip.
``compressed_psum`` is the explicit collective over one named dimension of
the ambient mesh (``sharding.ctx.use_mesh``): every participant all-gathers
the others' int8 blocks and float32 scales (about 1 byte an element on the
wire, against 4 for a float32 all-reduce) and sums ``q * s`` over them in
rank order, in float32.  Its process group is the mesh dimension's: NCCL on
the cards, gloo on the CPU.
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
    """Quantized all-reduce of ``g`` over the mesh dimension ``axis_name``
    with error feedback: returns (the sum over participants in g's dtype,
    this participant's new float32 residual).

    The group is that dimension of the ambient mesh
    (``sharding.ctx.current_mesh()``); without a mesh, or for a name the
    mesh lacks, it raises ``ValueError``.  The int8 blocks and scales are
    all-gathered as their dim-0 concatenation over the group's ranks, and
    ``sum_p q_p * s_p`` is taken in rank order in float32 (the reference's
    ``einsum("pbk,pbo->bk")``)."""
    import torch.distributed as dist

    from ..sharding.ctx import current_mesh

    mesh = current_mesh()
    if mesh is None:
        raise ValueError(
            "compressed_psum needs a mesh: call it under "
            "sharding.ctx.use_mesh(mesh) with a DeviceMesh that has a "
            f"{axis_name!r} dimension")
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(
            f"the mesh has no dimension {axis_name!r} (dimensions {names})")
    group = mesh.get_group(axis_name)
    corrected = g.float() + err
    q, scale, n = quantize_int8(corrected)
    new_err = corrected - dequantize_int8(q, scale, n, g.shape)
    world = dist.get_world_size(group)
    blocks = q.shape[0]
    q_all = torch.empty((world * blocks, _BLOCK), dtype=torch.int8,
                        device=q.device)
    s_all = torch.empty((world * blocks, 1), dtype=torch.float32,
                        device=q.device)
    dist.all_gather_into_tensor(q_all, q, group=group)
    dist.all_gather_into_tensor(s_all, scale, group=group)
    summed = q_all[:blocks].float() * s_all[:blocks]
    for p in range(1, world):
        rows = slice(p * blocks, (p + 1) * blocks)
        summed = summed + q_all[rows].float() * s_all[rows]
    deq = summed.reshape(-1)[:n].reshape(g.shape)
    return deq.to(g.dtype), new_err


def init_error_state(params: dict) -> dict:
    """Zero float32 residuals beside each parameter of a ``{name: tensor}``
    dict."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
