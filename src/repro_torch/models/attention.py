"""GQA attention: streaming (flash-style) train/prefill path and KV-cache
decode path, with sliding-window and soft-cap support.

Ported from ``repro.models.attention``, which writes the flash
decomposition in plain JAX (no Pallas kernel); the port writes it in plain
PyTorch and keeps its chunked loop, step for step: KV in chunks with an
online softmax (running max / normalizer) inside a loop over query chunks,
block masks generated from positions.  Scores and the PV product accumulate
in float32 (the reference's ``preferred_element_type``); the probabilities
are rounded to the value dtype before the PV product, as there.  A KV chunk
that is fully masked before the first valid one still adds ``exp(0)`` terms,
which the correction of the next valid chunk wipes out, as in the
reference.
"""

from __future__ import annotations

import torch

from .layers import softcap

__all__ = [
    "streaming_attention",
    "decode_attention",
    "init_cache_positions",
]

NEG_INF = -2.0e38


def _block_mask(q_pos, k_pos, window: int, causal: bool):
    """(Q, K) boolean mask from absolute positions; window < 0 = full."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return ok


def _pad_seq(x, pad: int):
    """Zero-pad axis 1 of (B, S, heads, hd) at the end."""
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)


def streaming_attention(
    q, k, v, *,
    window: int = -1,
    causal: bool = True,
    attn_softcap: float | None = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
):
    """Online-softmax attention.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H = KV * G.
    Returns (B, Sq, H, hd).  Positions are offsets + arange (contiguous).
    """
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    dev = q.device
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    nq = -(-Sq // qc)
    nk = -(-Skv // kc)
    q = _pad_seq(q, nq * qc - Sq)
    k = _pad_seq(k, nk * kc - Skv)
    v = _pad_seq(v, nk * kc - Skv)

    # head-major float32 K and V, (B, KV, nk * kc, hd): the cast and the
    # layout in one copy, so every chunk's products run as batched matmuls
    kt, vt = _head_major(k), _head_major(v)
    qr = q.reshape(B, nq, qc, KV, G, hd)
    q_positions = q_offset + torch.arange(nq * qc, dtype=torch.int32,
                                          device=dev)
    k_positions = kv_offset + torch.arange(nk * kc, dtype=torch.int32,
                                           device=dev)
    k_valid = torch.arange(nk * kc, device=dev) < Skv  # mask KV padding

    out = []
    for i in range(nq):
        # (B, KV, G * qc, hd); scores, max and normalizer are laid out
        # (B, KV, G, qc, ...), the reference's (B, qc, G, KV, ...) permuted
        qb = qr[:, i].permute(0, 2, 3, 1, 4).to(
            torch.float32, memory_format=torch.contiguous_format)
        qb = qb.reshape(B, KV, G * qc, hd)
        qpos = q_positions[i * qc:(i + 1) * qc]
        acc = torch.zeros((B, KV, G, qc, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=dev)
        for j in range(nk):
            kb = kt[:, :, j * kc:(j + 1) * kc]  # (B, KV, kc, hd)
            vb = vt[:, :, j * kc:(j + 1) * kc]
            kpos = k_positions[j * kc:(j + 1) * kc]
            kval = k_valid[j * kc:(j + 1) * kc]
            s = (qb @ kb.transpose(-1, -2)).reshape(B, KV, G, qc, kc) * scale
            s = softcap(s, attn_softcap)
            mask = _block_mask(qpos, kpos, window, causal) & kval[None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            # the probabilities are rounded to the value dtype first
            pv = p.to(v.dtype).float().reshape(B, KV, G * qc, kc) @ vb
            acc = acc * corr[..., None] + pv.reshape(B, KV, G, qc, hd)
            m = m_new
        norm = torch.clamp_min(l, 1e-37)[..., None]
        out.append((acc / norm).permute(0, 3, 1, 2, 4).to(q.dtype))
    out = torch.stack(out, dim=1).reshape(B, nq * qc, H, hd)
    return out[:, :Sq]


def _head_major(x):
    """(B, S, KV, hd) -> float32 (B, KV, S, hd), contiguous."""
    return x.transpose(1, 2).to(torch.float32,
                                memory_format=torch.contiguous_format)


def init_cache_positions(cache_len: int, device=None) -> torch.Tensor:
    """Per-slot absolute positions; -1 marks an empty slot."""
    return torch.full((cache_len,), -1, dtype=torch.int32, device=device)


def decode_attention(
    q, k_cache, v_cache, slot_pos, pos, *,
    window: int = -1,
    attn_softcap: float | None = None,
):
    """One-token attention against a (ring-buffer) KV cache.

    q: (B, H, hd); k_cache, v_cache: (B, CL, KV, hd);
    slot_pos: (CL,) absolute position stored in each slot (-1 = empty);
    pos: int — the current token's position (already written).
    """
    B, H, hd = q.shape
    _, CL, KV, _ = k_cache.shape
    G = H // KV
    scale = hd ** -0.5
    qr = q.reshape(B, KV, G, hd).float()
    # scores laid out (B, KV, G, CL), the reference's (B, G, KV, CL)
    # permuted; the cache is read head-major in float32
    s = (qr @ _head_major(k_cache).transpose(-1, -2)) * scale
    s = softcap(s, attn_softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        valid &= pos - slot_pos < window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = p.to(v_cache.dtype).float() @ _head_major(v_cache)  # (B,KV,G,hd)
    return out.reshape(B, H, hd).to(q.dtype)
