"""Mixture-of-Experts MLP with top-k routing and capacity-based,
sort-order dispatch (dropless up to the capacity factor).

Ported from ``repro.models.moe``.  Tokens are sorted by expert id and
scattered into a rectangular (E, C, d) buffer per group; the expert matmuls
are one batched einsum over that buffer, and results scatter back weighted
by the router probabilities.  Tokens beyond an expert's capacity go to a
dump row and are dropped.  Routing is equal to the reference's, not just
close: top-k breaks ties toward the lower expert index (``lax.top_k``), and
the sort by expert id is stable.  The reference's vmap over groups is one
batched computation over the leading group axis here.
"""

from __future__ import annotations

import torch
from torch import nn

from ..sharding.ctx import constrain
from .layers import gelu, init_dense

__all__ = ["moe_mlp", "MoE", "router_capacity"]


def router_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    cap = int(num_tokens * top_k / num_experts * capacity_factor)
    return max(cap, 4)


class MoE(nn.Module):
    """Router (f32) and stacked expert weights, in the reference's layouts:
    router (d, E), w_gate / w_up (E, d, ff), w_down (E, ff, d)."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int, dtype,
                 device):
        super().__init__()
        E = num_experts

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.router = param(d_model, E, dt=torch.float32)
        self.w_gate = param(E, d_model, d_ff)
        self.w_up = param(E, d_model, d_ff)
        self.w_down = param(E, d_ff, d_model)

    @torch.no_grad()
    def reset_parameters(self, generator):
        # the reference's init_dense takes fan_in from the leading (expert)
        # axis of the stacked gate and up matrices
        for name in ("router", "w_gate", "w_up"):
            w = getattr(self, name)
            w.copy_(init_dense(generator, tuple(w.shape), w.dtype))
        d_ff = self.w_down.shape[1]
        self.w_down.copy_(init_dense(generator, tuple(self.w_down.shape),
                                     self.w_down.dtype, scale=d_ff ** -0.5))


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(xg, probs, top_k: int, C: int):
    """Sort-order dispatch of every group at once.

    xg: (G, N, d) tokens; probs: (G, N, E) router probabilities.
    Returns (buf (G, E, C, d), meta) with meta = (slot, keep, order,
    flat_tok, flat_p, flat_e), each (G, N*k): the reference's
    ``_dispatch_group`` outputs stacked over groups.
    """
    G, N, d = xg.shape
    E = probs.shape[-1]
    dev = xg.device
    top_p, top_e = _top_k(probs, top_k)                    # (G, N, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    flat_e = top_e.reshape(G, -1)                          # (G, N*k)
    flat_p = top_p.reshape(G, -1)
    flat_tok = torch.arange(N, device=dev).repeat_interleave(top_k)
    flat_tok = flat_tok.expand(G, -1)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    e_sorted = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=dev).expand(G, -1).contiguous()
    start = torch.searchsorted(e_sorted.contiguous(), experts, right=False)
    rank = (torch.arange(N * top_k, device=dev)
            - torch.gather(start, 1, e_sorted))
    keep = rank < C
    slot = torch.where(keep, e_sorted * C + rank,
                       torch.full_like(rank, E * C))       # overflow -> dump
    src = torch.gather(xg, 1, torch.gather(flat_tok, 1, order)[..., None]
                       .expand(-1, -1, d))
    buf = xg.new_zeros((G, E * C + 1, d))
    buf.scatter_(1, slot[..., None].expand(-1, -1, d), src)
    return (buf[:, :E * C].reshape(G, E, C, d),
            (slot, keep, order, flat_tok, flat_p, flat_e))


def _combine(out_flat, meta, N: int):
    """out_flat: (G, E*C, d) expert outputs -> (G, N, d), each kept slot
    weighted by its renormalized router probability and scatter-added to
    its token."""
    slot, keep, order, flat_tok, flat_p, _flat_e = meta
    G, EC, d = out_flat.shape
    dtype = out_flat.dtype
    gathered = torch.gather(out_flat, 1, torch.clamp(slot, 0, EC - 1)[..., None]
                            .expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=dtype, device=gathered.device))
    weighted = gathered * torch.gather(flat_p, 1, order)[..., None].to(dtype)
    out = out_flat.new_zeros((G, N, d))
    tok = torch.gather(flat_tok, 1, order)
    return out.scatter_add_(1, tok[..., None].expand(-1, -1, d), weighted)


def moe_mlp(x, params: MoE, *, top_k: int, capacity_factor: float = 1.25):
    """x: (..., d) -> (..., d).

    Routing is *per group* (a group = one leading-axis row, i.e. one batch
    element; a 2-D input is one group).  Returns (out, aux) where aux is
    the Switch-style load-balancing loss over all groups.
    """
    orig_shape = x.shape
    d = orig_shape[-1]
    G = orig_shape[0] if x.ndim >= 3 else 1
    xg = x.reshape(G, -1, d)
    N = xg.shape[1]
    E = params.router.shape[1]
    C = router_capacity(N, E, top_k, capacity_factor)

    logits = xg.float() @ params.router                     # (G, N, E)
    probs = torch.softmax(logits, dim=-1)
    buf, meta = _dispatch(xg, probs, top_k, C)              # (G, E, C, d)
    buf = constrain(buf, "batch", "model", None, None)

    gate = gelu(torch.einsum("gecd,edf->gecf", buf, params.w_gate))
    up = torch.einsum("gecd,edf->gecf", buf, params.w_up)
    out_buf = torch.einsum("gecf,efd->gecd", gate * up, params.w_down)
    out_buf = constrain(out_buf, "batch", "model", None, None)
    out = _combine(out_buf.reshape(G, E * C, d), meta, N)

    me = probs.reshape(-1, E).mean(dim=0)
    # expert counts as the reference's .at[].add(1.0): a scatter-add, which
    # DTensor can shard (it has no rule for bincount)
    flat_e = meta[5].reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) \
        / (G * N * top_k)
    aux = E * torch.sum(me * ce)
    return out.reshape(orig_shape), aux
