"""Plain PyTorch versions of the kernels.

Each function computes what its CUDA kernel computes, with the reference
package's formulas (``repro.kernels.ref``), on tensors of any device.  The
kernel wrappers take these for CPU tensors; the tests and ``chip_smoke.py``
hold the kernels against them.  Like the kernels, they are generic over the
trailing feature dimension (D or K).
"""

from __future__ import annotations

import torch

__all__ = ["congestion_ref", "congestion_many_ref", "congestion_lp_ref",
           "fit_scores_ref", "fit_scores_many_ref", "span_mask",
           "sub_phase_ref"]

_EPS = 1e-7  # the placement engines' feasibility slack


def congestion_ref(start, end, w, T: int):
    """out[t, k] = sum_u [start_u <= t <= end_u] * w[u, k].

    start, end: (n,) integer inclusive slots; w: (n, K) float; out: (T, K).
    """
    return congestion_many_ref(start[None], end[None], w[None], T)[0]


def congestion_many_ref(start, end, w, T: int):
    """out[g, t, k] = sum_u [start_gu <= t <= end_gu] * w[g, u, k].

    start, end: (G, n) integer; w: (G, n, K); out: (G, T, K).
    """
    t = torch.arange(T, device=w.device, dtype=start.dtype)
    mask = ((start[:, None, :] <= t[None, :, None])
            & (t[None, :, None] <= end[:, None, :]))  # (G, T, n)
    return torch.bmm(mask.to(w.dtype), w)


def congestion_lp_ref(start, end, w_all, x, T: int):
    """out[b, t, j, k] = sum_u [start_bu <= t <= end_bu] * x[b,u,j] *
    w_all[b,u,j,k]: the LP's forward apply, as B*m groups of D columns.

    start, end: (B, n) integer; w_all: (B, n, m, D); x: (B, n, m); out:
    (B, T, m, D), a permuted view (the reference's operator="pallas"
    expression, step for step).
    """
    B, n, m, D = w_all.shape
    start_g = start.repeat_interleave(m, dim=0)
    end_g = end.repeat_interleave(m, dim=0)
    w_g = w_all.permute(0, 2, 1, 3).reshape(B * m, n, D)
    x_g = x.permute(0, 2, 1).reshape(B * m, n)
    cong = congestion_many_ref(start_g, end_g, w_g * x_g[:, :, None], T)
    return cong.reshape(B, m, T, D).permute(0, 2, 1, 3)


def span_mask(s, e, T: int, dtype=torch.float32):
    """(B, T) mask, 1 inside each row's inclusive span [s_b, e_b]."""
    t = torch.arange(T, device=s.device)
    return ((s[:, None] <= t[None, :]) & (t[None, :] <= e[:, None])).to(dtype)


def fit_scores_ref(rem, dem, mask, inv_cap):
    """Fit scoring of one task against N open nodes.

    rem: (N, T, D); dem: (D,); mask: (T,) 1 inside the span; inv_cap: (D,).
    Returns (feas_margin, dot, rem_norm2), each (N,):
      feas_margin = min over span, d of rem - dem   (feasible iff >= -eps)
      dot         = sum over span, d of (rem/cap) * (dem/cap)
      rem_norm2   = sum over span, d of (rem/cap)^2
    """
    out = fit_scores_many_ref(rem[None], dem[None], mask[None], inv_cap[None])
    return tuple(o[0] for o in out)


def fit_scores_many_ref(rem, dem, mask, inv_cap):
    """Batched fit scoring: one task per instance against its N nodes.

    rem: (B, N, T, D); dem: (B, D); mask: (B, T); inv_cap: (B, D), 0 on
    padded dims.  Returns (feas_margin, dot, rem_norm2), each (B, N).
    """
    big = torch.finfo(rem.dtype).max
    margin = rem - dem[:, None, None, :]
    inside = (mask > 0)[:, None, :, None]
    feas_margin = torch.where(inside, margin, big).amin(dim=(2, 3))
    rem_n = rem * inv_cap[:, None, None, :]
    dem_n = dem * inv_cap
    dot = torch.einsum("bntd,bd,bt->bn", rem_n, dem_n, mask)
    rem_norm2 = torch.einsum("bntd,bntd,bt->bn", rem_n, rem_n, mask)
    return feas_margin, dot, rem_norm2


def sub_phase_ref(pool, w, lens, dem_seq, s_seq, e_seq, dn_seq, capx,
                  cap_rows, quantum: float, purchase: bool,
                  similarity: bool):
    """One placement sub-phase, step by step: the compiled stepper's scan
    body (``repro.core.place_step``) as a Python loop over attempt steps,
    every lane at once, in float64.

    pool: (A, n_cap, K) remaining capacity of each lane's nodes, slot
    k = t * D + d, every row cap-initialized; updated in place.  w, lens:
    (A,) int32 open-node counts and attempt-list lengths.  dem_seq (L, A, D)
    float64, s_seq / e_seq (L, A) int32 inclusive spans, dn_seq (L, A)
    float64 demand norms.  capx (A, D) capacity, +inf on padded dims;
    cap_rows (A, D) capacity with 1.0 on padded dims.

    Returns one int32 tensor ``[w (A) | bad (A) | j_rec (L * A)]``: the
    final open-node counts, each lane's first step whose task cannot fit
    the node-type (-1 = none), and the (L, A) pool-local node each step
    placed into (-1 = no placement).
    """
    A, n_cap, K = pool.shape
    L, _, D = dem_seq.shape
    T = K // D
    dev = pool.device
    out = torch.full((2 * A + L * A,), -1, dtype=torch.int32, device=dev)
    j_rec = out[2 * A:].view(L, A)
    w = w.to(torch.int64)
    bad = torch.full((A,), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(A, device=dev)
    node_ids = torch.arange(n_cap, device=dev)
    t_ids = torch.arange(T, device=dev)
    capx_k = capx.repeat(1, T)
    for step in range(L):
        active = step < lens
        dem = dem_seq[step]
        dem_k = dem.repeat(1, T)
        span = ((s_seq[step][:, None] <= t_ids)
                & (t_ids <= e_seq[step][:, None]))
        span_k = span.repeat_interleave(D, dim=1)
        thr = dem_k - _EPS
        viol = ((pool < thr[:, None, :]) & span_k[:, None, :]).any(dim=2)
        feas = ~viol & (node_ids < w[:, None]) & active[:, None]
        has = feas.any(dim=1)
        if similarity:
            span_f = span_k.to(pool.dtype)
            rem_n = pool / capx_k[:, None, :]
            q = (dem_k / capx_k) * span_f
            dot = (rem_n * q[:, None, :]).sum(dim=2)
            rm = rem_n * span_f[:, None, :]
            norm2 = (rm * rm).sum(dim=2)
            score = dot / (dn_seq[step][:, None] * torch.sqrt(norm2) + 1e-30)
            score = torch.round(score * quantum) / quantum
            choice = torch.where(feas, score, -torch.inf).argmax(dim=1)
        else:
            choice = feas.to(torch.int8).argmax(dim=1)
        if purchase:
            buy = ~has & active
            bad_now = buy & (dem > cap_rows + _EPS).any(dim=1)
            bad = torch.where(bad_now & (bad < 0), step, bad)
            j = torch.where(has, choice, w)
            placed = active
            w = w + buy.to(torch.int64)
        else:
            j = choice
            placed = has
        rows, cols = lanes[placed], j[placed]
        pool[rows, cols] -= (dem_k * span_k.to(pool.dtype))[placed]
        j_rec[step] = torch.where(placed, j, -1).to(torch.int32)
    out[:A] = w.to(torch.int32)
    out[A: 2 * A] = bad.to(torch.int32)
    return out
