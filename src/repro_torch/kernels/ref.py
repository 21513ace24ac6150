"""Plain PyTorch versions of the kernels.

Each function computes what its CUDA kernel computes, with the reference
package's formulas (``repro.kernels.ref``), on tensors of any device.  The
kernel wrappers take these for CPU tensors; the tests and ``chip_smoke.py``
hold the kernels against them.  Like the kernels, they are generic over the
trailing feature dimension (D or K).
"""

from __future__ import annotations

import torch

__all__ = ["congestion_ref", "congestion_many_ref", "fit_scores_ref",
           "fit_scores_many_ref", "span_mask"]


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
