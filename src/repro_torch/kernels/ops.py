"""Host-facing kernel API, with the reference's signatures
(``repro.kernels.ops``) plus an explicit ``device``.

The placement engines keep their bookkeeping in float64 numpy on the host;
these functions move the operands to ``device`` as float32, call the kernel
wrapper (the CUDA kernel on a card, its plain version on the CPU), and
finish on the host exactly as the reference does: the feasibility test
``feas_margin >= -1e-7`` and the cosine similarity.  ``use_ref`` calls the
plain version on ``device`` instead of the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import congestion as _congestion
from . import fit as _fit
from . import ref

__all__ = ["congestion", "congestion_many", "fit_scores", "fit_scores_many"]

_EPS = 1e-7


def _i32(x, dev):
    return torch.as_tensor(np.asarray(x), dtype=torch.int32).to(dev)


def _f32(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)


def congestion(start, end, w, T: int, use_ref: bool = False, device=None):
    """(T, K) interval congestion; CUDA kernel unless ``use_ref``."""
    dev = resolve_device(device)
    start, end, w = _i32(start, dev), _i32(end, dev), _f32(w, dev)
    if use_ref:
        return ref.congestion_ref(start, end, w, T)
    return _congestion.congestion(start, end, w, T)


def congestion_many(start, end, w, T: int, use_ref: bool = False,
                    device=None):
    """(G, T, K) batched interval congestion; start/end (G, n), w (G, n, K)."""
    dev = resolve_device(device)
    start, end, w = _i32(start, dev), _i32(end, dev), _f32(w, dev)
    if use_ref:
        return ref.congestion_many_ref(start, end, w, T)
    return _congestion.congestion_many(start, end, w, T)


def fit_scores(rem, dem, s: int, e: int, cap, scored: bool = False,
               use_ref: bool = False, device=None):
    """Fit of one task against N open nodes.

    rem: (N, T, D) remaining capacities; dem: (D,); [s, e] the task's span;
    cap: (D,) capacity of the node-type.  Returns (feasible (N,) bool,
    score (N,) float): the cosine similarity of the capacity-normalized
    demand and remaining capacity over the span (zeros unless ``scored``).
    """
    dev = resolve_device(device)
    rem = np.asarray(rem)
    N, T, D = rem.shape
    inv_cap = 1.0 / np.asarray(cap, np.float32)
    rem_t, dem_t, inv_t = _f32(rem, dev), _f32(dem, dev), _f32(inv_cap, dev)
    if use_ref:
        mask = ref.span_mask(torch.tensor([s]), torch.tensor([e]), T)[0]
        out = torch.stack(ref.fit_scores_ref(rem_t, dem_t, mask.to(dev),
                                             inv_t))
    else:
        out = _fit.fit_scores(rem_t, dem_t, s, e, inv_t)
    feas_m, dot, norm2 = out.cpu().numpy()  # one copy back
    feas = feas_m >= -_EPS
    if not scored:
        return feas, np.zeros(N, np.float32)
    span = e - s + 1
    dem_n = np.asarray(dem) / np.asarray(cap)
    dem_norm = float(np.linalg.norm(dem_n)) * np.sqrt(span)
    cos = dot / (dem_norm * np.sqrt(norm2) + 1e-30)
    return feas, cos


def fit_scores_many(rem, dem, s, e, inv_cap, scored: bool = False,
                    use_ref: bool = False, device=None):
    """Batched fit for the lockstep placement engine.

    rem: (B, N, T, D) open-node remaining capacities; dem: (B, D); s, e:
    (B,) inclusive spans; inv_cap: (B, D), 0 on padded dimensions.
    Returns (feasible (B, N) bool, score (B, N) float).
    """
    dev = resolve_device(device)
    rem = np.asarray(rem)
    B, N, T, D = rem.shape
    s = np.asarray(s, np.int64)
    e = np.asarray(e, np.int64)
    rem_t, dem_t, inv_t = _f32(rem, dev), _f32(dem, dev), _f32(inv_cap, dev)
    s_t, e_t = _i32(s, dev), _i32(e, dev)
    if use_ref:
        out = torch.stack(ref.fit_scores_many_ref(
            rem_t, dem_t, ref.span_mask(s_t, e_t, T), inv_t))
    else:
        out = _fit.fit_scores_many(rem_t, dem_t, s_t, e_t, inv_t)
    feas_m, dot, norm2 = out.cpu().numpy()  # one copy back
    feas = feas_m >= -_EPS
    if not scored:
        return feas, np.zeros((B, N), np.float32)
    span = (e - s + 1).astype(np.float64)
    dem_n = np.asarray(dem) * np.asarray(inv_cap)
    dem_norm = np.linalg.norm(dem_n, axis=1) * np.sqrt(span)  # (B,)
    cos = dot / (dem_norm[:, None] * np.sqrt(norm2) + 1e-30)
    return feas, cos
