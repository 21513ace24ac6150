"""Launch wrapper of the interval-congestion kernel (``csrc/congestion.cu``).

``congestion_many(start, end, w, T)`` returns ``out[g, t, k] = sum_u
[start_gu <= t <= end_gu] * w[g, u, k]`` as a (G, T, K) float32 tensor on the
inputs' device.  For CUDA tensors it launches the hand-written kernel (built
at first use) and adds one to ``congestion_many.launches``; for CPU tensors
it returns the plain version, ``ref.congestion_many_ref``.  It never falls
back: a CUDA build or launch that fails raises.

Replaces ``repro.kernels.congestion.congestion_many_pallas``; the G=1 form
(``congestion``) is the same launch with one group.
"""

from __future__ import annotations

import torch

from . import ref

__all__ = ["congestion_many", "congestion"]


def _check(start, end, w):
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if start.dtype != torch.int32 or end.dtype != torch.int32:
        raise TypeError(
            f"start/end must be int32, got {start.dtype}/{end.dtype}")
    if w.dim() != 3 or start.shape != w.shape[:2] or end.shape != w.shape[:2]:
        raise ValueError(
            f"need start/end (G, n) and w (G, n, K), got {tuple(start.shape)}"
            f", {tuple(end.shape)}, {tuple(w.shape)}")
    if not (start.device == end.device == w.device):
        raise ValueError("start, end and w must share one device")


def congestion_many(start: torch.Tensor, end: torch.Tensor, w: torch.Tensor,
                    T: int) -> torch.Tensor:
    """(G, T, K) float32 congestion of G independent groups."""
    _check(start, end, w)
    if w.device.type == "cpu":
        return ref.congestion_many_ref(start, end, w, T)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    if not (start.is_contiguous() and end.is_contiguous()
            and w.is_contiguous()):
        raise ValueError("the congestion kernel takes contiguous tensors")
    G, n, K = w.shape
    out = torch.empty((G, T, K), dtype=torch.float32, device=w.device)
    if G == 0 or T == 0 or K == 0:
        return out.zero_()
    from . import build

    lib = build.load("congestion")
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.congestion_many_launch(
        start.data_ptr(), end.data_ptr(), w.data_ptr(), out.data_ptr(),
        G, n, T, K, stream)
    if err != 0:
        raise RuntimeError(f"congestion kernel launch failed: CUDA error {err}")
    congestion_many.launches += 1
    return out


congestion_many.launches = 0


def congestion(start, end, w, T: int) -> torch.Tensor:
    """(T, K) congestion of one group: the G=1 launch of ``congestion_many``."""
    return congestion_many(start[None], end[None], w[None], T)[0]
