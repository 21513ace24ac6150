"""Launch wrappers of the placement fit-scoring kernel (``csrc/fit.cu``).

``fit_scores_many(rem, dem, s, e, inv_cap)`` scores one pending task per
instance against all of that instance's open nodes and returns one
(3, B, N) float32 tensor whose rows are ``feas_margin, dot, rem_norm2``
(so the host reads all three back in one copy):

    feas_margin = min over span, d of rem - dem
    dot         = sum over span, d of (rem * inv_cap) * (dem * inv_cap)
    rem_norm2   = sum over span, d of (rem * inv_cap)^2

``rem`` is (B, N, T, D) float32 in the host's own layout, ``dem`` and
``inv_cap`` are (B, D) float32, and ``s``, ``e`` are (B,) int32 inclusive
spans.  ``fit_scores(rem, dem, s, e, inv_cap)`` is the single-instance form
(rem (N, T, D), integer span), the B=1 launch of the same kernel.

For CUDA tensors each wrapper launches the kernel and adds one to its own
``launches`` count; for CPU tensors it returns the plain version
(``ref.fit_scores_many_ref``).  It never falls back on a failed build or
launch.  Replaces ``repro.kernels.fit.fit_scores_many_pallas`` and
``repro.kernels.fit.fit_scores_pallas``.
"""

from __future__ import annotations

import torch

from . import ref

__all__ = ["fit_scores_many", "fit_scores"]


def _check(rem, dem, inv_cap, lead: tuple):
    for name, t in (("rem", rem), ("dem", dem), ("inv_cap", inv_cap)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != rem.device:
            raise ValueError("all inputs must share one device")
    D = rem.shape[-1]
    if dem.shape != lead + (D,) or inv_cap.shape != lead + (D,):
        raise ValueError(
            f"dem/inv_cap must be {lead + (D,)}, got {tuple(dem.shape)}/"
            f"{tuple(inv_cap.shape)}")


def _cuda_call(rem, *tensors):
    if rem.device.type != "cuda":
        raise ValueError(f"unsupported device {rem.device}")
    if not all(t.is_contiguous() for t in (rem,) + tensors):
        raise ValueError("the fit kernel takes contiguous tensors")
    from . import build

    return build.load("fit"), torch.cuda.current_stream(rem.device).cuda_stream


def fit_scores_many(rem: torch.Tensor, dem: torch.Tensor, s: torch.Tensor,
                    e: torch.Tensor, inv_cap: torch.Tensor):
    """(3, B, N) rows feas_margin, dot, rem_norm2, for one task per instance."""
    if rem.dim() != 4:
        raise ValueError(f"rem must be (B, N, T, D), got {tuple(rem.shape)}")
    B, N, T, D = rem.shape
    _check(rem, dem, inv_cap, (B,))
    if s.shape != (B,) or e.shape != (B,) or s.dtype != torch.int32 \
            or e.dtype != torch.int32 or s.device != rem.device \
            or e.device != rem.device:
        raise ValueError("s and e must be (B,) int32 on rem's device")
    if rem.device.type == "cpu":
        return torch.stack(ref.fit_scores_many_ref(
            rem, dem, ref.span_mask(s, e, T), inv_cap))
    lib, stream = _cuda_call(rem, dem, inv_cap, s, e)
    out = torch.empty((3, B, N), dtype=torch.float32, device=rem.device)
    feas, dot, norm = out
    if B == 0 or N == 0:
        return out
    err = lib.fit_scores_many_launch(
        rem.data_ptr(), dem.data_ptr(), inv_cap.data_ptr(), s.data_ptr(),
        e.data_ptr(), feas.data_ptr(), dot.data_ptr(), norm.data_ptr(),
        B, N, T, D, stream)
    if err != 0:
        raise RuntimeError(f"fit kernel launch failed: CUDA error {err}")
    fit_scores_many.launches += 1
    return out


fit_scores_many.launches = 0


def fit_scores(rem: torch.Tensor, dem: torch.Tensor, s: int, e: int,
               inv_cap: torch.Tensor):
    """(3, N) rows feas_margin, dot, rem_norm2, for one task."""
    if rem.dim() != 3:
        raise ValueError(f"rem must be (N, T, D), got {tuple(rem.shape)}")
    N, T, D = rem.shape
    _check(rem, dem, inv_cap, ())
    s, e = int(s), int(e)
    if rem.device.type == "cpu":
        mask = ref.span_mask(torch.tensor([s]), torch.tensor([e]), T)[0]
        return torch.stack(ref.fit_scores_ref(rem, dem, mask, inv_cap))
    lib, stream = _cuda_call(rem, dem, inv_cap)
    out = torch.empty((3, N), dtype=torch.float32, device=rem.device)
    feas, dot, norm = out
    if N == 0:
        return out
    err = lib.fit_scores_launch(
        rem.data_ptr(), dem.data_ptr(), inv_cap.data_ptr(), s, e,
        feas.data_ptr(), dot.data_ptr(), norm.data_ptr(), N, T, D, stream)
    if err != 0:
        raise RuntimeError(f"fit kernel launch failed: CUDA error {err}")
    fit_scores.launches += 1
    return out


fit_scores.launches = 0
