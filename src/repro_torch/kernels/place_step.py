"""Launch wrapper of the compiled placement stepper (``csrc/place_step.cu``).

``sub_phase(pool, w, lens, dem_seq, s_seq, e_seq, dn_seq, capx, cap_rows,
quantum, purchase, similarity, rows)`` runs every attempt step of one
placement sub-phase for A lanes and returns one int32 tensor
``[w (A) | bad (A) | j_rec (L * A)]`` (``split`` cuts it into its three
parts), so the host reads all of it back in one copy; ``pool`` is updated in
place.  The arguments and the result are those of ``ref.sub_phase_ref``.
``rows`` bounds the pool rows any lane can reach: the largest w plus L when
``purchase``, the largest w otherwise; it must not exceed the pool's n_cap.

For CUDA tensors it launches the hand-written kernel (built at first use),
adds one to ``sub_phase.launches`` and, when ``telemetry`` is a dict, stores
there the rows each lane kept in shared memory (``smem_rows``); for CPU
tensors it returns the plain version.  It never falls back: a CUDA build or
launch that fails raises.

Replaces the scan body of ``repro.core.place_step`` with its scorer
``repro.kernels.ops.fit_scores_step``; on the card it is the redesign of the
per-step fit kernel for the compiled path.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref

__all__ = ["sub_phase", "split"]


def _check(pool, w, lens, dem_seq, s_seq, e_seq, dn_seq, capx, cap_rows,
           rows: int):
    if pool.dim() != 3 or dem_seq.dim() != 3:
        raise ValueError(
            f"need pool (A, n_cap, K) and dem_seq (L, A, D), got "
            f"{tuple(pool.shape)} and {tuple(dem_seq.shape)}")
    A, n_cap, K = pool.shape
    L, _, D = dem_seq.shape
    want = {
        "pool": (pool, torch.float64, (A, n_cap, K)),
        "w": (w, torch.int32, (A,)),
        "lens": (lens, torch.int32, (A,)),
        "dem_seq": (dem_seq, torch.float64, (L, A, D)),
        "s_seq": (s_seq, torch.int32, (L, A)),
        "e_seq": (e_seq, torch.int32, (L, A)),
        "dn_seq": (dn_seq, torch.float64, (L, A)),
        "capx": (capx, torch.float64, (A, D)),
        "cap_rows": (cap_rows, torch.float64, (A, D)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != pool.device:
            raise ValueError("all inputs must share one device")
    if D == 0 or K % D:
        raise ValueError(f"K={K} must be a multiple of D={D}")
    if not 0 <= rows <= n_cap:
        raise ValueError(f"rows={rows} must lie in [0, n_cap={n_cap}]")


def split(out, A: int):
    """(w (A,), bad (A,), j_rec (L, A)) views of ``sub_phase``'s result, a
    tensor or its numpy copy."""
    return out[:A], out[A: 2 * A], out[2 * A:].reshape(-1, A)


def sub_phase(pool: torch.Tensor, w: torch.Tensor, lens: torch.Tensor,
              dem_seq: torch.Tensor, s_seq: torch.Tensor,
              e_seq: torch.Tensor, dn_seq: torch.Tensor, capx: torch.Tensor,
              cap_rows: torch.Tensor, quantum: float, purchase: bool,
              similarity: bool, rows: int,
              telemetry: dict | None = None) -> torch.Tensor:
    """One placement sub-phase; ``[w | bad | j_rec]`` int32, pool in place."""
    _check(pool, w, lens, dem_seq, s_seq, e_seq, dn_seq, capx, cap_rows,
           rows)
    if pool.device.type == "cpu":
        return ref.sub_phase_ref(pool, w, lens, dem_seq, s_seq, e_seq,
                                 dn_seq, capx, cap_rows, quantum, purchase,
                                 similarity)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    args = (pool, w, lens, dem_seq, s_seq, e_seq, dn_seq, capx, cap_rows)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("the placement stepper takes contiguous tensors")
    A, n_cap, K = pool.shape
    L, _, D = dem_seq.shape
    if D > 256:
        raise ValueError(f"the placement stepper takes D <= 256, got {D}")
    out = torch.empty(2 * A + L * A, dtype=torch.int32, device=pool.device)
    if A == 0:
        return out
    w_out, bad, j_rec = split(out, A)
    from . import build

    lib = build.load("place_step")
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    smem_rows = ctypes.c_int(0)
    err = lib.place_step_launch(
        *(t.data_ptr() for t in args), float(quantum), w_out.data_ptr(),
        bad.data_ptr(), j_rec.data_ptr(), A, L, n_cap, K, D, int(rows),
        int(purchase), int(similarity), ctypes.addressof(smem_rows), stream)
    if err != 0:
        raise RuntimeError(
            f"placement stepper launch failed: CUDA error {err}")
    sub_phase.launches += 1
    if telemetry is not None:
        telemetry["smem_rows"] = smem_rows.value
    return out


sub_phase.launches = 0
