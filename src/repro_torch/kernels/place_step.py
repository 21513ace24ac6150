"""Launch wrappers of the placement steppers (``csrc/place_step.cu``).

``sub_phase(pool, w, lens, dem_seq, s_seq, e_seq, dn_seq, capx, cap_rows,
quantum, purchase, similarity, rows)`` runs every attempt step of one
placement sub-phase for A lanes and returns one int32 tensor
``[w (A) | bad (A) | j_rec (L * A)]`` (``split`` cuts it into its three
parts), so the host reads all of it back in one copy; ``pool`` is updated in
place.  The arguments and the result are those of ``ref.sub_phase_ref``.
``rows`` bounds the pool rows any lane can reach: the largest w plus L when
``purchase``, the largest w otherwise; it must not exceed the pool's n_cap.
It replaces the scan body of ``repro.core.place_step`` with its scorer
``repro.kernels.ops.fit_scores_step``; on the card it is the redesign of the
per-step fit kernel for the compiled path.

``two_phase_walk(walk, bounds, cap, dem, start, end, dn, T, quantum,
similarity, sequential, rows)`` runs one instance's whole ``two_phase``
placement, every node-type's own pack and cross-fill, and returns one int32
tensor ``[w (P) | bad (P) | steps (P) | phase (n) | node (n)]``
(``split_walk`` cuts it); the arguments and the result are those of
``ref.two_phase_ref``.  ``rows`` bounds the nodes a phase may buy (the
longest own part of the walk is always enough); a phase that needs more
stops with bad = -2, and the wrapper then raises ``ValueError``, after one
copy of the P bad entries to the host.  It replaces, on the
single-instance path, the per-task loop of ``repro.core.placement.two_phase``
whose scorer is ``repro.kernels.fit.fit_scores_pallas``: one launch per
call instead of one per attempted task.

For CUDA tensors each wrapper launches its kernel entry (built at first
use), adds one to its own ``launches`` count and, when ``telemetry`` is a
dict, stores there the pool rows each CTA kept in shared memory
(``smem_rows``; rows past it are read and written in device memory); for
CPU tensors it returns the plain version.  Both kernels take any D.  They
never fall back: a CUDA build or launch that fails raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref

__all__ = ["sub_phase", "split", "two_phase_walk", "split_walk"]


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


def _check_walk(walk, bounds, cap, dem, start, end, dn, T: int, rows: int):
    if cap.dim() != 2 or dem.dim() != 2 or walk.dim() != 1:
        raise ValueError(
            f"need walk (E,), cap (P, D) and dem (n, D), got "
            f"{tuple(walk.shape)}, {tuple(cap.shape)} and {tuple(dem.shape)}")
    P, D = cap.shape
    n = dem.shape[0]
    want = {
        "walk": (walk, torch.int32, tuple(walk.shape)),
        "bounds": (bounds, torch.int32, (P, 3)),
        "cap": (cap, torch.float64, (P, D)),
        "dem": (dem, torch.float64, (n, D)),
        "start": (start, torch.int32, (n,)),
        "end": (end, torch.int32, (n,)),
        "dn": (dn, torch.float64, (n,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != dem.device:
            raise ValueError("all inputs must share one device")
    if P == 0 or D == 0 or T <= 0:
        raise ValueError(f"need P, D and T >= 1, got {P}, {D} and {T}")
    if rows < 0:
        raise ValueError(f"rows={rows} must be >= 0")


def split_walk(out, P: int, n: int):
    """(w (P,), bad (P,), steps (P,), phase (n,), node (n,)) views of
    ``two_phase_walk``'s result, a tensor or its numpy copy."""
    return (out[:P], out[P: 2 * P], out[2 * P: 3 * P],
            out[3 * P: 3 * P + n], out[3 * P + n: 3 * P + 2 * n])


def two_phase_walk(walk: torch.Tensor, bounds: torch.Tensor,
                   cap: torch.Tensor, dem: torch.Tensor, start: torch.Tensor,
                   end: torch.Tensor, dn: torch.Tensor, T: int,
                   quantum: float, similarity: bool, sequential: bool,
                   rows: int, telemetry: dict | None = None) -> torch.Tensor:
    """One instance's placement; ``[w | bad | steps | phase | node]``."""
    _check_walk(walk, bounds, cap, dem, start, end, dn, T, rows)
    if dem.device.type == "cpu":
        out = ref.two_phase_ref(walk, bounds, cap, dem, start, end, dn, T,
                                quantum, similarity, sequential, rows)
    else:
        out = _launch_walk(walk, bounds, cap, dem, start, end, dn, T,
                           quantum, similarity, sequential, rows, telemetry)
    P = cap.shape[0]
    short = (out[P: 2 * P].cpu() == -2).nonzero().flatten().tolist()
    if short:
        raise ValueError(f"rows={rows} is below the nodes phases {short} "
                         f"buy")
    return out


def _launch_walk(walk, bounds, cap, dem, start, end, dn, T, quantum,
                 similarity, sequential, rows, telemetry):
    if dem.device.type != "cuda":
        raise ValueError(f"unsupported device {dem.device}")
    args = (walk, bounds, cap, dem, start, end, dn)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("the two_phase kernel takes contiguous tensors")
    P, D = cap.shape
    n = dem.shape[0]
    out = torch.empty(3 * P + 2 * n, dtype=torch.int32, device=dem.device)
    K = T * D
    pool = torch.empty((1 if sequential else P, max(rows, 1), K),
                       dtype=torch.float64, device=dem.device)
    from . import build

    lib = build.load("place_step")
    stream = torch.cuda.current_stream(dem.device).cuda_stream
    smem_rows = ctypes.c_int(0)
    err = lib.two_phase_launch(
        *(t.data_ptr() for t in args), pool.data_ptr(), float(quantum),
        out.data_ptr(), P, n, K, D, int(rows), int(similarity),
        int(sequential), ctypes.addressof(smem_rows), stream)
    if err != 0:
        raise RuntimeError(f"two_phase kernel launch failed: CUDA error {err}")
    two_phase_walk.launches += 1
    if telemetry is not None:
        telemetry["smem_rows"] = smem_rows.value
    return out


two_phase_walk.launches = 0
