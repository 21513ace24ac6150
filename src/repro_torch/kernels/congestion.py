"""Launch wrappers of the interval-congestion kernel (``csrc/congestion.cu``).

One kernel, two entries:

* ``congestion_many(start, end, w, T)`` returns ``out[g, t, k] = sum_u
  [start_gu <= t <= end_gu] * w[g, u, k]`` as a (G, T, K) float32 tensor:
  the TPU contract of ``repro.kernels.congestion.congestion_many_pallas``;
  ``congestion`` is its G=1 form (``congestion_pallas``).
* ``congestion_lp(start, end, w_all, x, Tp)`` is the LP's whole forward
  apply, ``out[b, t, j, k] = sum_u [start_bu <= t <= end_bu] * x[b, u, j] *
  w_all[b, u, j, k]``, read from and written in the LP's own layouts:
  (B, n) spans, (B, n, m, D) weights, (B, n, m) iterate, (B, T', m, D) out.

For CUDA tensors each entry launches the hand-written kernel (built at
first use) and adds one to ``congestion_many.launches``, the kernel's one
launch counter, and to the launching card's count in ``launches_by_card()``
(the sharded sweep pipeline launches on several cards); for CPU tensors it
returns the plain version (``ref.congestion_many_ref``,
``ref.congestion_lp_ref``).  It never falls
back: a CUDA build or launch that fails raises.  Any number of columns
(m * D, or K) is one launch: past ``PART_FLOATS`` the kernel tiles the
column axis (``column_tiles``).
"""

from __future__ import annotations

import collections

import torch

from . import ref

__all__ = ["congestion_many", "congestion", "congestion_lp", "launch_plan",
           "column_tiles", "launches_by_card", "PART_FLOATS"]

# partial sums one CTA holds (csrc/congestion.cu's kPartFloats): a column
# tile is at most PART_FLOATS // t_tile columns wide
PART_FLOATS = 8192
_MIN_TILE_T = 8  # kMinTileT: fewest slots per time tile once C is tiled


def column_tiles(C: int, T: int) -> tuple[int, int]:
    """(column tile width, column tiles) the kernel's plan takes for C
    columns and T slots: one tile of C while C <= ``PART_FLOATS``, else the
    fewest tiles that keep min(T, 8) slots per time tile, as even as they
    can be (csrc/congestion.cu ``make_plan``; ``launch_plan`` reports the
    built kernel's own)."""
    if C <= PART_FLOATS:
        return C, 1
    widest = PART_FLOATS // min(T, _MIN_TILE_T)
    tiles = -(-C // widest)
    width = -(-C // tiles)
    return width, -(-C // width)


def _check_spans(start, end, lead, what):
    if start.dtype != torch.int32 or end.dtype != torch.int32:
        raise TypeError(
            f"start/end must be int32, got {start.dtype}/{end.dtype}")
    if start.shape != lead or end.shape != lead:
        raise ValueError(
            f"need start/end {tuple(lead)} for {what}, got "
            f"{tuple(start.shape)}, {tuple(end.shape)}")


def _on_card(*tensors) -> bool:
    """False for CPU tensors (take the plain version), True for CUDA
    tensors the kernel takes; raises for anything else."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("the congestion inputs must share one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the congestion kernel takes contiguous tensors")
    return True


_BY_CARD: collections.Counter = collections.Counter()


def launches_by_card() -> dict[int, int]:
    """Launches of either entry per card index since the last
    ``kernels.reset_launch_counts()``."""
    return dict(_BY_CARD)


def _launch(entry, *args, dev):
    from . import build

    lib = build.load("congestion")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"congestion kernel launch failed: CUDA error {err}")
    congestion_many.launches += 1
    _BY_CARD[dev.index] += 1


def congestion_many(start: torch.Tensor, end: torch.Tensor, w: torch.Tensor,
                    T: int) -> torch.Tensor:
    """(G, T, K) float32 congestion of G independent groups."""
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if w.dim() != 3:
        raise ValueError(f"need w (G, n, K), got {tuple(w.shape)}")
    _check_spans(start, end, w.shape[:2], "w (G, n, K)")
    if not _on_card(start, end, w):
        return ref.congestion_many_ref(start, end, w, T)
    G, n, K = w.shape
    out = torch.empty((G, T, K), dtype=torch.float32, device=w.device)
    if G == 0 or T == 0 or K == 0:
        return out.zero_()
    _launch("congestion_many_launch", start.data_ptr(), end.data_ptr(),
            w.data_ptr(), out.data_ptr(), G, n, T, K, dev=w.device)
    return out


congestion_many.launches = 0


def congestion(start, end, w, T: int) -> torch.Tensor:
    """(T, K) congestion of one group: the G=1 launch of ``congestion_many``."""
    return congestion_many(start[None], end[None], w[None], T)[0]


def congestion_lp(start: torch.Tensor, end: torch.Tensor,
                  w_all: torch.Tensor, x: torch.Tensor,
                  Tp: int) -> torch.Tensor:
    """(B, T', m, D) forward apply of the LP's congestion operator at the
    iterate ``x`` (B, n, m): one launch, no copy around it."""
    if w_all.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(
            f"w_all and x must be float32, got {w_all.dtype}/{x.dtype}")
    if w_all.dim() != 4 or x.shape != w_all.shape[:3]:
        raise ValueError(
            f"need w_all (B, n, m, D) and x (B, n, m), got "
            f"{tuple(w_all.shape)}, {tuple(x.shape)}")
    _check_spans(start, end, w_all.shape[:2], "w_all (B, n, m, D)")
    if not _on_card(start, end, w_all, x):
        return ref.congestion_lp_ref(start, end, w_all, x, Tp)
    B, n, m, D = w_all.shape
    out = torch.empty((B, Tp, m, D), dtype=torch.float32,
                      device=w_all.device)
    if B == 0 or Tp == 0 or m == 0 or D == 0:
        return out.zero_()
    _launch("congestion_lp_launch", start.data_ptr(), end.data_ptr(),
            x.data_ptr(), w_all.data_ptr(), out.data_ptr(), B, n, m, D, Tp,
            dev=w_all.device)
    return out


def launch_plan(B: int, n: int, m: int, D: int, T: int,
                lp: bool = True) -> dict:
    """The launch shape the kernel picks for B instances of n tasks, m*D
    columns and T slots (``lp``: the ``congestion_lp`` entry, which also
    stages x; else ``congestion_many`` with m=1, D=K): slots per time tile,
    slots per thread R, slot phases P, cluster size S, task groups W per
    CTA, threads per CTA, staged tasks per chunk, shared bytes, column tile
    width and column tiles.  Needs the built kernel."""
    import ctypes

    from . import build

    info = (ctypes.c_int * 10)()
    err = build.load("congestion").congestion_plan(B, n, m, D, T, int(lp),
                                                   info)
    if err != 0:
        raise ValueError(f"no launch shape for B={B} n={n} m={m} D={D} T={T}")
    keys = ("t_tile", "R", "P", "S", "W", "threads", "chunk", "smem_bytes",
            "c_tile", "c_tiles")
    return dict(zip(keys, info))
