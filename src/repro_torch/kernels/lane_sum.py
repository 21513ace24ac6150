"""Launch wrapper of the lane-sum kernel (``csrc/lane_sum.cu``).

``lane_sum(x, dims)`` is ``x.sum(dim=dims, keepdim=True)`` for the two sums
the tol-mode LP makes over one lane's elements: every axis but the first, or
axes (1, 3) of a (B, T', m, D) tensor (``ref.lane_view``), in float32 or
float64.

For CUDA tensors it launches the hand-written kernel (built at first use),
whose order of adds depends only on how many elements an output sums, so a
lane's sum has the same bits in a batch of any size: the sweep pipeline
sharded over cards (``SweepConfig(devices=k)``) solves each card's lanes as
a smaller batch and stays bit-equal to the unsharded run.  Torch's own CUDA
sum takes its launch shape from the whole tensor and does not keep that.
Each launch adds one to ``lane_sum.launches``: one a call, two where an
output sums more than ``CHUNK`` elements (the chunks' sums, then their
sum).  For CPU tensors it returns the plain version (``ref.lane_sum_ref``,
torch's sum, which on the CPU adds a lane alike in any batch).  It never
falls back: a CUDA build or launch that fails raises.
"""

from __future__ import annotations

import torch

from . import ref

__all__ = ["lane_sum", "CHUNK"]

CHUNK = 64 * 256  # elements one block adds: 64 a thread


def _launch(x, out, B, R1, M, R2):
    from . import build

    lib = build.load("lane_sum")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lane_sum_launch(x.data_ptr(), out.data_ptr(), B, R1, M, R2,
                              CHUNK, int(x.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"lane-sum kernel launch failed: CUDA error {err}")
    lane_sum.launches += 1


def lane_sum(x: torch.Tensor, dims) -> torch.Tensor:
    """``x.sum(dim=dims, keepdim=True)`` in an order that does not depend
    on the batch (see the module docstring)."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lane sums take float32 or float64, got {x.dtype}")
    B, R1, M, R2 = ref.lane_view(x.shape, dims)
    if x.device.type == "cpu":
        return ref.lane_sum_ref(x, dims)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    keep = [1 if a in {int(d) % x.dim() for d in dims} else s
            for a, s in enumerate(x.shape)]
    R = R1 * R2
    if B * M == 0 or R == 0:
        return torch.zeros(keep, dtype=x.dtype, device=x.device)
    x = x.contiguous()
    chunks = -(-R // CHUNK)
    if chunks > CHUNK:
        raise ValueError(f"a lane of {R} elements is past {CHUNK ** 2}")
    out = torch.empty(B * M * chunks, dtype=x.dtype, device=x.device)
    _launch(x, out, B, R1, M, R2)
    if chunks > 1:
        part, out = out, torch.empty(B * M, dtype=x.dtype, device=x.device)
        _launch(part, out, B * M, chunks, 1, 1)
    return out.reshape(keep)


lane_sum.launches = 0
