"""Published H100 peaks and the least work each measured layer must do.

Every count is what any correct implementation must move for the
instances it was given, counted from their own (trimmed, unpadded) shapes
and never from a kernel's launch arguments: each input byte read once and
each output byte written once.  So a share of a roofline built from these
counts cannot pass 100% unless the time leaves out part of the work.
"""

from __future__ import annotations

from .gen import Instance

# NVIDIA H100 SXM5 80GB data sheet: HBM3 bandwidth and dense rates at the
# full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "tf32": 495e12,
              "bfloat16": 989e12}

F32, F64, I32 = 4, 8, 4


def congestion_apply_bytes(t: Instance) -> int:
    """One forward congestion apply of the mapping LP on trimmed instance
    ``t`` in float32: the iterate x (n, m), the weights' factors (demands
    (n, D) and capacities (m, D)) and the spans (n, 2) read, the congestion
    (T', m, D) written."""
    return (t.n * t.m * F32 + (t.n * t.D + t.m * t.D) * F32
            + 2 * t.n * I32 + t.T * t.m * t.D * F32)


def lp_iteration_bytes(t: Instance) -> int:
    """One PDHG iteration: a forward apply and an adjoint apply (dual y
    (T', m, D) and the same factors and spans read, (n, m) written)."""
    adjoint = (t.T * t.m * t.D * F32 + (t.n * t.D + t.m * t.D) * F32
               + 2 * t.n * I32 + t.n * t.m * F32)
    return congestion_apply_bytes(t) + adjoint


def placement_pass_bytes(t: Instance) -> int:
    """One greedy placement pass over trimmed instance ``t`` on the card:
    every task's float64 demand and its span read once and its node
    written once.  The pools' rows are left out: how many nodes a pass
    opens is a decision the fleet path does not report."""
    return t.n * (t.D * F64 + 2 * I32 + I32)


def seconds_at_peak(nbytes: float) -> float:
    """The least time ``nbytes`` take at the HBM3 rate."""
    return nbytes / PEAK_BYTES_PER_S
