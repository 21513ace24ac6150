"""Node-type cost models (paper §VI-A, Eq. 8):

    cost(B) = sum_d c_d * cap(B, d)^e

* homogeneous linear: c_d = 1, e = 1.
* heterogeneous: random c_d in [0.3, 1.0], exponent e in {1/3 .. 3}.
* GCE-like: per-dimension coefficients shaped like Google Compute Engine
  on-demand pricing (vCPU-hour dominates, memory-GB secondary), e = 1 —
  the paper's Fig. 10 setting [32].
"""

from __future__ import annotations

import numpy as np

__all__ = ["homogeneous_cost", "heterogeneous_cost", "gce_like_cost"]


def homogeneous_cost(cap: np.ndarray) -> np.ndarray:
    return cap.sum(axis=1)


def heterogeneous_cost(
    cap: np.ndarray,
    e: float = 1.0,
    rng: np.random.Generator | None = None,
    coeff_range: tuple[float, float] = (0.3, 1.0),
) -> np.ndarray:
    # deterministic default: no rng -> a fixed-seed generator, so the
    # coefficients are reproducible and global NumPy state is untouched
    # (callers that want per-instance coefficients pass their own rng,
    # e.g. synthetic_instance threads its spec-seeded generator here)
    rng = rng if rng is not None else np.random.default_rng(0)
    c = rng.uniform(*coeff_range, size=cap.shape[1])
    return (c[None, :] * cap**e).sum(axis=1)


# GCE n2 on-demand-like ratios: ~$0.031/vCPU-h vs ~$0.0042/GB-h, rescaled so
# a "full" (cap = 1.0 normalized) node costs O(1) like the synthetic model.
_GCE_COEFF_2D = np.array([0.88, 0.12])


def gce_like_cost(cap: np.ndarray, e: float = 1.0) -> np.ndarray:
    if cap.shape[1] != 2:
        raise ValueError("gce_like_cost expects D=2 (cpu, memory)")
    return (_GCE_COEFF_2D[None, :] * cap**e).sum(axis=1) * 2.0
