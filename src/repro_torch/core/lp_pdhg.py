"""Matrix-free PDHG (Chambolle–Pock) solver for the mapping LP: result and
state types, and the single-instance entry point.

After eliminating alpha (optimal alpha_B = max_{t,d} congestion), the LP
is the saddle problem

    min_{x in X} max_{y in Y}  sum_B <y_B, W_B(x_B)>

where x is (n, m), a per-task distribution over feasible node-types; y is
(m, T', D) in the scaled simplices {y_B >= 0, sum y_B <= cost(B)}; and
W_B(x_B)[t, d] = sum_{u ~ t} x(u,B) dem(u,d)/cap(B,d) is the interval
congestion operator (the congestion kernel's sum).  The primal objective
F(x) bounds the LP optimum from above and the dual value
G(y) = sum_u min_B (W^T y)(u, B) from below.

The iteration lives in ``repro_torch.core.batch``; ``solve_lp_pdhg`` is its
B=1 case.  This port runs the legacy fixed-step, fixed-``iters`` loop
(``tol=None``); tolerance mode is ROADMAP Queue 1, item 6.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .problem import Problem

__all__ = ["PDHGResult", "PDHGState", "SolveStats", "solve_lp_pdhg"]


@dataclasses.dataclass
class PDHGResult:
    x: np.ndarray          # (n, m)
    objective: float       # primal F(x): upper bound on LP optimum
    lower_bound: float     # dual G(y): certified lower bound on LP optimum
    gap: float
    iters: int             # iterations spent on this instance
    mapping: np.ndarray
    x_max: np.ndarray
    restarts: int = 0      # average-iterate restarts (tol mode only)
    kkt: float = float("nan")  # final normalized duality gap
    converged: bool = True     # always True in legacy mode


@dataclasses.dataclass(frozen=True)
class PDHGState:
    """Final primal/dual iterates of a batched solve, in padded batch
    coordinates: pass as ``solve_lp_many(..., init=state)`` to start the
    next solve from here (lane b starts lane b; shapes are cropped or
    zero-padded).  ``eta``/``omega`` are the tol-mode step state and stay
    None in legacy mode.  Iterates are float32."""

    x: np.ndarray  # (B, n, m) float32
    y: np.ndarray  # (B, T', m, D) float32
    eta: np.ndarray | None = None
    omega: np.ndarray | None = None

    @property
    def B(self) -> int:
        return self.x.shape[0]


@dataclasses.dataclass(frozen=True)
class SolveStats:
    """Per-instance solver telemetry for one batched solve.

    iterations: (B,) int; restarts: (B,) int; kkt: (B,) final normalized
    duality gap; converged: (B,) bool; tol: None in legacy mode; state:
    the final ``PDHGState``.
    """

    iterations: np.ndarray
    restarts: np.ndarray
    kkt: np.ndarray
    converged: np.ndarray
    tol: float | None
    state: PDHGState | None

    def summary(self) -> dict:
        """JSON-ready aggregate row."""
        return {
            "total_iters": int(self.iterations.sum()),
            "median_iters": float(np.median(self.iterations)),
            "max_iters": int(self.iterations.max()),
            "total_restarts": int(self.restarts.sum()),
            "median_kkt": float(np.median(self.kkt)),
            "max_kkt": float(np.max(self.kkt)),
            "converged_frac": float(np.mean(self.converged)),
            "tol": self.tol,
        }


def solve_lp_pdhg(problem: Problem, iters: int = 2000,
                  step_scale: float = 0.9, operator: str = "auto",
                  tol: float | None = None, init: PDHGState | None = None,
                  device=None) -> PDHGResult:
    """Single-instance legacy PDHG solve: the B=1 case of
    ``solve_lp_many``, on ``device`` (None = the CUDA card)."""
    from .batch import solve_lp_many

    return solve_lp_many([problem], iters=iters, step_scale=step_scale,
                         operator=operator, tol=tol, init=init,
                         device=device)[0]
