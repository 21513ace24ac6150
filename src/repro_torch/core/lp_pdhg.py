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
B=1 case.  Two stopping regimes: ``tol=None``, the legacy fixed-step,
fixed-``iters`` loop; and ``tol=<float>``, the PDLP-style engine (adaptive
steps, restarts, early exit once the normalized gap is below ``tol``, with
``iters`` as the cap).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .problem import Problem

__all__ = ["PDHGResult", "PDHGState", "SolveStats", "merge_stats",
           "solve_lp_pdhg"]


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
    zero-padded).  ``eta`` carries the adapted per-lane step size and
    ``omega`` the adapted primal weight, so a warm-started tol-mode solve
    resumes at them (None in legacy mode; ``omega`` None under
    ``omega=False``).  Iterates are in original (unscaled) coordinates and
    float32 whatever the solve's ``precision``."""

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

    iterations: (B,) int — iterations-to-tolerance (== the cap when a
        lane did not converge; == the fixed count in legacy mode).
    restarts:   (B,) int — average-iterate restarts taken per lane.
    kkt:        (B,) float — final normalized duality gap
        (primal - dual) / (1 + |primal| + |dual|), the KKT-residual proxy
        both the restart criterion and the stop rule use.
    converged:  (B,) bool — lane reached ``tol``.
    tol:        the tolerance used (None in legacy fixed-iters mode).
    state:      final ``PDHGState`` for warm-starting a neighbour solve
        (None for all but the last group of a pipelined sweep).
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


def merge_stats(stats_list) -> dict:
    """Aggregate ``SolveStats.summary`` across a warm-started sweep's
    per-group solves into one flat telemetry dict (the concatenated
    batch's summary plus the per-instance lists)."""
    merged = SolveStats(
        iterations=np.concatenate([s.iterations for s in stats_list]),
        restarts=np.concatenate([s.restarts for s in stats_list]),
        kkt=np.concatenate([s.kkt for s in stats_list]),
        converged=np.concatenate([s.converged for s in stats_list]),
        tol=stats_list[0].tol, state=stats_list[0].state,
    )
    return {
        **merged.summary(),
        "iters": [int(i) for i in merged.iterations],
        "restarts": [int(r) for r in merged.restarts],
        "kkt": [float(k) for k in merged.kkt],
    }


def solve_lp_pdhg(problem: Problem, iters: int = 2000,
                  step_scale: float = 0.9, operator: str = "auto",
                  tol: float | None = None, adaptive: bool = True,
                  restart: bool = True, check_every: int | None = None,
                  init: PDHGState | None = None, scaling: str = "ruiz",
                  precision: str = "mixed", omega: bool = True,
                  device=None) -> PDHGResult:
    """Single-instance PDHG solve: the B=1 case of ``solve_lp_many``, on
    ``device`` (None = the CUDA card).  ``tol=None`` runs the legacy
    fixed-``iters`` loop; with ``tol`` set the solve stops once the
    normalized duality gap is below ``tol`` (see ``solve_lp_many`` for
    ``adaptive``, ``restart``, ``check_every`` and the speed knobs
    ``scaling``/``precision``/``omega``, which legacy mode ignores)."""
    from .batch import DEFAULT_CHECK_EVERY, solve_lp_many

    return solve_lp_many([problem], iters=iters, step_scale=step_scale,
                         operator=operator, tol=tol, adaptive=adaptive,
                         restart=restart,
                         check_every=(DEFAULT_CHECK_EVERY
                                      if check_every is None
                                      else check_every),
                         init=init, scaling=scaling, precision=precision,
                         omega=omega, device=device)[0]
