"""Batched many-instance LP engine: pad-and-stack + one fused PDHG solve.

``pack_problems`` trims every instance's timeline and pads the batch to
common ``(n, m, D, T')`` numpy arrays; ``solve_lp_many`` runs the legacy
fixed-step Chambolle–Pock loop for all B instances at once on one device:
a Python loop of ``iters`` steps over device tensors, each step one forward
congestion apply, one adjoint apply and the two Newton projections, batched
over the whole fleet.

Padding scheme (exact — padded coordinates never perturb real ones):

  * tasks      — zero demand, span [0, 0]: zero weight, zero congestion;
  * node-types — unit capacity, zero operator weight and price
                 ``PAD_COST``, infeasible for every task;
  * dimensions — zero demand over unit capacity: zero weight;
  * timeline   — slots past an instance's trimmed T' have no active task.

The forward map comes in three forms: ``'dense'`` (a mask product through
``torch.matmul``), ``'cumsum'`` (the O((n+T)D) difference-array form) and
``'pallas'`` (the hand-written congestion kernel, named after the
reference's Pallas route).  ``'auto'`` picks dense or cumsum by memory, as
the reference does.  Tolerance mode (``tol=...``) is ROADMAP Queue 1,
item 6, and raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .lp_pdhg import PDHGResult, PDHGState, SolveStats
from .problem import Problem, feasible_types, require_lowered, trim_timeline

__all__ = ["ProblemBatch", "pack_problems", "solve_lp_many", "PAD_COST",
           "OPERATORS", "dispatch_count"]

# Padded node-types carry this price: their operator weight is zero, so they
# add exactly 0 to the primal, but any accidental use would show.
PAD_COST = 1e9

OPERATORS = ("auto", "dense", "cumsum", "pallas")

# Newton steps of the capped-simplex (dual) projection.
_NEWTON_ITERS_Y = 12

# Power iterations for the operator-norm estimate (the step size).
_POWER_ITERS = 12

# 'auto' uses the dense mask product while the (B, n, T') activity mask
# stays below this many elements, else the cumsum form.
_DENSE_ACT_BUDGET = 64 * 1024 * 1024

# Host-level count of solver calls: one per ``solve_lp_many``.
_DISPATCH_COUNT = 0


def dispatch_count() -> int:
    """Number of ``solve_lp_many`` calls so far in this process."""
    return _DISPATCH_COUNT


@dataclasses.dataclass(frozen=True)
class ProblemBatch:
    """B timeline-trimmed instances padded to common (n, m, D, T') shapes.

    problems: the trimmed per-instance ``Problem``s.
    dem: (B, n, D) float64; start, end: (B, n) int32 (padded tasks [0, 0]);
    cap: (B, m, D) float64 (padding 1); cost: (B, m) float64 (padding
    ``PAD_COST``); feas: (B, n, m) bool feasible pairs; task_mask: (B, n)
    and type_mask: (B, m) bool; Tp: the common trimmed timeline length.
    """

    problems: tuple[Problem, ...]
    dem: np.ndarray
    start: np.ndarray
    end: np.ndarray
    cap: np.ndarray
    cost: np.ndarray
    feas: np.ndarray
    task_mask: np.ndarray
    type_mask: np.ndarray
    Tp: int

    @property
    def B(self) -> int:
        return self.dem.shape[0]

    @property
    def n(self) -> int:
        return self.dem.shape[1]

    @property
    def m(self) -> int:
        return self.cap.shape[1]

    @property
    def D(self) -> int:
        return self.dem.shape[2]

    @property
    def shape(self) -> tuple[int, int, int, int]:
        """The common padded (n, m, D, T')."""
        return (self.n, self.m, self.D, self.Tp)

    def weights(self) -> np.ndarray:
        """(B, n, m, D) operator weights dem/cap, zeroed on padding."""
        w = self.dem[:, :, None, :] / self.cap[:, None, :, :]
        return w * self.type_mask[:, None, :, None]


def pack_problems(problems, pad_to=None,
                  assume_trimmed: bool = False) -> ProblemBatch:
    """Trim each instance's timeline, then pad-and-stack the batch.

    ``pad_to=(n, m, D, Tp)`` sets minimum padded dims; ``assume_trimmed``
    skips the (idempotent) per-instance trim.
    """
    problems = list(problems)
    if not problems:
        raise ValueError("pack_problems needs at least one instance")
    trimmed = []
    for p in problems:
        if p.n == 0:
            raise ValueError("cannot batch an empty instance")
        require_lowered(p, "pack_problems")
        trimmed.append(p if assume_trimmed else trim_timeline(p)[0])
    n = max(t.n for t in trimmed)
    m = max(t.m for t in trimmed)
    D = max(t.D for t in trimmed)
    Tp = max(t.T for t in trimmed)
    if pad_to is not None:
        n, m, D, Tp = (max(n, pad_to[0]), max(m, pad_to[1]),
                       max(D, pad_to[2]), max(Tp, pad_to[3]))
    B = len(trimmed)

    dem = np.zeros((B, n, D))
    start = np.zeros((B, n), np.int32)
    end = np.zeros((B, n), np.int32)
    cap = np.ones((B, m, D))
    cost = np.full((B, m), PAD_COST)
    feas = np.zeros((B, n, m), bool)
    task_mask = np.zeros((B, n), bool)
    type_mask = np.zeros((B, m), bool)
    for b, t in enumerate(trimmed):
        dem[b, : t.n, : t.D] = t.dem
        start[b, : t.n] = t.start
        end[b, : t.n] = t.end
        cap[b, : t.m, : t.D] = t.node_types.cap
        cost[b, : t.m] = t.node_types.cost
        feas[b, : t.n, : t.m] = feasible_types(t)
        feas[b, t.n :, : t.m] = True  # zero-demand pad tasks fit anywhere
        task_mask[b, : t.n] = True
        type_mask[b, : t.m] = True
    return ProblemBatch(
        problems=tuple(trimmed), dem=dem, start=start, end=end, cap=cap,
        cost=cost, feas=feas, task_mask=task_mask, type_mask=type_mask,
        Tp=Tp,
    )


# --- projections -----------------------------------------------------------
# Water-filling thresholds by Newton's method on the piecewise-linear
# residual (the reference's arithmetic): starting left of the root the
# iteration is monotone, and with <= m breakpoints it is exact for the task
# simplex after m+1 steps.

def _project_simplex_masked(v, mask):
    """Project rows (last axis) of v onto the unit simplex over mask."""
    neg = torch.finfo(v.dtype).min
    theta = torch.where(mask, v, neg).amax(dim=-1, keepdim=True) - 1.0
    for _ in range(v.shape[-1] + 1):
        r = torch.where(mask, torch.clamp_min(v - theta, 0.0), 0.0).sum(
            dim=-1, keepdim=True)
        k = (mask & (v > theta)).sum(dim=-1, keepdim=True)
        theta = theta + (r - 1.0) / torch.clamp_min(k, 1)
    out = torch.where(mask, torch.clamp_min(v - theta, 0.0), 0.0)
    return out / (out.sum(dim=-1, keepdim=True) + 1e-30)


def _project_capped_simplex_td(y, cap):
    """Project y (B, T', m, D) onto {y >= 0, sum_{t,d} y <= cap} per (b, m);
    cap is (B, 1, m, 1)."""
    y = torch.clamp_min(y, 0.0)
    total = y.sum(dim=(1, 3), keepdim=True)
    theta = torch.zeros_like(total)
    for _ in range(_NEWTON_ITERS_Y):
        r = torch.clamp_min(y - theta, 0.0).sum(dim=(1, 3), keepdim=True)
        k = (y > theta).sum(dim=(1, 3), keepdim=True)
        theta = theta + torch.clamp_min(r - cap, 0.0) / torch.clamp_min(k, 1)
    shrunk = torch.clamp_min(y - theta, 0.0)
    # scale out any Newton residue: keeps sum <= cap exactly, so the dual
    # value stays a certified lower bound
    ssum = shrunk.sum(dim=(1, 3), keepdim=True)
    shrunk = shrunk * (cap / torch.maximum(ssum, cap))
    return torch.where(total <= cap, y, shrunk)


# --- congestion operator, three interchangeable forms ----------------------

def _make_operators(w_all, start, end, Tp: int, operator: str):
    """fwd_all: (B, n, m) -> (B, T', m, D); adj_all: its exact adjoint.

    w_all: (B, n, m, D) float32; start, end: (B, n) int32, all on one
    device.  The adjoint is the cumsum span lookup except under 'dense'.
    """
    B, n, m, D = w_all.shape
    dev = w_all.device

    if operator == "dense":
        t_ids = torch.arange(Tp, dtype=torch.int32, device=dev)
        act_nt = ((start[:, :, None] <= t_ids[None, None, :])
                  & (t_ids[None, None, :] <= end[:, :, None])
                  ).to(w_all.dtype)  # (B, n, T')
        act_tn = act_nt.transpose(1, 2).contiguous()  # (B, T', n)

        def fwd_all(xv):
            xw = (xv[..., None] * w_all).reshape(B, n, m * D)
            return torch.matmul(act_tn, xw).reshape(B, Tp, m, D)

        def adj_all(yv):
            z = torch.matmul(act_nt, yv.reshape(B, Tp, m * D))
            return (z.reshape(B, n, m, D) * w_all).sum(dim=3)
        return fwd_all, adj_all

    s_idx = start.long()
    e_idx = end.long() + 1

    def adj_cumsum(yv):
        # span sums off an exclusive prefix-sum over time: one gather each
        C = torch.cumsum(yv.reshape(B, Tp, m * D), dim=1)
        Cx = torch.cat([torch.zeros_like(C[:, :1]), C], dim=1)
        hi = torch.gather(Cx, 1, e_idx[:, :, None].expand(B, n, m * D))
        lo = torch.gather(Cx, 1, s_idx[:, :, None].expand(B, n, m * D))
        return ((hi - lo).reshape(B, n, m, D) * w_all).sum(dim=3)

    if operator == "cumsum":
        # difference array: +xw at start, -xw past end, prefix-sum over
        # time.  On CUDA the scatter adds are atomics, so their order (and
        # the last bits of the sums) may change from run to run.
        s_sc = s_idx[:, :, None].expand(B, n, m * D)
        e_sc = e_idx[:, :, None].expand(B, n, m * D)

        def fwd_all(xv):
            xw = (xv[..., None] * w_all).reshape(B, n, m * D)
            delta = torch.zeros((B, Tp + 1, m * D), dtype=xw.dtype,
                                device=dev)
            delta.scatter_add_(1, s_sc, xw)
            delta.scatter_add_(1, e_sc, -xw)
            return torch.cumsum(delta[:, :Tp], dim=1).reshape(B, Tp, m, D)
        return fwd_all, adj_cumsum

    if operator == "pallas":
        from ..kernels.congestion import congestion_lp

        # one kernel launch per forward, on the LP's own layouts
        def fwd_all(xv):
            return congestion_lp(start, end, w_all, xv, Tp)
        return fwd_all, adj_cumsum  # adjoint of the same linear map

    raise ValueError(f"unknown operator {operator!r}")


def _power_op_norm(fwd_all, adj_all, feas, power_iters: int):
    """||A||_2 per instance: power iteration on A^T A from the
    (nonnegative, deterministic, padding-invariant) feasibility pattern."""
    v = feas.to(torch.float32)
    norm = torch.ones((feas.shape[0],), dtype=torch.float32,
                      device=feas.device)
    for _ in range(power_iters):
        v2 = adj_all(fwd_all(v))
        norm = torch.sqrt((v2 * v2).sum(dim=(1, 2)))
        v = v2 / (norm[:, None, None] + 1e-30)
    return torch.sqrt(norm)


def _objectives(Ax, y, adj_all, cost, feas):
    """(primal, dual, normalized gap) per lane, from a forward apply."""
    primal = (cost * Ax.amax(dim=(1, 3))).sum(dim=1)
    wty = torch.where(feas, adj_all(y), torch.inf)
    dual = wty.amin(dim=2).sum(dim=1)
    rel = (primal - dual) / (1.0 + primal.abs() + dual.abs())
    return primal, dual, rel


def _pdhg_run_many(w_all, start, end, feas, cost, step_scale: float,
                   iters: int, Tp: int, operator: str = "cumsum",
                   power_iters: int = _POWER_ITERS, x0=None, y0=None):
    """The legacy fixed-step loop: ``iters`` Chambolle–Pock steps on device
    tensors.  Returns (x, y, primal, dual, rel_gap) as tensors."""
    fwd_all, adj_all = _make_operators(w_all, start, end, Tp, operator)
    op_norm = _power_op_norm(fwd_all, adj_all, feas, power_iters)
    tau = (step_scale / (op_norm + 1e-30))[:, None, None]  # vs (B, n, m)
    sigma = tau[..., None]                                 # vs (B, T', m, D)
    cap = cost[:, None, :, None]

    if x0 is None:
        x = feas.to(torch.float32)
        x = x / x.sum(dim=2, keepdim=True)
    else:
        x = _project_simplex_masked(x0, feas)
    if y0 is None:
        B, n, m, D = w_all.shape
        y = torch.zeros((B, Tp, m, D), dtype=torch.float32,
                        device=w_all.device)
    else:
        y = _project_capped_simplex_td(y0, cap)

    x_prev = x
    for _ in range(iters):
        x_bar = 2.0 * x - x_prev
        y = _project_capped_simplex_td(y + sigma * fwd_all(x_bar), cap)
        x_prev, x = x, _project_simplex_masked(x - tau * adj_all(y), feas)

    primal, dual, rel_gap = _objectives(fwd_all(x), y, adj_all, cost, feas)
    return x, y, primal, dual, rel_gap


def _align_state(state: PDHGState, batch: ProblemBatch):
    """Crop / zero-pad a previous solve's iterates to this batch's padded
    shape (lane b starts lane b)."""
    if state.B != batch.B:
        raise ValueError(
            f"warm start needs matching batch sizes, got state B={state.B} "
            f"vs batch B={batch.B}")
    x0 = np.zeros((batch.B, batch.n, batch.m), np.float32)
    n_c = min(state.x.shape[1], batch.n)
    m_c = min(state.x.shape[2], batch.m)
    x0[:, :n_c, :m_c] = state.x[:, :n_c, :m_c]
    y0 = np.zeros((batch.B, batch.Tp, batch.m, batch.D), np.float32)
    T_c = min(state.y.shape[1], batch.Tp)
    D_c = min(state.y.shape[3], batch.D)
    y0[:, :T_c, :m_c, :D_c] = state.y[:, :T_c, :m_c, :D_c]
    return x0, y0


def _resolve_operator(operator: str, batch: ProblemBatch) -> str:
    """The concrete operator form ('auto' resolved by memory footprint)."""
    if operator not in OPERATORS:
        raise ValueError(
            f"operator must be one of {OPERATORS}, got {operator!r}")
    if operator == "auto":
        return ("dense" if batch.B * batch.n * batch.Tp <= _DENSE_ACT_BUDGET
                else "cumsum")
    return operator


def solve_lp_many(problems, iters: int = 2000, step_scale: float = 0.9,
                  operator: str = "auto", tol: float | None = None,
                  init: PDHGState | None = None, full_output: bool = False,
                  device=None):
    """One fused legacy PDHG solve of the mapping LP for B instances.

    ``problems`` is a sequence of ``Problem``s or a ``ProblemBatch``.
    Runs exactly ``iters`` fixed-step iterations on ``device`` (None = the
    CUDA card) and returns one ``PDHGResult`` per instance, sliced back to
    its own (n, m): primal upper bound, certified dual lower bound and the
    argmax-rounded mapping.  ``init`` starts from a previous ``PDHGState``.
    ``full_output=True`` returns ``(results, SolveStats)``.

    ``tol`` (the adaptive, restarted engine) is ROADMAP Queue 1, item 6.
    """
    global _DISPATCH_COUNT
    if tol is not None:
        raise NotImplementedError(
            "tolerance-mode PDHG (tol=...) is not ported yet "
            "(ROADMAP Queue 1, item 6); use tol=None")
    dev = resolve_device(device)
    batch = problems if isinstance(problems, ProblemBatch) \
        else pack_problems(problems)
    operator = _resolve_operator(operator, batch)
    x0 = y0 = None
    if init is not None:
        x0, y0 = (torch.from_numpy(a).to(dev)
                  for a in _align_state(init, batch))
    _DISPATCH_COUNT += 1
    with torch.no_grad():
        out = _pdhg_run_many(
            torch.as_tensor(batch.weights(), dtype=torch.float32).to(dev),
            torch.from_numpy(batch.start).to(dev),
            torch.from_numpy(batch.end).to(dev),
            torch.from_numpy(batch.feas).to(dev),
            torch.as_tensor(batch.cost, dtype=torch.float32).to(dev),
            float(step_scale), iters=iters, Tp=batch.Tp, operator=operator,
            x0=x0, y0=y0)
    x, y, primal, dual, rel_gap = (t.cpu().numpy() for t in out)
    results = []
    for b, t in enumerate(batch.problems):
        x_b = x[b, : t.n, : t.m]
        feas_b = batch.feas[b, : t.n, : t.m]
        mapping = np.where(feas_b, x_b, -1.0).argmax(axis=1).astype(np.int64)
        results.append(PDHGResult(
            x=x_b, objective=float(primal[b]), lower_bound=float(dual[b]),
            gap=float(primal[b] - dual[b]), iters=iters, mapping=mapping,
            x_max=x_b.max(axis=1), kkt=float(rel_gap[b])))
    if not full_output:
        return results
    stats = SolveStats(
        iterations=np.full(batch.B, iters, np.int64),
        restarts=np.zeros(batch.B, np.int64), kkt=rel_gap,
        converged=np.ones(batch.B, bool), tol=None,
        state=PDHGState(x=x.astype(np.float32), y=y.astype(np.float32)))
    return results, stats
