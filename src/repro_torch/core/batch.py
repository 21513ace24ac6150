"""Batched many-instance LP engine: pad-and-stack + one fused PDHG solve.

``pack_problems`` trims every instance's timeline and pads the batch to
common ``(n, m, D, T')`` numpy arrays; ``solve_lp_many`` solves the mapping
LP of all B instances at once on one device, in one of two regimes:

  * ``tol=None`` — the legacy fixed-step Chambolle–Pock loop: a Python loop
    of ``iters`` steps over device tensors, each one forward congestion
    apply, one adjoint apply and the two Newton projections;
  * ``tol=<float>`` — the PDLP-style engine (``_tol_core``): per-lane
    adaptive steps by the backtracking ratio test, average-iterate
    restarts on a normalized duality-gap criterion, a convergence mask that
    freezes converged lanes while stragglers iterate, Ruiz equilibration
    (``scaling='ruiz'``), primal-weight balancing (``omega=True``) and an
    f32 iterate with an f64 certificate and a final f64 polish
    (``precision='mixed'``; ``'f64'`` iterates in f64).  The reference's
    ``lax.while_loop`` is a host loop over chunks of ``check_every``
    attempts: no host read inside a chunk, one per convergence check.

``_sweep_impl`` chains warm-started solves over a grid-adjacent sequence of
instance groups; ``pipeline=True`` runs that chain as one host call with
every group's state kept on the device, its lanes sharded over several
cards with ``devices``.

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
the reference does.  The kernel is float32: ``precision='f64'`` and the
f64 polish take the cumsum form instead, as the reference does.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import warnings

import numpy as np
import torch

from .. import kernels, obs
from ..device import resolve_device
from ..kernels import lane_sum as klane
from .lp_pdhg import PDHGResult, PDHGState, SolveStats
from .problem import Problem, feasible_types, require_lowered, trim_timeline

__all__ = ["ProblemBatch", "pack_problems", "solve_lp_many",
           "solve_lp_sweep", "PAD_COST", "OPERATORS", "DEFAULT_TOL",
           "DEFAULT_CHECK_EVERY", "SCALINGS", "PRECISIONS",
           "CANONICAL_MARGIN", "dispatch_count"]

# Padded node-types carry this price: their operator weight is zero, so they
# add exactly 0 to the primal, but any accidental use would show.
PAD_COST = 1e9

OPERATORS = ("auto", "dense", "cumsum", "pallas")

# Default normalized-duality-gap tolerance of the adaptive engine: a 0.5%
# certified relative gap.
DEFAULT_TOL = 5e-3

# Default convergence-check cadence of the tol-mode engine: iteration
# counts quantize to this interval.
DEFAULT_CHECK_EVERY = 25

# Valid values of the tol-mode speed-layer knobs.
SCALINGS = ("none", "ruiz")
PRECISIONS = ("f64", "mixed")

# Ruiz equilibration sweeps.
_RUIZ_ITERS = 8

# Primal-weight clip: omega = 1 is the symmetric tau = sigma = eta split.
_OMEGA_CLIP = 1e2

# Plain PDHG steps of precision='mixed''s final f64 polish, kept per lane
# only where they tighten the certified gap.
_POLISH_ITERS = 10

# Canonical-rounding margin: a type whose relaxed mass is within this of
# the task's row max is epsilon-optimal-equivalent, and the cheapest (then
# lowest-index) of those wins, so solves that agree to tolerance round alike.
CANONICAL_MARGIN = 0.05

# Restart once the best of {current, average} iterate brings the normalized
# gap below this factor of the gap at the last restart.
_RESTART_BETA = 0.5

# Adaptive step-size clip around the power-iteration step.
_ETA_CLIP = 1e4

# Newton steps of the capped-simplex (dual) projection.
_NEWTON_ITERS_Y = 12

# Power iterations for the operator-norm estimate (the step size).
_POWER_ITERS = 12

# 'auto' uses the dense mask product while the (B, n, T') activity mask
# stays below this many elements, else the cumsum form.
_DENSE_ACT_BUDGET = 64 * 1024 * 1024

# Host-level count of solver calls: one per ``solve_lp_many`` and one per
# pipelined sweep.
_DISPATCH_COUNT = 0


def dispatch_count() -> int:
    """Number of LP solver calls so far in this process (each
    ``solve_lp_many`` and each pipelined sweep counts one)."""
    return _DISPATCH_COUNT


def _count_dispatch() -> None:
    global _DISPATCH_COUNT
    _DISPATCH_COUNT += 1


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

def _project_simplex_masked(v, mask, mass=None):
    """Project rows (last axis) of v onto the simplex over mask.

    ``mass`` (e.g. (B, n)) sets a per-row target sum instead of 1: the
    Ruiz-scaled primal set, where task u's row carries mass c_u.
    ``mass=None`` keeps the unit-simplex arithmetic bit-identical."""
    neg = torch.finfo(v.dtype).min
    s = 1.0 if mass is None else mass[..., None]
    theta = torch.where(mask, v, neg).amax(dim=-1, keepdim=True) - s
    for _ in range(v.shape[-1] + 1):
        r = torch.where(mask, torch.clamp_min(v - theta, 0.0), 0.0).sum(
            dim=-1, keepdim=True)
        k = (mask & (v > theta)).sum(dim=-1, keepdim=True)
        theta = theta + (r - s) / torch.clamp_min(k, 1)
    out = torch.where(mask, torch.clamp_min(v - theta, 0.0), 0.0)
    if mass is None:
        return out / (out.sum(dim=-1, keepdim=True) + 1e-30)
    return out * (s / (out.sum(dim=-1, keepdim=True) + 1e-30))


def _plain_sums(v, dims):
    """``v.sum(dim=dims, keepdim=True)``: torch's own sum, which the legacy
    fixed-step path keeps (it is never sharded)."""
    return v.sum(dim=dims, keepdim=True)


def _project_capped_simplex_td(y, cap, sums=_plain_sums):
    """Project y (B, T', m, D) onto {y >= 0, sum_{t,d} y <= cap} per (b, m);
    cap is (B, 1, m, 1).  ``sums(v, (1, 3))`` sums a lane's (T', D): tol
    mode passes the lane-sum kernel (``kernels.lane_sum``), whose order does
    not depend on the batch."""
    y = torch.clamp_min(y, 0.0)
    total = sums(y, (1, 3))
    theta = torch.zeros_like(total)
    for _ in range(_NEWTON_ITERS_Y):
        r = sums(torch.clamp_min(y - theta, 0.0), (1, 3))
        k = (y > theta).sum(dim=(1, 3), keepdim=True)
        theta = theta + torch.clamp_min(r - cap, 0.0) / torch.clamp_min(k, 1)
    shrunk = torch.clamp_min(y - theta, 0.0)
    # scale out any Newton residue: keeps sum <= cap exactly, so the dual
    # value stays a certified lower bound
    ssum = sums(shrunk, (1, 3))
    shrunk = shrunk * (cap / torch.maximum(ssum, cap))
    return torch.where(total <= cap, y, shrunk)


# --- congestion operator, three interchangeable forms ----------------------

def _slot_segments(slot, Tp: int):
    """(order, lengths) of the (B, n) slots in [0, Tp]: each lane's tasks
    stably sorted by slot, and the number of tasks in each of the Tp + 1
    slots."""
    order = torch.sort(slot, dim=1, stable=True).indices
    lengths = torch.zeros((slot.shape[0], Tp + 1), dtype=torch.int64,
                          device=slot.device)
    lengths.scatter_add_(1, slot, torch.ones_like(slot))
    return order, lengths


def _segment_sums(xw, order, lengths):
    """(B, Tp + 1, C) sums of the (B, n, C) rows of each slot, in task
    order."""
    rows = torch.gather(xw, 1, order[:, :, None].expand_as(xw))
    # ``unsafe`` skips the lengths check, a host read: the lengths are the
    # slots' counts, and a chunk captured as a CUDA graph has no host read
    return torch.segment_reduce(rows, "sum", lengths=lengths, axis=1,
                                unsafe=True)


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
            # an f64 certificate's y meets the f32 mask as a wider matmul
            act = act_nt if yv.dtype == act_nt.dtype else act_nt.to(yv.dtype)
            z = torch.matmul(act, yv.reshape(B, Tp, m * D))
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
        # time.  Each slot's adds are one segment of the tasks sorted by
        # slot, summed in task order: the reference's scatter adds, but
        # deterministic on the card, where atomic adds would change the
        # last bits from run to run (and a warm-started sweep would carry
        # them into the next group's trajectory)
        s_seg, e_seg = _slot_segments(s_idx, Tp), _slot_segments(e_idx, Tp)

        def fwd_all(xv):
            xw = (xv[..., None] * w_all).reshape(B, n, m * D)
            delta = _segment_sums(xw, *s_seg) - _segment_sums(xw, *e_seg)
            return torch.cumsum(delta[:, :Tp], dim=1).reshape(B, Tp, m, D)
        return fwd_all, adj_cumsum

    if operator == "pallas":
        from ..kernels.congestion import congestion_lp

        # one kernel launch per forward, on the LP's own layouts
        def fwd_all(xv):
            return congestion_lp(start, end, w_all, xv, Tp)
        return fwd_all, adj_cumsum  # adjoint of the same linear map

    raise ValueError(f"unknown operator {operator!r}")


def _lane_sum(v, sums=_plain_sums):
    """(B,) sums of each lane's elements (every axis but the first)."""
    return sums(v, tuple(range(1, v.dim()))).reshape(v.shape[0])


def _power_op_norm(fwd_all, adj_all, feas, power_iters: int,
                   sums=_plain_sums):
    """||A||_2 per instance: power iteration on A^T A from the
    (nonnegative, deterministic, padding-invariant) feasibility pattern."""
    v = feas.to(torch.float32)
    norm = torch.ones((feas.shape[0],), dtype=torch.float32,
                      device=feas.device)
    for _ in range(power_iters):
        v2 = adj_all(fwd_all(v))
        norm = torch.sqrt(_lane_sum(v2 * v2, sums))
        v = v2 / (norm[:, None, None] + 1e-30)
    return torch.sqrt(norm)


def _ruiz_scalings(w_all, iters: int = _RUIZ_ITERS):
    """Iterated Ruiz equilibration of the packed operator core: per-task
    column scales ``c`` (B, n) and per-type row scales ``r`` (B, m) such
    that ``w * r / c`` has near-unit inf-norms along both.  Time slots and
    demand dimensions share their entry's scale; padded rows (all-zero
    weight) keep scale 1."""
    B, n, m, D = w_all.shape
    c = torch.ones((B, n), dtype=w_all.dtype, device=w_all.device)
    r = torch.ones((B, m), dtype=w_all.dtype, device=w_all.device)
    for _ in range(iters):
        ws = w_all * (r[:, None, :, None] / c[:, :, None, None])
        col = ws.amax(dim=(2, 3))  # (B, n) inf-norm over (m, d)
        row = ws.amax(dim=(1, 3))  # (B, m) inf-norm over (n, d)
        c = c * torch.sqrt(torch.where(col > 0, col, 1.0))
        r = r / torch.sqrt(torch.where(row > 0, row, 1.0))
    return c, r


def _objectives(Ax, y, adj_all, cost, feas, mass=None, dt=None):
    """(primal, dual, normalized gap) per lane, from a forward apply.

    Under Ruiz scaling ``cost`` is the scaled caps ``cost / r`` and
    ``mass`` the task masses ``c``, so both bounds are original-scale
    values.  ``dt`` computes the certificate in a wider dtype than the
    iterate (the mixed-precision f64 certificate)."""
    if dt is not None:
        Ax, y, cost = Ax.to(dt), y.to(dt), cost.to(dt)
    primal = (cost * Ax.amax(dim=(1, 3))).sum(dim=1)
    wty = torch.where(feas, adj_all(y), torch.inf)
    mins = wty.amin(dim=2)
    if mass is not None:
        mins = mass.to(mins.dtype) * mins
    dual = mins.sum(dim=1)
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


# --- adaptive restarted engine (tol mode; PDLP-style) ----------------------

@dataclasses.dataclass
class _TolCarry:
    """The tol-mode iterate and its per-lane bookkeeping (device tensors;
    ``k``, the attempts made, is a host int)."""

    x: torch.Tensor        # (B, n, m) primal iterate (scaled coordinates)
    x_prev: torch.Tensor   # momentum partner
    Ax: torch.Tensor       # (B, T', m, D) cached forward apply of x
    Ax_prev: torch.Tensor
    y: torch.Tensor        # (B, T', m, D) dual iterate (scaled coordinates)
    eta: torch.Tensor      # (B,) per-lane step size (geometric mean)
    omega: torch.Tensor    # (B,) primal weight: tau=eta/omega, sigma=eta*omega
    k: int                 # attempts made, rejected ones included
    iters_b: torch.Tensor  # (B,) int32 per-lane iterations-to-tolerance
    conv: torch.Tensor     # (B,) converged mask: frozen lanes
    restarts_b: torch.Tensor  # (B,) int32
    gap_b: torch.Tensor    # (B,) f64 latest normalized gap per lane
    last_gap: torch.Tensor  # (B,) f64 gap at the last restart
    sum_x: torch.Tensor    # epoch average accumulators (restart mode)
    sum_y: torch.Tensor
    sum_Ax: torch.Tensor
    elen: torch.Tensor     # (B,) epoch length
    dxs: torch.Tensor      # (B,) epoch primal path length (omega estimator)
    dys: torch.Tensor      # (B,) epoch dual path length


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float: the value of the
    reference's typed float32 scalars (``tol``, ``step_scale``, the
    step-size factors), which widen exactly against float64 tensors."""
    return float(np.float32(v))


def _eta_factors(k: int) -> tuple[float, float]:
    """The ratio test's float32 shrink and growth factors at attempt k:
    1 - kk^-0.3 and 1 + kk^-0.6 with kk = float32(k + 2), which starts at 2
    so the shrink factor is never 0."""
    kk = np.float32(k + 2)
    return (float(np.float32(1.0) - kk ** np.float32(-0.3)),
            float(np.float32(1.0) + kk ** np.float32(-0.6)))


def _tol_core(*args, **kwargs):
    """Adaptive restarted PDHG with per-lane tolerance stopping, on device
    tensors (the reference's ``_tol_core``; its jitted one-batch wrapper
    ``_pdhg_run_many_tol`` has no counterpart here, there being no trace):
    ``_tol_steps`` run to its end."""
    return _drive(_tol_steps(*args, **kwargs))


def _drive(steps):
    """Run a generator of solver steps to its end; returns its value."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def _tol_setup(w_all, start, end, feas, cost, step_scale: float, Tp: int,
               operator: str, power_iters: int, scaling: str, precision: str,
               omega_on: bool, x0=None, y0=None, eta_init=None,
               omega_init=None):
    """The tol loop's operands and first carry: (ops, c, fwd_all, adj_all,
    r_sc).  ``ops`` holds the tensors a chunk reads (the scaled weights,
    ``start``, ``end``, ``feas``, the scaled dual caps ``cost_s``, the
    primal masses ``mass``, None unscaled, and the step clips ``eta_lo``,
    ``eta_hi``); ``r_sc`` is the Ruiz row scaling (None unscaled).  Warm
    arrays are in original coordinates."""
    B, n, m, D = w_all.shape
    dev = w_all.device
    # every sum over a lane's elements goes through the lane-sum kernel,
    # whose order does not depend on the batch, so a lane solved in a
    # smaller batch (a shard of the sharded sweep pipeline) keeps its bits
    sums = klane.lane_sum
    it_dt = torch.float64 if precision == "f64" else torch.float32
    cert_dt = torch.float64
    w_all = w_all.to(it_dt)
    cost = cost.to(it_dt)

    if scaling == "ruiz":
        c_sc, r_sc = _ruiz_scalings(w_all)
        ws_all = w_all * (r_sc[:, None, :, None] / c_sc[:, :, None, None])
        cost_s = cost / r_sc   # scaled dual caps (padded types stay huge)
        mass = c_sc            # scaled primal simplex masses
    else:
        ws_all, cost_s, mass, r_sc = w_all, cost, None, None

    fwd_all, adj_all = _make_operators(ws_all, start, end, Tp, operator)
    op_norm = _power_op_norm(fwd_all, adj_all, feas, power_iters,
                             sums).to(it_dt)
    eta0 = step_scale / (op_norm + 1e-30)                     # (B,)
    eta_lo, eta_hi = eta0 / _ETA_CLIP, eta0 * _ETA_CLIP
    cap = cost_s[:, None, :, None]

    x = feas.to(it_dt)
    x = x / x.sum(dim=2, keepdim=True)
    if mass is not None:
        x = x * mass[:, :, None]
    if x0 is not None:
        x = x0.to(it_dt)
        if mass is not None:
            x = x * mass[:, :, None]
        x = _project_simplex_masked(x, feas, mass)
    if y0 is None:
        y = torch.zeros((B, Tp, m, D), dtype=it_dt, device=dev)
    else:
        y = y0.to(it_dt)
        if r_sc is not None:
            y = y / r_sc[:, None, :, None]
        y = _project_capped_simplex_td(y, cap, sums)
    Ax = fwd_all(x)

    eta = eta0
    if eta_init is not None:
        eta = torch.clamp(eta_init.to(it_dt), eta_lo, eta_hi)
    omega = torch.ones((B,), dtype=it_dt, device=dev)
    if omega_on and omega_init is not None:
        omega = torch.clamp(omega_init.to(it_dt), 1.0 / _OMEGA_CLIP,
                            _OMEGA_CLIP)

    zeros_b = torch.zeros((B,), dtype=it_dt, device=dev)
    c = _TolCarry(
        x=x, x_prev=x, Ax=Ax, Ax_prev=Ax, y=y, eta=eta, omega=omega, k=0,
        iters_b=torch.zeros((B,), dtype=torch.int32, device=dev),
        conv=torch.zeros((B,), dtype=torch.bool, device=dev),
        restarts_b=torch.zeros((B,), dtype=torch.int32, device=dev),
        gap_b=torch.full((B,), torch.inf, dtype=cert_dt, device=dev),
        # the normalized gap starts < 1 (the dual of y=0 is 0), so 1.0
        # anchors the first sufficient-decay restart check
        last_gap=torch.ones((B,), dtype=cert_dt, device=dev),
        sum_x=torch.zeros_like(x), sum_y=torch.zeros_like(y),
        sum_Ax=torch.zeros_like(Ax), elen=zeros_b, dxs=zeros_b,
        dys=zeros_b)
    ops = dict(ws_all=ws_all, start=start, end=end, feas=feas, cost_s=cost_s,
               mass=mass, eta_lo=eta_lo, eta_hi=eta_hi)
    return ops, c, fwd_all, adj_all, r_sc


def _tol_chunk_fns(fwd_all, adj_all, ops: dict, tol: float, adaptive: bool,
                   restart: bool, omega_on: bool):
    """(attempt, check) of the tol loop over ``ops`` (``_tol_setup``), each
    acting on a ``_TolCarry``.  ``attempt(c, factors)`` takes the ratio
    test's (shrink, growth) factors of attempt ``c.k`` (``_eta_factors``):
    Python floats in an eager chunk, 0-dim tensors of the iterate's dtype
    holding the same float32 values in a captured one, so every product
    keeps its bits."""
    cost_s, feas, mass = ops["cost_s"], ops["feas"], ops["mass"]
    eta_lo, eta_hi = ops["eta_lo"], ops["eta_hi"]
    B = feas.shape[0]
    dev = feas.device
    sums = klane.lane_sum
    cap = cost_s[:, None, :, None]
    cert_dt = torch.float64

    def attempt(c: _TolCarry, factors) -> None:
        active = ~c.conv
        if omega_on:
            sig = (c.eta * c.omega)[:, None, None, None]
            tau = (c.eta / c.omega)[:, None, None]
        else:
            sig = c.eta[:, None, None, None]
            tau = c.eta[:, None, None]
        # fwd(2x - x_prev) folded through linearity onto the cached applies
        y_c = _project_capped_simplex_td(
            c.y + sig * (2.0 * c.Ax - c.Ax_prev), cap, sums)
        x_c = _project_simplex_masked(c.x - tau * adj_all(y_c), feas, mass)
        Ax_c = fwd_all(x_c)
        dx = x_c - c.x
        dy = y_c - c.y
        dxsq = _lane_sum(dx * dx, sums)
        dysq = _lane_sum(dy * dy, sums)
        if adaptive:
            if omega_on:
                move = 0.5 * (c.omega * dxsq + dysq / c.omega)
            else:
                move = 0.5 * (dxsq + dysq)
            inter = _lane_sum(dy * (Ax_c - c.Ax), sums).abs()
            eta_bar = torch.where(inter > 1e-20,
                                  move / torch.clamp_min(inter, 1e-20),
                                  torch.inf)
            accept = c.eta <= eta_bar
            # a lane with no interaction (eta_bar = inf) must fall through
            # to the growth term, not evaluate inf * factor
            shrink_f, grow_f = factors
            shrink = torch.where(torch.isfinite(eta_bar), eta_bar * shrink_f,
                                 torch.inf)
            eta_next = torch.clamp(torch.minimum(shrink, c.eta * grow_f),
                                   eta_lo, eta_hi)
        else:
            accept = torch.ones((B,), dtype=torch.bool, device=dev)
            eta_next = c.eta
        upd = active & accept
        u3 = upd[:, None, None]
        u4 = upd[:, None, None, None]
        if omega_on:
            c.dxs = c.dxs + torch.where(upd, torch.sqrt(dxsq), 0.0)
            c.dys = c.dys + torch.where(upd, torch.sqrt(dysq), 0.0)
        if restart:
            c.sum_x = c.sum_x + torch.where(u3, x_c, 0.0)
            c.sum_y = c.sum_y + torch.where(u4, y_c, 0.0)
            c.sum_Ax = c.sum_Ax + torch.where(u4, Ax_c, 0.0)
            c.elen = c.elen + upd.to(c.elen.dtype)
        c.x, c.x_prev = torch.where(u3, x_c, c.x), torch.where(u3, c.x,
                                                                c.x_prev)
        c.Ax, c.Ax_prev = torch.where(u4, Ax_c, c.Ax), torch.where(
            u4, c.Ax, c.Ax_prev)
        c.y = torch.where(u4, y_c, c.y)
        c.eta = torch.where(active, eta_next, c.eta)
        c.k += 1
        c.iters_b = c.iters_b + active.to(torch.int32)

    def check(c: _TolCarry) -> None:
        _, _, gap_cur = _objectives(c.Ax, c.y, adj_all, cost_s, feas,
                                    mass=mass, dt=cert_dt)
        gap_new = gap_cur
        if restart:
            den = torch.clamp_min(c.elen, 1.0)
            x_avg = c.sum_x / den[:, None, None]
            y_avg = c.sum_y / den[:, None, None, None]
            Ax_avg = c.sum_Ax / den[:, None, None, None]
            _, _, gap_avg = _objectives(Ax_avg, y_avg, adj_all, cost_s,
                                        feas, mass=mass, dt=cert_dt)
            gap_avg = torch.where(c.elen > 0, gap_avg, torch.inf)
            use_avg = gap_avg < gap_cur
            cand = torch.minimum(gap_avg, gap_cur)
            do_r = (~c.conv) & ((cand <= _RESTART_BETA * c.last_gap)
                                | (cand <= tol))
            a3 = (do_r & use_avg)[:, None, None]
            a4 = (do_r & use_avg)[:, None, None, None]
            c.x = torch.where(a3, x_avg, c.x)
            c.y = torch.where(a4, y_avg, c.y)
            c.Ax = torch.where(a4, Ax_avg, c.Ax)
            r3 = do_r[:, None, None]
            r4 = do_r[:, None, None, None]
            # restarts reset momentum and the epoch average
            c.x_prev = torch.where(r3, c.x, c.x_prev)
            c.Ax_prev = torch.where(r4, c.Ax, c.Ax_prev)
            c.restarts_b = c.restarts_b + do_r.to(torch.int32)
            c.last_gap = torch.where(do_r, cand, c.last_gap)
            c.sum_x = torch.where(r3, 0.0, c.sum_x)
            c.sum_y = torch.where(r4, 0.0, c.sum_y)
            c.sum_Ax = torch.where(r4, 0.0, c.sum_Ax)
            c.elen = torch.where(do_r, 0.0, c.elen)
            if omega_on:
                # PDLP primal-weight update at the restart boundary:
                # log-space smoothing toward the closing epoch's
                # dual/primal path-length ratio, where both moved
                ratio = torch.sqrt(c.dys / torch.clamp_min(c.dxs, 1e-30))
                om_new = torch.clamp(torch.sqrt(c.omega * ratio),
                                     1.0 / _OMEGA_CLIP, _OMEGA_CLIP)
                ok = do_r & (c.dxs > 0) & (c.dys > 0)
                c.omega = torch.where(ok, om_new, c.omega)
                c.dxs = torch.where(do_r, 0.0, c.dxs)
                c.dys = torch.where(do_r, 0.0, c.dys)
            gap_new = torch.where(do_r, cand, gap_cur)
        c.gap_b = torch.where(c.conv, c.gap_b, gap_new)
        c.conv = c.conv | (c.gap_b <= tol)

    return attempt, check


# --- CUDA graphs of tol chunks ---------------------------------------------
# A chunk queues about 330 small launches an attempt from the host, each some
# microseconds of device work, so on a card the host's queueing sets the LP's
# time.  A chunk has a fixed trip count and no host read, so on a CUDA device
# it is captured once as a CUDA graph over fixed buffers and replayed.

# The carry fields a chunk reads and writes (``k`` stays on the host).
_CARRY = tuple(f.name for f in dataclasses.fields(_TolCarry)
               if f.name != "k")

# Chunk keys a device keeps, least recently used out (keys seen once, whose
# graph is not made yet, count too): T' changes from solve to solve in a
# fleet of trace instances, and each graph holds buffers of its own shape.
_GRAPHS_PER_DEVICE = 4


def _eta_table(n: int, dtype, dev) -> torch.Tensor:
    """(n, 2) tensor of ``_eta_factors(k)`` for k < n, in ``dtype``: the
    float32 values the eager chunks use as scalars."""
    rows = np.array([_eta_factors(k) for k in range(n)], np.float32)
    return torch.from_numpy(rows).to(device=dev, dtype=dtype)


def _take_graph(graphs: collections.OrderedDict, key, make):
    """The chunk graph of ``key`` in ``graphs``, or None where the chunk
    runs eagerly: the key's first chunk, the warm-up a capture needs.  On
    the key's next chunk ``make()`` captures its graph; a key whose capture
    raises is dropped.  The newest ``_GRAPHS_PER_DEVICE`` keys stay."""
    g = None
    if key in graphs:
        g = graphs.pop(key)
        if g is None:
            g = make()
    graphs[key] = g
    while len(graphs) > _GRAPHS_PER_DEVICE:
        graphs.popitem(last=False)
    return g


class _DeviceGraphs:
    """A CUDA device's chunk graphs by key (``_take_graph``), the one memory
    pool they share (a chunk's temporaries die inside the chunk, and chunks
    on one device run one after another), the side stream captures run on,
    and the step-factor table by dtype."""

    def __init__(self, dev: torch.device):
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.tables: dict = {}
        self.dev = dev
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(dev)

    def table(self, n: int, dtype) -> torch.Tensor:
        """At least n rows of ``_eta_table`` on this device."""
        t = self.tables.get(dtype)
        if t is None or t.shape[0] < n:
            t = self.tables[dtype] = _eta_table(n, dtype, self.dev)
        return t


_DEVICE_GRAPHS: dict = {}


def _device_graphs(dev: torch.device) -> _DeviceGraphs:
    dg = _DEVICE_GRAPHS.get(dev)
    if dg is None:
        dg = _DEVICE_GRAPHS[dev] = _DeviceGraphs(dev)
    return dg


class _ChunkGraph:
    """One tol chunk (``chunk`` attempts, then the check) over fixed
    buffers: ``ops``, the operands a chunk reads (``_tol_setup``);
    ``carry``, the carry fields it reads and writes in place; ``factors``,
    its attempts' step factors, copied from the device's table before each
    replay.  ``capture`` records the chunk as a CUDA graph and ``run``
    replays it.  ``in_use``: a running solve's operands are loaded."""

    def __init__(self, ops: dict, carry: _TolCarry, chunk: int, Tp: int,
                 operator: str, tol: float, adaptive: bool, restart: bool,
                 omega_on: bool):
        self.ops = {k: None if v is None else torch.empty_like(v)
                    for k, v in ops.items()}
        self.carry = {f: torch.empty_like(getattr(carry, f))
                      for f in _CARRY}
        ws = ops["ws_all"]
        self.factors = torch.empty((chunk, 2), dtype=ws.dtype,
                                   device=ws.device)
        self.chunk, self.Tp, self.operator = chunk, Tp, operator
        self.flags = (tol, adaptive, restart, omega_on)
        self.in_use = False
        self.graph = self.launches = None

    def load(self, ops: dict) -> None:
        """Takes the buffers for one solve and copies its operands in.  A
        solve runs its chunks to the end before the next solve of its key on
        its device starts, so the buffers are free; a graph in use raises."""
        if self.in_use:
            raise RuntimeError(
                "two tol solves of one chunk shape ran at once on one device; "
                "its CUDA graph's buffers hold one solve at a time")
        self.in_use = True
        for k, v in ops.items():
            if v is not None:
                self.ops[k].copy_(v)

    def hold(self, c: _TolCarry) -> None:
        """Points ``c``'s fields at the carry buffers, copying in those held
        elsewhere (after an eager chunk, or from the solve's setup)."""
        for f, buf in self.carry.items():
            v = getattr(c, f)
            if v is not buf:
                buf.copy_(v)
                setattr(c, f, buf)

    def _chunk(self) -> None:
        """The chunk over the buffers, as a capture records it."""
        o = self.ops
        attempt, check = _tol_chunk_fns(
            *_make_operators(o["ws_all"], o["start"], o["end"], self.Tp,
                             self.operator), o, *self.flags)
        c = _TolCarry(k=0, **self.carry)
        for i in range(self.chunk):
            attempt(c, (self.factors[i, 0], self.factors[i, 1]))
        check(c)
        for f, buf in self.carry.items():
            v = getattr(c, f)
            if v is not buf:
                buf.copy_(v)

    def capture(self, pool, stream) -> None:
        """Records the chunk on ``stream`` into ``pool``.  A capture runs
        nothing, so the launches it records leave the kernels' counts, and
        each replay adds them.  (``torch.cuda.graph`` would also empty the
        device's and the pinned host memory's caches before each capture,
        which a new T' brings every solve in a fleet of trace instances.)"""
        graph = torch.cuda.CUDAGraph()
        marks = kernels.launch_marks()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    self._chunk()
                finally:
                    graph.capture_end()
        finally:
            launches = kernels.rewind_launches(marks)
        self.graph, self.launches = graph, launches

    def run(self, table: torch.Tensor, k: int) -> None:
        """The chunk from attempt ``k``: its factors copied in, then the
        graph replayed on its device's current stream."""
        self.factors.copy_(table[k:k + self.chunk])
        with torch.cuda.device(self.factors.device):
            self.graph.replay()
        kernels.add_launches(self.launches)


def _tol_steps(w_all, start, end, feas, cost, step_scale: float, tol: float,
               max_iters: int, check_every: int, Tp: int, operator: str,
               adaptive: bool, restart: bool, power_iters: int, scaling: str,
               precision: str, omega_on: bool, x0=None, y0=None,
               eta_init=None, omega_init=None):
    """The tol-mode solve as a generator: it yields once a chunk's
    launches are queued, just before that chunk's host read, so a caller
    can queue other solves' chunks on other cards first, and returns the
    solve's tensors.

    Chunks of ``min(check_every, max_iters - k)`` attempts run without a
    host read; after each chunk the f64 certificate, the restart test and
    the convergence mask are computed and one host read asks whether every
    lane has converged.  An attempt is one forward and one adjoint apply;
    a rejected one (the ratio test) keeps the iterate, shrinks the lane's
    step and still counts in ``k`` and the lane's iterations.  ``tol`` and
    ``step_scale`` are float32 values (see ``_f32``).  Warm arrays (``x0``,
    ``y0``, ``eta_init``, ``omega_init``) are in original coordinates.

    On a CUDA device a chunk runs as a CUDA graph (``_ChunkGraph``), keyed
    by the shapes, the iterate's dtype, operator, flags, ``tol`` and chunk
    length: a key's first chunk runs eagerly, its next one is captured and
    replayed, and every later one, in this solve or another, replays.  The
    graph runs the same launches on the same values, so every lane's result
    keeps its bits.

    Returns (x, y, primal, dual, rel_gap, iters_b, restarts_b, conv, eta,
    omega) as tensors, x and y in original coordinates.
    """
    with obs.span("lp.setup"):
        B, n, m, D = w_all.shape
        dev = w_all.device
        if operator == "pallas" and precision == "f64":
            operator = "cumsum"  # the kernel is f32; cumsum is the same map
        ops, c, fwd_all, adj_all, r_sc = _tol_setup(
            w_all, start, end, feas, cost, step_scale, Tp, operator,
            power_iters, scaling, precision, omega_on, x0, y0, eta_init,
            omega_init)
        it_dt = c.x.dtype
        attempt, check = _tol_chunk_fns(fwd_all, adj_all, ops, tol, adaptive,
                                        restart, omega_on)
        graphs = _device_graphs(dev) if dev.type == "cuda" else None
        key = (B, n, m, D, Tp, it_dt, operator, adaptive, restart, omega_on,
               scaling, tol)

    def capture(chunk):
        with obs.span("lp.capture"):
            g = _ChunkGraph(ops, c, chunk, Tp, operator, tol, adaptive,
                            restart, omega_on)
            g.capture(graphs.pool, graphs.stream)
        obs.add("lp.graph_captures")
        return g

    held: list[_ChunkGraph] = []
    try:
        while c.k < max_iters:
            # the final chunk shrinks to the remaining budget; no span stays
            # open across the yield (callers interleave several solves)
            chunk = min(check_every, max_iters - c.k)
            with obs.span("lp.enqueue"):
                g = None if graphs is None else _take_graph(
                    graphs.graphs, key + (chunk,), lambda: capture(chunk))
                if g is None:
                    for _ in range(chunk):
                        attempt(c, _eta_factors(c.k))
                    check(c)
                    obs.add("lp.chunks_eager")
                else:
                    if g not in held:
                        g.load(ops)
                        held.append(g)
                    g.hold(c)
                    g.run(graphs.table(max_iters, it_dt), c.k)
                    c.k += chunk
                    obs.add("lp.graph_replays")
            obs.add("lp.attempts", chunk)
            yield
            with obs.span("lp.wait"):
                done = bool(c.conv.all())  # the one host read per check
            if done:
                break
        # the graphs' buffers serve the next solve of their key
        for f in _CARRY:
            v = getattr(c, f)
            if any(v is g.carry[f] for g in held):
                setattr(c, f, v.clone())
    finally:
        for g in held:
            g.in_use = False

    sums = klane.lane_sum
    cert_dt = torch.float64
    ws_all, cost_s, mass = ops["ws_all"], ops["cost_s"], ops["mass"]
    cap = cost_s[:, None, :, None]

    with obs.span("lp.polish"):
        if precision == "mixed":
            # f64 certificate with f64 weights, then a short plain-PDHG polish
            # at the adapted per-lane step split, kept per lane only where it
            # tightens the certified gap
            pol_op = "cumsum" if operator == "pallas" else operator
            fwd64, adj64 = _make_operators(ws_all.to(cert_dt), start, end, Tp,
                                           pol_op)
            x_fin = c.x.to(cert_dt)
            y_fin = c.y.to(cert_dt)
            primal, dual, rel_gap = _objectives(fwd64(x_fin), y_fin, adj64,
                                                cost_s, feas, mass=mass,
                                                dt=cert_dt)
            cap64 = cap.to(cert_dt)
            mass64 = None if mass is None else mass.to(cert_dt)
            if omega_on:
                sig_p = (c.eta * c.omega).to(cert_dt)[:, None, None, None]
                tau_p = (c.eta / c.omega).to(cert_dt)[:, None, None]
            else:
                sig_p = c.eta.to(cert_dt)[:, None, None, None]
                tau_p = c.eta.to(cert_dt)[:, None, None]
            x_p, y_p, x_pr = x_fin, y_fin, x_fin
            for _ in range(_POLISH_ITERS):
                y_p = _project_capped_simplex_td(
                    y_p + sig_p * fwd64(2.0 * x_p - x_pr), cap64, sums)
                x_p, x_pr = _project_simplex_masked(
                    x_p - tau_p * adj64(y_p), feas, mass64), x_p
            p_p, d_p, r_p = _objectives(fwd64(x_p), y_p, adj64, cost_s, feas,
                                        mass=mass, dt=cert_dt)
            better = r_p < rel_gap
            x_fin = torch.where(better[:, None, None], x_p, x_fin)
            y_fin = torch.where(better[:, None, None, None], y_p, y_fin)
            primal = torch.where(better, p_p, primal)
            dual = torch.where(better, d_p, dual)
            rel_gap = torch.where(better, r_p, rel_gap)
        else:
            x_fin, y_fin = c.x, c.y
            primal, dual, rel_gap = _objectives(c.Ax, c.y, adj_all, cost_s,
                                                feas, mass=mass, dt=cert_dt)

        if scaling == "ruiz":
            # back to original coordinates: callers never see the scales
            x_fin = x_fin / mass[:, :, None]
            y_fin = y_fin * r_sc[:, None, :, None]
        return (x_fin, y_fin, primal, dual, rel_gap, c.iters_b, c.restarts_b,
                c.conv, c.eta, c.omega)


def _align_state(state: PDHGState, batch: ProblemBatch):
    """Crop / zero-pad a previous solve's iterates to this batch's padded
    shape (lane b starts lane b); returns (x0, y0, eta, omega), the last two
    None where the state has none.  The projections re-feasibilize
    whatever lands outside the new feasible sets."""
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
    return x0, y0, state.eta, state.omega


def _canonical_mapping(x_b, feas_b, cost_m):
    """Degeneracy-insensitive rounding of an epsilon-optimal LP vertex:
    every feasible type within ``CANONICAL_MARGIN`` of the row max is a
    candidate, and the cheapest (then lowest-index) candidate wins, so two
    solves that agree to tolerance round to the same mapping.  The argmax
    is always a candidate."""
    masked = np.where(feas_b, x_b, -np.inf)
    rowmax = masked.max(axis=1, keepdims=True)
    cand = feas_b & (masked >= rowmax - CANONICAL_MARGIN)
    pick = np.where(cand, cost_m[None, :], np.inf).argmin(axis=1)
    return pick.astype(np.int64)


def _resolve_operator(operator: str, batch: ProblemBatch) -> str:
    """The concrete operator form ('auto' resolved by memory footprint)."""
    if operator not in OPERATORS:
        raise ValueError(
            f"operator must be one of {OPERATORS}, got {operator!r}")
    if operator == "auto":
        return ("dense" if batch.B * batch.n * batch.Tp <= _DENSE_ACT_BUDGET
                else "cumsum")
    return operator


def _check_knobs(scaling: str, precision: str) -> None:
    if scaling not in SCALINGS:
        raise ValueError(
            f"scaling must be one of {SCALINGS}, got {scaling!r}")
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}")


def _device_arrays(batch: ProblemBatch, w_dt, dev, lanes=slice(None)):
    """(weights, start, end, feas, cost) of a packed batch's ``lanes`` on
    ``dev``."""
    return (torch.as_tensor(batch.weights()[lanes], dtype=w_dt).to(dev),
            torch.from_numpy(batch.start[lanes]).to(dev),
            torch.from_numpy(batch.end[lanes]).to(dev),
            torch.from_numpy(batch.feas[lanes]).to(dev),
            torch.as_tensor(batch.cost[lanes], dtype=w_dt).to(dev))


def _tol_result(x_b, feas_b, t: Problem, primal, dual, rel, iters,
                restarts, conv) -> PDHGResult:
    """One lane's tol-mode ``PDHGResult`` (canonical rounding)."""
    return PDHGResult(
        x=x_b, objective=float(primal), lower_bound=float(dual),
        gap=float(primal - dual), iters=int(iters),
        mapping=_canonical_mapping(x_b, feas_b,
                                   np.asarray(t.node_types.cost)),
        x_max=x_b.max(axis=1), restarts=int(restarts), kkt=float(rel),
        converged=bool(conv))


def solve_lp_many(problems, iters: int = 2000, step_scale: float = 0.9,
                  operator: str = "auto", tol: float | None = None,
                  adaptive: bool = True, restart: bool = True,
                  check_every: int = DEFAULT_CHECK_EVERY,
                  init: PDHGState | None = None, full_output: bool = False,
                  scaling: str = "ruiz", precision: str = "mixed",
                  omega: bool = True, device=None):
    """One fused PDHG solve of the mapping LP for B instances on ``device``
    (None = the CUDA card).

    ``problems`` is a sequence of ``Problem``s or a ``ProblemBatch``.
    Returns one ``PDHGResult`` per instance, sliced back to its own
    (n, m): primal upper bound, certified dual lower bound and the rounded
    mapping.

    ``tol=None`` runs the legacy fixed-step loop for exactly ``iters``
    iterations (argmax rounding; ``scaling``/``precision``/``omega`` are
    ignored).  ``tol=<float>`` runs the adaptive restarted engine until
    every lane's normalized duality gap is <= tol, checked every
    ``check_every`` attempts, with ``iters`` as the cap: per-lane adaptive
    steps (``adaptive``), average-iterate restarts (``restart``), Ruiz
    equilibration (``scaling='ruiz'``), primal-weight balancing
    (``omega``) and an f32 iterate with an f64 certificate and polish
    (``precision='mixed'``; ``'f64'`` iterates in f64).  Its mappings use
    canonical rounding (``_canonical_mapping``).

    ``init`` starts from a previous ``PDHGState`` (lane b starts lane b;
    shapes are re-aligned; tol mode also resumes its ``eta``/``omega``).
    ``full_output=True`` returns ``(results, SolveStats)``.
    """
    _check_knobs(scaling, precision)
    dev = resolve_device(device)
    batch = problems if isinstance(problems, ProblemBatch) \
        else pack_problems(problems)
    operator = _resolve_operator(operator, batch)
    warm = None if init is None else _align_state(init, batch)
    _count_dispatch()
    if tol is None:
        with obs.span("lp.setup"):
            x0 = y0 = None
            if warm is not None:
                x0, y0 = (torch.from_numpy(a).to(dev) for a in warm[:2])
            w, s, e, f, cst = _device_arrays(batch, torch.float32, dev)
        with torch.no_grad(), obs.span("lp.enqueue"):
            out = _pdhg_run_many(w, s, e, f, cst, float(step_scale),
                                 iters=iters, Tp=batch.Tp, operator=operator,
                                 x0=x0, y0=y0)
        obs.add("lp.attempts", iters)
        with obs.span("lp.read"):
            x, y, primal, dual, rel_gap = (t.cpu().numpy() for t in out)
        iters_b = np.full(batch.B, iters, np.int64)
        restarts_b = np.zeros(batch.B, np.int64)
        conv = np.ones(batch.B, bool)
        eta_np = omega_np = None
    else:
        with obs.span("lp.setup"):
            x0 = y0 = eta_init = omega_init = None
            if warm is not None:
                x0, y0 = (torch.from_numpy(a).to(dev) for a in warm[:2])
                if warm[2] is not None:
                    eta_init = torch.tensor(warm[2], dtype=torch.float32,
                                            device=dev)
                if warm[3] is not None:
                    omega_init = torch.tensor(warm[3], dtype=torch.float32,
                                              device=dev)
            w_dt = torch.float64 if precision == "f64" else torch.float32
            arrays = _device_arrays(batch, w_dt, dev)
        with torch.no_grad():
            out = _tol_core(
                *arrays, _f32(step_scale),
                _f32(tol), max_iters=iters, check_every=check_every,
                Tp=batch.Tp, operator=operator, adaptive=adaptive,
                restart=restart, power_iters=_POWER_ITERS, scaling=scaling,
                precision=precision, omega_on=omega, x0=x0, y0=y0,
                eta_init=eta_init, omega_init=omega_init)
        with obs.span("lp.read"):
            (x, y, primal, dual, rel_gap, iters_b, restarts_b, conv, eta_o,
             omega_o) = (t.cpu().numpy() for t in out)
        iters_b = iters_b.astype(np.int64)
        restarts_b = restarts_b.astype(np.int64)
        eta_np = eta_o.astype(np.float32)
        omega_np = omega_o.astype(np.float32) if omega else None
    with obs.span("lp.results", host=True):
        results = []
        for b, t in enumerate(batch.problems):
            x_b = x[b, : t.n, : t.m]
            feas_b = batch.feas[b, : t.n, : t.m]
            if tol is not None:
                results.append(_tol_result(x_b, feas_b, t, primal[b],
                                           dual[b], rel_gap[b], iters_b[b],
                                           restarts_b[b], conv[b]))
                continue
            mapping = np.where(feas_b, x_b, -1.0).argmax(axis=1) \
                .astype(np.int64)
            results.append(PDHGResult(
                x=x_b, objective=float(primal[b]),
                lower_bound=float(dual[b]),
                gap=float(primal[b] - dual[b]), iters=iters, mapping=mapping,
                x_max=x_b.max(axis=1), kkt=float(rel_gap[b])))
    if not full_output:
        return results
    stats = SolveStats(
        iterations=iters_b, restarts=restarts_b, kkt=rel_gap,
        converged=conv, tol=tol,
        state=PDHGState(x=x.astype(np.float32), y=y.astype(np.float32),
                        eta=eta_np, omega=omega_np))
    return results, stats


# --- warm-started sweeps ---------------------------------------------------

def _shard_devices(devices: int, dev: torch.device) -> list[torch.device]:
    """The device of each of ``devices`` lane shards: the first ``devices``
    visible cards (the reference's ``jax.devices()[:devices]``), or the CPU
    once per shard where the caller asked for the CPU.  Raises
    ``ValueError`` when fewer cards are visible: it never runs fewer
    shards, nor moves to the CPU."""
    if dev.type == "cpu":
        return [dev] * devices
    avail = torch.cuda.device_count()
    if devices > avail:
        raise ValueError(
            f"devices={devices} exceeds the {avail} visible card(s): the "
            f"sharded sweep pipeline places one lane shard per card")
    return [torch.device("cuda", i) for i in range(devices)]


def _pipeline_steps(batches, lanes, dev, it_dt, tol, iters, step_scale,
                    operator, adaptive, restart, check_every, scaling,
                    precision, omega):
    """The warm-started chain over ``lanes`` of every group, on ``dev``, as
    a generator of ``_tol_steps``' steps: every group's lanes copied there
    at once, then solved in turn, each group warm-started from its
    predecessor's final iterates, which stay on ``dev`` (in the iterate's
    dtype, original coordinates).  Returns each group's outputs as numpy
    arrays (x, primal, dual, rel, iters, restarts, conv, eta, omega) and the
    last group's y."""
    with obs.span("lp.setup"):
        stacked = [torch.stack(parts) for parts in zip(
            *(_device_arrays(bt, it_dt, dev, lanes) for bt in batches))]
    outs = []
    x_c = y_c = eta_c = om_c = None
    for g in range(len(batches)):
        (x_o, y_o, primal, dual, rel, it_b, rs_b, conv, eta_o,
         om_o) = yield from _tol_steps(
            *(a[g] for a in stacked), _f32(step_scale), _f32(tol),
            max_iters=iters, check_every=check_every,
            Tp=batches[0].Tp, operator=operator, adaptive=adaptive,
            restart=restart, power_iters=_POWER_ITERS, scaling=scaling,
            precision=precision, omega_on=omega, x0=x_c, y0=y_c,
            eta_init=eta_c, omega_init=om_c)
        # the carry crosses groups in original coordinates; each group
        # re-scales by its own Ruiz factors on entry
        x_c, y_c = x_o.to(it_dt), y_o.to(it_dt)
        eta_c, om_c = eta_o.to(it_dt), om_o.to(it_dt)
        outs.append((x_o.to(torch.float32), primal, dual, rel, it_b, rs_b,
                     conv, eta_o.to(torch.float32), om_o.to(torch.float32)))
    with obs.span("lp.read"):
        y_last = y_c.to(torch.float32).cpu().numpy()
        return [[t.cpu().numpy() for t in out] for out in outs], y_last


def _run_shards(steps, shards):
    """Every (device, lanes) shard's ``steps(device, lanes)`` generator run
    to its end, results in shard order.  The shards run interleaved from
    this one host thread: each queues its next chunk on its own device in
    turn, and only then is each chunk's host read made, so cards work at
    once while the host launches (on the CPU the shards simply take turns)."""
    gens = [steps(d, lanes) for d, lanes in shards]
    results: list = [None] * len(gens)
    running = list(range(len(gens)))
    try:
        with torch.no_grad():
            while running:
                for i in list(running):
                    d = shards[i][0]
                    with (torch.cuda.device(d) if d.type == "cuda"
                          else contextlib.nullcontext()):
                        try:
                            next(gens[i])
                        except StopIteration as done:
                            results[i] = done.value
                            running.remove(i)
    finally:
        # a shard that raised leaves the others suspended: closing them
        # gives their chunk graphs back to the next solve of their key
        for gen in gens:
            gen.close()
    return results


def _sweep_pipeline(groups, pad_to, tol, iters, step_scale, operator,
                    adaptive, restart, check_every, scaling, precision,
                    omega, device, devices=None):
    """The sweep chain as one host call (``_pipeline_steps``): every group
    packed to one common shape, the state kept on the device.  Counts one
    dispatch.  Only the last group's ``SolveStats`` carries a state.

    ``devices=k`` splits every group's B lanes into k equal, contiguous
    shards, shard i on the i-th visible card (the CPU where asked), each
    running the whole chain on its own lanes (the reference's
    ``shard_map`` over the lane axis: each shard's early exit stops on its
    own; ``_run_shards``).  The results are gathered in lane order.  No
    quantity of the tol core is reduced across lanes, converged lanes are
    frozen, and every sum over a lane's elements goes through the lane-sum
    kernel, whose order does not depend on the batch, so every lane's
    result is the unsharded run's bit for bit: on the CPU, and on cards
    with the ``pallas`` operator (checked on four H100s, eager and with
    the chunks as graphs; ``cumsum`` and ``dense`` run torch's segment sums
    and cuBLAS products there, which are not checked at other batch sizes).
    The operator form and the padded shape are chosen once, from the whole
    group.  Before the tol chunks ran as CUDA graphs the sharded chain was
    slower on cards than on one (four H100 80GB HBM3 at 700 W took
    2.85x-6.97x the one-card LP time in three runs, PERF.md section 6): the
    tol loop was bound by kernel launches, which this one host thread
    issued for every shard.  With the chunks as graphs each card captures
    and replays its own shard's chunks between the generators' ``yield``s,
    so the host queues one replay a chunk a card: bit-equal on two and four
    H100s, the per-card launch counts as eager on four.  Its time on
    several cards is not measured apart from each card's warm-up and first
    capture."""
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError(
            f"pipeline=True needs equal group sizes (states warm-start "
            f"lane-for-lane), got sizes {sorted(sizes)}")
    _check_knobs(scaling, precision)
    dev = resolve_device(device)
    batches = [pack_problems(g, pad_to=pad_to) for g in groups]
    B = batches[0].B
    operator = _resolve_operator(operator, batches[0])
    if devices is None:
        shards = [(dev, slice(0, B))]
    else:
        if devices < 1:
            raise ValueError(f"devices must be >= 1 or None, got {devices!r}")
        if B % devices != 0:
            raise ValueError(
                f"pipeline sharding needs devices to divide the group "
                f"size, got B={B}, devices={devices}")
        per = B // devices
        shards = [(d, slice(i * per, (i + 1) * per))
                  for i, d in enumerate(_shard_devices(devices, dev))]
    it_dt = torch.float64 if precision == "f64" else torch.float32
    _count_dispatch()

    def steps(d, lanes):
        return _pipeline_steps(
            batches, lanes, d, it_dt, tol=tol, iters=iters,
            step_scale=step_scale, operator=operator, adaptive=adaptive,
            restart=restart, check_every=check_every, scaling=scaling,
            precision=precision, omega=omega)

    parts = _run_shards(steps, shards)
    with obs.span("lp.results", host=True):
        # gathered lane by lane, in shard order
        outs = [[np.concatenate([p[0][g][k] for p in parts])
                 for k in range(len(parts[0][0][g]))]
                for g in range(len(batches))]
        y_last = np.concatenate([p[1] for p in parts])
        results: list[PDHGResult] = []
        stats: list[SolveStats] = []
        for g, (batch, out) in enumerate(zip(batches, outs)):
            (xs, primals, duals, rels, iters_g, restarts_g, convs, etas,
             omegas) = out
            for b, t in enumerate(batch.problems):
                results.append(_tol_result(
                    xs[b, : t.n, : t.m], batch.feas[b, : t.n, : t.m], t,
                    primals[b], duals[b], rels[b], iters_g[b],
                    restarts_g[b], convs[b]))
            state = None
            if g == len(batches) - 1:
                state = PDHGState(x=xs, y=y_last, eta=etas,
                                  omega=omegas if omega else None)
            stats.append(SolveStats(
                iterations=iters_g.astype(np.int64),
                restarts=restarts_g.astype(np.int64), kkt=rels,
                converged=convs, tol=tol, state=state))
    return results, stats


def _sweep_impl(groups, tol: float = DEFAULT_TOL, iters: int = 4000,
                step_scale: float = 0.9, operator: str = "auto",
                adaptive: bool = True, restart: bool = True,
                check_every: int = DEFAULT_CHECK_EVERY,
                align_shapes: bool = True, scaling: str = "ruiz",
                precision: str = "mixed", omega: bool = True,
                pipeline: bool = False, devices: int | None = None,
                device=None):
    """Warm-started fleet sweep: solve a grid-adjacent sequence of instance
    groups, each group's iterates seeded from its predecessor's solution.

    ``groups[g]`` holds one sweep point's instances, ordered so consecutive
    groups are neighbours on the sweep grid (``workload.sweep_specs``'s
    row-major, seed-innermost order).  With ``align_shapes`` every group is
    packed to one common padded shape, so states carry over lane for lane;
    a group whose size differs from its predecessor's cold-starts.
    ``pipeline=True`` runs the chain as one host call with the state kept
    on the device (``_sweep_pipeline``; equal group sizes and aligned
    shapes); ``devices=k`` shards its lanes over the first k visible cards
    (k shards one after another on the CPU where ``device="cpu"``); k must
    divide the group size.  Returns ``(results, stats)``: the flat
    per-instance results in group order and one ``SolveStats`` per group.
    """
    groups = [list(g) for g in groups]
    if not groups or any(not g for g in groups):
        raise ValueError("solve_lp_sweep needs non-empty groups")
    pad_to = None
    if align_shapes:
        trimmed = [trim_timeline(p)[0] for g in groups for p in g]
        pad_to = (max(t.n for t in trimmed), max(t.m for t in trimmed),
                  max(t.D for t in trimmed), max(t.T for t in trimmed))
    if pipeline:
        if not align_shapes:
            raise ValueError(
                "pipeline=True requires align_shapes=True (every group "
                "must share one padded shape)")
        return _sweep_pipeline(
            groups, pad_to, tol=tol, iters=iters, step_scale=step_scale,
            operator=operator, adaptive=adaptive, restart=restart,
            check_every=check_every, scaling=scaling, precision=precision,
            omega=omega, device=device, devices=devices)
    results: list[PDHGResult] = []
    stats: list[SolveStats] = []
    state: PDHGState | None = None
    for g in groups:
        batch = pack_problems(g, pad_to=pad_to)
        if state is not None and state.B != batch.B:
            state = None
        res, st = solve_lp_many(
            batch, iters=iters, step_scale=step_scale, operator=operator,
            tol=tol, adaptive=adaptive, restart=restart,
            check_every=check_every, init=state, full_output=True,
            scaling=scaling, precision=precision, omega=omega,
            device=device)
        results.extend(res)
        stats.append(st)
        state = st.state
    return results, stats


def solve_lp_sweep(groups, tol: float = DEFAULT_TOL, iters: int = 4000,
                   step_scale: float = 0.9, operator: str = "auto",
                   adaptive: bool = True, restart: bool = True,
                   check_every: int = DEFAULT_CHECK_EVERY,
                   align_shapes: bool = True, scaling: str = "ruiz",
                   precision: str = "mixed", omega: bool = True,
                   pipeline: bool = False, devices: int | None = None,
                   device=None):
    """Deprecated: drive sweeps through ``FleetEngine(solver=SolverConfig(
    tol=...), sweep=SweepConfig(warm_start=k, pipeline=...)).solve(...)``.
    Forwards to the same implementation (``_sweep_impl``), so results are
    bit-identical; it only adds the warning."""
    warnings.warn(
        "solve_lp_sweep is deprecated; use FleetEngine(solver="
        "SolverConfig(tol=...), sweep=SweepConfig(warm_start=..., "
        "pipeline=...)).solve(...) — results are bit-identical",
        DeprecationWarning, stacklevel=2)
    return _sweep_impl(groups, tol=tol, iters=iters, step_scale=step_scale,
                       operator=operator, adaptive=adaptive,
                       restart=restart, check_every=check_every,
                       align_shapes=align_shapes, scaling=scaling,
                       precision=precision, omega=omega, pipeline=pipeline,
                       devices=devices, device=device)
