"""Batched greedy placement engine: lockstep ``two_phase`` over a fleet.

Ported from ``repro.core.place_batch``; the bookkeeping below is the
reference's float64 numpy, line for line, so placements are identical to
looped ``two_phase`` and to the reference.  ``place_many`` advances all B
instances in lockstep over their task-event schedules, wave-synchronized at
node-type phase boundaries: each wave runs on a compact ``(A, W, T', D)``
pool tensor (A instances with a k-th phase, W = widest pool), and each
lockstep step scores the pending task of every instance against all its
candidate nodes in a single batched feasibility + similarity pass.

Exactness: placements equal looped ``two_phase`` — same node purchases in
the same order, same ``assign``, same cost.  The per-instance attempt
schedule is precomputed in ``two_phase``'s order; node ids are purchase
ranks and purchases happen only in a type's own phase, so each type's nodes
form one contiguous id block; and the numpy scoring computes the same
float64 expressions as ``TypePool.find_fit``, with both engines quantizing
similarity scores to 9 decimals before the first-max argmax.

``backend='kernel'`` routes the scoring pass through the hand-written CUDA
fit kernel (``repro_torch.kernels.fit.fit_scores_many``, float32, one launch
per lockstep step) on ``device``: the pool window is copied to the device
on each call, and only the scores come back.  ``backend='numpy'`` is the
bit-exact host path.  ``placement='compiled'`` runs the compiled stepper
(``place_step.run_compiled``: one kernel launch per sub-phase, the pools on
``device``), which places identically; when its padded pool would be
oversized it declines and this module's engine runs instead.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import obs
from ..device import resolve_device
from . import penalty as penalty_mod
from .batch import ProblemBatch, pack_problems
from .placement import FIT_POLICIES
from .solution import EPS, Solution

__all__ = ["place_many", "PLACEMENT_STEPPERS"]

# The lockstep stepper implementations behind ``place_many(placement=)``:
# 'lockstep' is this module's vectorized-numpy engine (one host dispatch
# per placement step); 'compiled' is the on-device stepper
# (``place_step.run_compiled``: one dispatch per node-type sub-phase).
PLACEMENT_STEPPERS = ("lockstep", "compiled")


@dataclasses.dataclass
class _Phases:
    """One instance's precomputed phase structure, in two_phase order."""

    type_order: np.ndarray   # (n_phases,) node-type per wave
    own: list                # own-pack task lists, sorted (start, id)
    fill: list               # cross-fill candidate lists, sorted
                             # (h_avg(u|B), id); empty when not filling
    dem_norm: np.ndarray     # (n,) find_fit demand norms (1.0 unused)


def _phases(problem, mapping: np.ndarray, fit: str,
            filling: bool) -> _Phases:
    nt = problem.node_types
    if filling:
        type_order = np.argsort(-nt.capacity_per_cost(), kind="stable")
        h_avg = penalty_mod.relative_demand(problem, "avg")
        rank = np.empty(nt.m, np.int64)
        rank[type_order] = np.arange(nt.m)
        map_rank = rank[mapping]
    else:
        type_order = np.arange(nt.m)

    dn_all = np.ones(problem.n)
    if fit == "similarity":
        # find_fit's demand norm, cached per task (static given the
        # mapping), bit for bit: np.linalg.norm of a vector is
        # sqrt(x.dot(x)), and each row's dot here is the same BLAS call on
        # the same D values (a row-wise einsum may differ in the last ulp)
        dem_n_all = problem.dem / nt.cap[mapping]
        spans = problem.end - problem.start + 1
        sq = np.fromiter((r.dot(r) for r in dem_n_all), np.float64,
                         problem.n)
        dn_all = np.sqrt(sq) * np.sqrt(spans)

    own, fill = [], []
    for pos, B in enumerate(type_order):
        mine = np.flatnonzero(mapping == int(B))
        own.append(mine[np.lexsort((mine, problem.start[mine]))])
        if filling:
            rest = np.flatnonzero(map_rank > pos)
            fill.append(rest[np.argsort(h_avg[rest, B], kind="stable")])
        else:
            fill.append(np.zeros(0, np.int64))
    return _Phases(type_order=type_order, own=own, fill=fill,
                   dem_norm=dn_all)


def _batch_aux(batch: ProblemBatch, phases: list[_Phases]):
    """Scoring-side arrays shared by the lockstep stepper engines.

    Returns ``(dn, capx, span_all)``: per-task demand norms (B, n) padded
    with 1.0; per-(instance, type) capacity (B, m, D) with +inf on padded
    dims so ``rem / capx`` is bit-exact on real dims and 0 on padded
    ones; and every task's span mask (B, n, T') bool.
    """
    Bn = batch.B
    dn = np.stack([
        np.pad(ph.dem_norm, (0, batch.n - len(ph.dem_norm)),
               constant_values=1.0) for ph in phases])
    dim_mask = np.zeros((Bn, batch.D), bool)
    for b, t in enumerate(batch.problems):
        dim_mask[b, : t.D] = True
    capx = np.where(dim_mask[:, None, :], batch.cap, np.inf)
    t_ids = np.arange(batch.Tp)
    span_all = ((batch.start[:, :, None] <= t_ids)
                & (t_ids <= batch.end[:, :, None]))
    return dn, capx, span_all


class _Engine:
    """Shared lockstep state across the waves of one place_many call."""

    def __init__(self, batch: ProblemBatch, phases: list[_Phases],
                 backend: str, device=None):
        self.batch = batch
        self.phases = phases
        self.backend = backend
        self.device = device
        Bn = batch.B
        self.n_cap = 8
        # the master open-node state: node id == purchase rank
        self.rem = np.zeros((Bn, self.n_cap, batch.Tp, batch.D))
        self.node_type = np.full((Bn, self.n_cap), -1, np.int64)
        self.counts = np.zeros(Bn, np.int64)
        self.placed = np.zeros((Bn, batch.n), bool)
        self.assign = np.full((Bn, batch.n), -1, np.int64)
        self.dn, self.capx_all, self.span_all = _batch_aux(batch, phases)

    def run_wave(self, k: int, fit: str, filling: bool) -> bool:
        """Own-pack + cross-fill sub-phases of every instance's k-th
        node-type, on a compact tail-growing pool tensor.  Returns
        False when no instance has a k-th phase."""
        wave = np.array([b for b, ph in enumerate(self.phases)
                         if k < len(ph.type_order)], np.int64)
        if len(wave) == 0:
            return False
        tau = np.array([self.phases[b].type_order[k] for b in wave],
                       np.int64)
        lo = self.counts[wave].copy()  # each type-block starts at the
        # current purchase rank: no node of type tau exists yet
        A = len(wave)
        pool = np.zeros((A, 8, self.batch.Tp, self.batch.D))
        w = np.zeros(A, np.int64)
        # drop already-placed tasks per sub-phase up front: a task only
        # becomes placed *between* sub-phases (each list holds distinct
        # tasks), so this is exactly two_phase's dynamic ~placed filter
        # and no skip checks are needed inside the lockstep loop
        own = [self._live(b, self.phases[b].own[k]) for b in wave]
        self._run_sub(wave, tau, pool, w, own, purchase=True,
                      similarity=fit == "similarity")
        pool = self._pool
        if filling:
            fill = [self._live(b, self.phases[b].fill[k]) for b in wave]
            self._run_sub(wave, tau, pool, w, fill, purchase=False,
                          similarity=False)
            pool = self._pool
        # scatter the finished type-block back into the master array
        hi = int((lo + w).max())
        while hi > self.n_cap:
            self.rem = np.concatenate(
                [self.rem, np.zeros_like(self.rem)], axis=1)
            self.node_type = np.concatenate(
                [self.node_type,
                 np.full_like(self.node_type, -1)], axis=1)
            self.n_cap *= 2
        for a, b in enumerate(wave):
            if w[a]:
                self.rem[b, lo[a]: lo[a] + w[a]] = pool[a, : w[a]]
                self.node_type[b, lo[a]: lo[a] + w[a]] = tau[a]
        return True

    def _live(self, b: int, tasks: np.ndarray) -> np.ndarray:
        """Order-preserving ~placed filter (two_phase's phase entry)."""
        return tasks[~self.placed[b, tasks]]

    def _run_sub(self, wave, tau, pool, w, lists, purchase: bool,
                 similarity: bool):
        """Lockstep one sub-phase: one attempt list per wave instance,
        scored against the wave's compact pool each step.

        Instances leave a sub-phase permanently (their list is
        exhausted); finished pool rows are written back into the wave's
        pool tensor as their instance leaves, and the working set is
        compacted to the live rows once enough have finished, so the
        batched ops stay sized to the instances that still have
        attempts.  Fill-only sub-phases drop node-less instances up
        front: with an empty pool every attempt is a guaranteed miss
        that mutates nothing, exactly as ``find_fit`` returns None on an
        empty TypePool.  All per-task data (demands, spans, norms,
        placement flags) is read straight from the engine's padded
        batch arrays through the live-row -> instance map, so dropping
        rows never copies them.
        """
        batch = self.batch
        if purchase:
            keep = np.flatnonzero(
                np.array([len(x) for x in lists]) > 0)
        else:
            keep = np.flatnonzero(
                (w > 0) & (np.array([len(x) for x in lists]) > 0))
        lists = [lists[a] for a in keep]
        A = len(keep)
        if A == 0:
            self._pool = pool
            return
        L = max(len(x) for x in lists)
        # live-row state; `keep` maps live rows back to wave rows and
        # `bsel_l` to instances
        u_pad = np.zeros((A, L), np.int64)
        lens = np.zeros(A, np.int64)
        for a, x in enumerate(lists):
            u_pad[a, : len(x)] = x
            lens[a] = len(x)
        ptr = np.zeros(A, np.int64)
        arows = np.arange(A)
        wl = w[keep].copy()
        pool_l = pool[keep]
        tau_l = tau[keep]
        bsel_l = wave[keep]
        capx = self.capx_all[bsel_l, tau_l]
        cap_rows = batch.cap[bsel_l, tau_l]      # (A, Dp), padded dims 1
        start_pad = batch.start.astype(np.int64)
        end_pad = batch.end.astype(np.int64)
        kernel = self.backend == "kernel"
        if kernel:
            from ..kernels import ops as kops

            inv_cap = np.where(np.isfinite(capx), 1.0 / capx, 0.0)
        # pool_n caches pool / capx so similarity steps skip the big
        # division pass; one row is re-divided after each update, which
        # is bitwise what find_fit computes from the current rem
        pool_n = pool_l / capx[:, None, None, :] \
            if similarity and not kernel else None

        def write_back(rows):
            """Store finished live rows in the wave pool (grown if the
            live pool outgrew it) and the width array."""
            nonlocal pool
            if pool_l.shape[1] > pool.shape[1]:
                grown = np.zeros(
                    (len(wave),) + pool_l.shape[1:], pool.dtype)
                grown[:, : pool.shape[1]] = pool
                pool = grown
            pool[keep[rows]] = pool_l[rows]
            w[keep[rows]] = wl[rows]

        written = np.zeros(A, bool)  # finished rows already stored
        while True:
            # lists are pre-filtered (run_wave's _live), so the pending
            # attempt is always at the pointer — no skip checks needed
            done = ptr >= lens
            fresh = done & ~written
            if fresh.any():
                write_back(np.flatnonzero(fresh))
                written |= fresh
            n_done = int(done.sum())
            if n_done == A:
                break
            if n_done >= max(4, A // 4):  # compact to the live rows
                live = np.flatnonzero(~done)
                keep = keep[live]
                u_pad, lens, ptr = u_pad[live], lens[live], ptr[live]
                wl, pool_l = wl[live], pool_l[live]
                tau_l, bsel_l = tau_l[live], bsel_l[live]
                capx, cap_rows = capx[live], cap_rows[live]
                if kernel:
                    inv_cap = inv_cap[live]
                if pool_n is not None:
                    pool_n = pool_n[live]
                A = len(live)
                arows = np.arange(A)
                done = np.zeros(A, bool)
                written = np.zeros(A, bool)
            if wl.max() == pool_l.shape[1]:  # grow the pool tail
                pool_l = np.concatenate(
                    [pool_l, np.zeros_like(pool_l)], axis=1)
                if pool_n is not None:
                    pool_n = np.concatenate(
                        [pool_n, np.zeros_like(pool_n)], axis=1)

            alive = ~done
            u_cur = u_pad[arows, np.minimum(ptr, lens - 1)]
            dem = batch.dem[bsel_l, u_cur]               # (A, Dp)
            s_cur = start_pad[bsel_l, u_cur]
            e_cur = end_pad[bsel_l, u_cur]
            span = self.span_all[bsel_l, u_cur]          # (A, T')
            W = max(int(wl.max()), 1)
            node_ok = (np.arange(W)[None, :] < wl[:, None]) \
                & alive[:, None]

            if kernel:
                feas, score = kops.fit_scores_many(
                    pool_l[:, :W], dem, s_cur, e_cur, inv_cap,
                    scored=similarity, device=self.device)
                feas = feas & node_ok
            else:
                # not any(rem < dem - EPS) over the span == find_fit's
                # all(rem >= dem - EPS): the same comparisons on the
                # contiguous (T'*D)-flattened pool rows (numpy's
                # iterator is ~10x faster there than on 4-D broadcasts
                # with a tiny trailing axis)
                pool3 = pool_l[:, :W].reshape(A, W, -1)  # contig view
                thr_flat = np.tile(dem - EPS, (1, batch.Tp))
                span_flat = np.repeat(span, batch.D, axis=1)
                viol = ((pool3 < thr_flat[:, None, :])
                        & span_flat[:, None, :]).any(axis=2)
                feas = ~viol & node_ok
                if similarity:
                    # slice time to the live span union for the einsum
                    # reductions: dropped slots carry only exact-zero
                    # terms, so the accumulations are unchanged
                    t0 = int(s_cur[alive].min())
                    t1 = int(e_cur[alive].max()) + 1
                    rem_n = pool_n[:, :W, t0:t1]
                    dem_n = dem / capx
                    span_f = span[:, t0:t1].astype(np.float64)
                    dot = np.einsum("bntd,bd,bt->bn", rem_n, dem_n,
                                    span_f)
                    norm2 = np.einsum("bntd,bntd,bt->bn", rem_n, rem_n,
                                      span_f)
                    dem_norm = self.dn[bsel_l, u_cur]
                    score = dot / (dem_norm[:, None] * np.sqrt(norm2)
                                   + 1e-30)
            has = feas.any(axis=1)
            if similarity:
                # find_fit's quantized tie-break: digits beyond the 9th
                # are float reassociation noise across scoring layouts
                choice = np.where(feas, np.round(score, 9),
                                  -np.inf).argmax(axis=1)
            else:
                choice = feas.argmax(axis=1)  # lowest id == earliest

            place_a = np.flatnonzero(has)     # has implies alive
            j_all = choice[place_a]
            if purchase:
                buy_a = np.flatnonzero(~has & alive)
                if len(buy_a):
                    bad = (dem[buy_a] > cap_rows[buy_a] + EPS
                           ).any(axis=1)
                    if bad.any():
                        a0 = int(buy_a[int(np.flatnonzero(bad)[0])])
                        raise RuntimeError(
                            f"mapping assigned task {int(u_cur[a0])} "
                            f"to node-type {int(tau_l[a0])} it cannot "
                            f"fit")
                    j_new = wl[buy_a]
                    pool_l[buy_a, j_new] = cap_rows[buy_a][:, None]
                    wl[buy_a] += 1
                    self.counts[bsel_l[buy_a]] += 1
                    place_a = np.concatenate([place_a, buy_a])
                    j_all = np.concatenate([j_all, j_new])
            if len(place_a):
                sub = (dem[place_a][:, None, :]
                       * span[place_a].astype(np.float64)[:, :, None])
                pool_l[place_a, j_all] -= sub  # dem*1 / dem*0: exact
                if pool_n is not None:
                    pool_n[place_a, j_all] = (
                        pool_l[place_a, j_all]
                        / capx[place_a][:, None, :])
                u_sel = u_cur[place_a]
                b_sel = bsel_l[place_a]
                # global node id = block start + pool-local index
                self.assign[b_sel, u_sel] = \
                    self.counts[b_sel] - wl[place_a] + j_all
                self.placed[b_sel, u_sel] = True
            ptr += alive
        self._pool = pool


def place_many(problems, mappings, fit: str = "first",
               filling: bool = False, backend: str = "numpy",
               meta: dict | None = None, placement: str = "lockstep",
               telemetry: dict | None = None,
               device=None) -> list[Solution]:
    """Batched ``two_phase`` over B instances; placements are identical.

    ``problems`` is a sequence of ``Problem``s or an already-packed
    ``ProblemBatch`` (instances are timeline-trimmed either way, like
    every placement entry point); ``mappings[b]`` is instance b's
    task -> node-type mapping in trimmed coordinates.  Returns one
    ``Solution`` per instance, equal (node purchases, ``assign``, cost)
    to ``two_phase(batch.problems[b], mappings[b], fit, filling)``.

    ``placement='lockstep'`` is this module's engine; ``'compiled'`` runs
    every sub-phase as one launch of the CUDA stepper on ``device`` (its
    plain version on the CPU); on the CPU only, it falls back to this
    module's engine when the padded pool would exceed
    ``place_step.MAX_POOL_CELLS`` (``backend`` applies to that fallback
    only).  ``backend='kernel'``
    scores on ``device`` (None = the CUDA card).  ``telemetry``, when a
    dict, is filled in place with the stepper used (``"lockstep-fallback"``
    when the compiled stepper declined), the wave count and per-wave
    seconds, and for the compiled stepper its mode and dispatches.

    >>> import numpy as np
    >>> from repro_torch.core import place_many, two_phase
    >>> from repro_torch.workload import SyntheticSpec, synthetic_instance
    >>> ps = [synthetic_instance(SyntheticSpec(n=12, m=2, D=2, T=6,
    ...                                        seed=s)) for s in (0, 1)]
    >>> maps = [np.zeros(12, np.int64), np.ones(12, np.int64)]
    >>> sols = place_many(ps, maps, fit="similarity", device="cpu")
    >>> want = two_phase(ps[0], maps[0], fit="similarity", device="cpu")
    >>> bool(np.array_equal(sols[0].assign, want.assign))
    True
    """
    if fit not in FIT_POLICIES:
        raise ValueError(f"fit must be one of {FIT_POLICIES}")
    if backend not in ("numpy", "kernel"):
        raise ValueError(
            f"backend must be 'numpy'|'kernel', got {backend!r}")
    if placement not in PLACEMENT_STEPPERS:
        raise ValueError(
            f"placement must be one of {PLACEMENT_STEPPERS}, "
            f"got {placement!r}")
    dev = resolve_device(device)
    with obs.span("place.prep", host=True):
        batch = problems if isinstance(problems, ProblemBatch) \
            else pack_problems(problems)
        if len(mappings) != batch.B:
            raise ValueError("need exactly one mapping per instance")
        phases = [_phases(t, np.asarray(mp, np.int64), fit, filling)
                  for t, mp in zip(batch.problems, mappings)]
    if placement == "compiled":
        from . import place_step

        sols = place_step.run_compiled(batch, phases, fit=fit,
                                       filling=filling, meta=meta,
                                       telemetry=telemetry, device=dev)
        if sols is not None:
            return sols
        # pool over the CPU's cap: place_step declined (and recorded why
        # in telemetry); fall through to the numpy lockstep engine
    eng = _Engine(batch, phases, backend, device=dev)
    wave_s = []
    k = 0
    while True:
        t0 = time.perf_counter()
        if not eng.run_wave(k, fit, filling):
            break
        wave_s.append(time.perf_counter() - t0)
        k += 1
    if telemetry is not None:
        telemetry.setdefault("engine", "lockstep")
        telemetry["waves"] = len(wave_s)
        telemetry["wave_s"] = wave_s

    with obs.span("place.solutions", host=True):
        out = []
        for b, t in enumerate(batch.problems):
            assert eng.placed[b, : t.n].all(), \
                "place_many must place every task"
            out.append(Solution(
                node_type=eng.node_type[b, : eng.counts[b]].copy(),
                assign=eng.assign[b, : t.n].copy(),
                meta=dict(meta or {}, fit=fit, filling=filling),
            ))
    return out
