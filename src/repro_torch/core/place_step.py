"""Compiled placement stepper: each placement sub-phase in one kernel launch.

Ported from ``repro.core.place_step``.  ``place_batch.place_many`` advances
every instance's greedy placement (paper §III first/similarity fit, §V-D
cross-fill) in lockstep but returns to the host between steps.  Here the
host dispatches once per *sub-phase*: the hand-written CUDA stepper
(``kernels.place_step.sub_phase``, ``kernels/csrc/place_step.cu``) keeps the
lanes' open-node pools on the card and walks every attempt step of the
sub-phase itself.  Two plans, as in the reference:

  * **type-parallel** (``filling=False``): every (instance, node-type) phase
    is independent — types partition the tasks and pools never interact —
    so all phases run at once as lanes of ONE dispatch.  Global node ids are
    rebuilt afterwards from the per-type node counts (``two_phase`` numbers
    each type's purchases as one contiguous block in type order).
  * **wave-sequential** (``filling=True``): cross-fill makes wave k+1's task
    lists depend on wave k's placements, so waves run in the numpy engine's
    order — one own-pack and one cross-fill dispatch per node-type phase.
    Within a wave the pool stays on the card between the two dispatches.

Per dispatch the host makes one host→card copy of the gathered attempt
sequences (packed into one buffer) and one card→host copy of the lanes'
node counts, infeasibility steps and node choices.  On the CPU the stepper
is its plain PyTorch version (``kernels.ref.sub_phase_ref``).

Exactness: placements equal the numpy lockstep engine's and ``two_phase``'s
bit for bit.  Every elementwise expression is the numpy engine's float64
operation on the same values (the kernel is compiled without fused
multiply-add); the similarity sums are taken in another order, which the
engines' shared 9-decimal quantization (``_QUANTUM``, divided, never
multiplied by its reciprocal) collapses; the argmax takes the first maximum
and node ids are purchase ranks in every engine.

Not ported: ``_make_sub_phase``, ``_sub_phase_fn``, ``_plan_chunks``,
``CHUNK`` and ``_pow2``.  They cut the scan into chunks with static node
prefixes and time windows because XLA compiles static shapes; the kernel
reads each lane's live node count and each task's span at run time.

On the CPU, a call whose padded pool would exceed ``MAX_POOL_CELLS``
float64 cells returns None (the caller then runs the numpy lockstep engine)
and records why in the telemetry dict, as the reference does.  On the card
there is no cap: the kernel allocates nothing beside the pool, and a pool
the card cannot hold raises torch's out-of-memory error.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..kernels import place_step as kstep
from .solution import Solution

__all__ = ["run_compiled", "MAX_POOL_CELLS"]

# On the CPU, fall back to the numpy lockstep engine when a dispatch's padded
# pool (A, n_cap, T', D) would exceed this many float64 cells (128 MiB): the
# plain step loop makes pool-sized temporaries every step, as XLA's scan does
# in the reference.  The CUDA kernel makes none, so the card has no cap.
MAX_POOL_CELLS = 1 << 24

_QUANTUM = 1e9  # the engines' shared 9-decimal tie-break quantization


def _pad4(x: int) -> int:
    return max(4, (int(x) + 3) & ~3)


def _pad_lists(lists, L: int):
    """(B, L) attempt-index padding + (B,) i32 lengths."""
    B = len(lists)
    u_pad = np.zeros((B, L), np.int64)
    lens = np.zeros(B, np.int32)
    for b, x in enumerate(lists):
        u_pad[b, : len(x)] = x
        lens[b] = len(x)
    return u_pad, lens


def _oversized(device, cells: int) -> bool:
    """Whether a pool of ``cells`` float64 cells exceeds the CPU's cap."""
    return device.type == "cpu" and cells > MAX_POOL_CELLS


def _upload(arrays, device):
    """Device tensors of ``arrays`` (contiguous numpy) through one
    host→card copy: the arrays are packed, 8-byte aligned, into one byte
    buffer, and each tensor is a view of the copied buffer."""
    with obs.span("place.pack", host=True):
        offsets, total = [], 0
        for a in arrays:
            total = (total + 7) & ~7
            offsets.append(total)
            total += a.nbytes
        buf = np.empty(total, np.uint8)
        for a, off in zip(arrays, offsets):
            buf[off: off + a.nbytes] = a.reshape(-1).view(np.uint8)
    with obs.span("place.upload"):
        dbuf = torch.from_numpy(buf).to(device)
    obs.add("place.upload_bytes", total)
    return [dbuf[off: off + a.nbytes]
            .view(getattr(torch, a.dtype.name)).view(a.shape)
            for a, off in zip(arrays, offsets)]


class _Driver:
    """Shared host state of one ``run_compiled`` call."""

    def __init__(self, batch, phases, fit: str, device):
        from .place_batch import _batch_aux

        self.batch = batch
        self.phases = phases
        self.device = device
        self.B, self.n = batch.B, batch.n
        self.Tpp = _pad4(batch.Tp)  # slot padding is cheap; nodes not
        self.K = self.Tpp * batch.D
        self.dn, self.capx_all, _ = _batch_aux(batch, phases)
        self.similarity = fit == "similarity"
        self.counts = np.zeros(self.B, np.int64)
        self.placed = np.zeros((self.B, self.n), bool)
        self.assign = np.full((self.B, self.n), -1, np.int64)
        self.dispatches = 0
        self.spilled_lanes = 0  # lanes whose open rows outgrew shared memory

    def gather(self, lists, L, b_of, tau_of):
        """Per-attempt stepper inputs for one sub-phase (numpy): lane a is
        instance ``b_of[a]`` packing node-type ``tau_of[a]``.  Returns
        ``u_pad`` and the kernel's sequence operands ``(lens, dem_seq,
        s_seq, e_seq, dn_seq, capx, cap_rows)``."""
        batch = self.batch
        with obs.span("place.gather", host=True):
            u_pad, lens = _pad_lists(lists, L)
            lidx = b_of[:, None]
            dem_seq = np.ascontiguousarray(
                batch.dem[lidx, u_pad].transpose(1, 0, 2), np.float64)
            s_seq = np.ascontiguousarray(
                batch.start[lidx, u_pad].T.astype(np.int32))
            e_seq = np.ascontiguousarray(
                batch.end[lidx, u_pad].T.astype(np.int32))
            dn_seq = np.ascontiguousarray(self.dn[lidx, u_pad].T,
                                          np.float64)
            capx = np.ascontiguousarray(self.capx_all[b_of, tau_of],
                                        np.float64)
            cap_rows = np.ascontiguousarray(batch.cap[b_of, tau_of],
                                            np.float64)
        return u_pad, (lens, dem_seq, s_seq, e_seq, dn_seq, capx, cap_rows)

    def cap_pool(self, cap_rows, n_cap: int):
        """Cap-initialized (A, n_cap, K) pool on the card: every row starts
        at full capacity, so opening a node inside the stepper is just the
        width increment (unopened rows are never read or written)."""
        cap_k = cap_rows.repeat(1, self.Tpp)                 # (A, K)
        return cap_k[:, None, :].expand(
            len(cap_rows), n_cap, self.K).contiguous()

    def dispatch(self, pool, w, seq, purchase: bool, similarity: bool,
                 rows: int):
        """One stepper launch; the pool is updated in place.  Returns the
        lanes' node counts on the card (the next dispatch's ``w``) and
        ``(w, bad, j_rec)`` on the host, read back in one copy."""
        lens, dem_seq, s_seq, e_seq, dn_seq, capx, cap_rows = seq
        info: dict = {}
        out = kstep.sub_phase(pool, w, lens, dem_seq, s_seq, e_seq, dn_seq,
                              capx, cap_rows, _QUANTUM, purchase=purchase,
                              similarity=similarity, rows=rows,
                              telemetry=info)
        self.dispatches += 1
        A = len(w)
        w_host, bad, j_rec = kstep.split(out.cpu().numpy(), A)
        if "smem_rows" in info:
            self.spilled_lanes += int((w_host > info["smem_rows"]).sum())
        return out[:A], w_host.astype(np.int64), bad, j_rec

    def apply(self, j_rec, u_pad, b_of, base):
        """Fold one sub-phase's (L, A) node choices into assign: lane a's
        attempt l placed task ``u_pad[a, l]`` into global node
        ``base[a] + j_rec[l, a]``."""
        j_al = j_rec.T                         # (A, L)
        a_hit, l_hit = np.nonzero(j_al >= 0)
        u_hit = u_pad[a_hit, l_hit]
        b_hit = b_of[a_hit]
        self.assign[b_hit, u_hit] = base[a_hit] + j_al[a_hit, l_hit]
        self.placed[b_hit, u_hit] = True

    def raise_bad(self, bad, u_pad, b_of, tau_of, phase_of=None):
        """Raise the sequential engines' infeasible-mapping error.

        ``phase_of`` orders lanes by type-phase position (type-parallel
        runs every phase at once, but the sequential engines hit the
        earliest (phase, step, lane) first, so the reported task must
        match theirs)."""
        hit = np.flatnonzero(bad >= 0)
        if len(hit):
            if phase_of is None:
                a = int(hit[np.argmin(bad[hit])])
            else:
                a = int(min(hit, key=lambda i: (phase_of[i], bad[i], i)))
            u = int(u_pad[a, bad[a]])
            raise RuntimeError(
                f"mapping assigned task {u} to node-type "
                f"{int(tau_of[a])} it cannot fit")

    def solutions(self, node_type, meta, fit, filling):
        out = []
        for b, t in enumerate(self.batch.problems):
            assert self.placed[b, : t.n].all(), \
                "compiled stepper must place every task"
            out.append(Solution(
                node_type=node_type[b, : self.counts[b]].copy(),
                assign=self.assign[b, : t.n].copy(),
                meta=dict(meta or {}, fit=fit, filling=filling),
            ))
        return out


def _run_type_parallel(drv: _Driver):
    """filling=False: ALL (instance, node-type) phases as lanes of one
    dispatch.  Global node ids are rebuilt afterwards: ``two_phase`` numbers
    each type's purchases as one contiguous block in type order, so the
    block offsets are the exclusive prefix sums of the per-type node counts.
    Returns None when the lane pool would exceed the CPU's cap."""
    phases, B = drv.phases, drv.B
    with obs.span("place.gather", host=True):
        lanes = [(b, k) for b in range(B)
                 for k in range(len(phases[b].type_order))
                 if len(phases[b].own[k])]
        if not lanes:
            return [], np.full((B, 1), -1, np.int64)
        lists = [phases[b].own[k] for b, k in lanes]
        b_of = np.array([b for b, _ in lanes], np.int64)
        k_of = np.array([k for _, k in lanes], np.int64)
        tau_of = np.array([int(phases[b].type_order[k]) for b, k in lanes],
                          np.int64)
        L = max(len(x) for x in lists)
    if _oversized(drv.device, len(lanes) * L * drv.K):
        return None
    u_pad, seq = drv.gather(lists, L, b_of, tau_of)
    seq = _upload(seq, drv.device)
    with obs.span("place.dispatch"):
        pool = drv.cap_pool(seq[-1], L)
        w0 = torch.zeros(len(lanes), dtype=torch.int32, device=drv.device)
        _, w_np, bad, j_rec = drv.dispatch(pool, w0, seq, purchase=True,
                                           similarity=drv.similarity, rows=L)
    with obs.span("place.apply", host=True):
        drv.raise_bad(bad, u_pad, b_of, tau_of, phase_of=k_of)
        # per-instance node blocks in type order -> purchase-rank offsets
        per_type = np.zeros((B, drv.batch.m), np.int64)
        per_type[b_of, tau_of] = w_np
        offsets = np.cumsum(per_type, axis=1) - per_type  # exclusive
        drv.counts = per_type.sum(axis=1)
        drv.apply(j_rec, u_pad, b_of, offsets[b_of, tau_of])
        node_type = np.full((B, max(1, int(drv.counts.max()))), -1,
                            np.int64)
        for (b, tau, cnt) in zip(b_of, tau_of, w_np):
            if cnt:
                off = offsets[b, tau]
                node_type[b, off: off + cnt] = tau
    return [1.0], node_type  # one fused "wave"


def _run_waves(drv: _Driver, filling: bool):
    """Wave-synchronized phases (the numpy engine's order): one own-pack
    and, with filling, one cross-fill dispatch per node-type phase, the
    wave's pool kept on the card between them."""
    phases, B = drv.phases, drv.B
    node_cap = 8
    node_type = np.full((B, node_cap), -1, np.int64)
    wave_s: list[float] = []
    b_all = np.arange(B)
    k = 0
    while True:
        wave = {b for b, ph in enumerate(phases)
                if k < len(ph.type_order)}
        if not wave:
            break
        t0 = time.perf_counter()
        with obs.span("place.gather", host=True):
            tau = np.zeros(B, np.int64)
            for b in wave:
                tau[b] = phases[b].type_order[k]
            own = [phases[b].own[k][~drv.placed[b, phases[b].own[k]]]
                   if b in wave else np.zeros(0, np.int64)
                   for b in range(B)]
        lo = drv.counts.copy()
        pool = w = None
        if any(len(x) for x in own):
            L = max(len(x) for x in own)
            u_pad, seq = drv.gather(own, L, b_all, tau)
            seq = _upload(seq, drv.device)
            with obs.span("place.dispatch"):
                pool = drv.cap_pool(seq[-1], L)
                w0 = torch.zeros(B, dtype=torch.int32, device=drv.device)
                w, w_np, bad, j_rec = drv.dispatch(
                    pool, w0, seq, purchase=True, similarity=drv.similarity,
                    rows=L)
            with obs.span("place.apply", host=True):
                drv.raise_bad(bad, u_pad, b_all, tau)
                drv.apply(j_rec, u_pad, b_all, lo)
                drv.counts += w_np
                while int(drv.counts.max()) > node_cap:
                    node_type = np.concatenate(
                        [node_type, np.full_like(node_type, -1)], axis=1)
                    node_cap *= 2
                for b in wave:
                    if w_np[b]:
                        node_type[b, lo[b]: lo[b] + w_np[b]] = tau[b]
        if filling and pool is not None:
            with obs.span("place.gather", host=True):
                fill = [phases[b].fill[k][~drv.placed[b, phases[b].fill[k]]]
                        if b in wave and w_np[b] > 0
                        else np.zeros(0, np.int64)
                        for b in range(B)]
            if any(len(x) for x in fill):
                L = max(len(x) for x in fill)
                u_pad, seq = drv.gather(fill, L, b_all, tau)
                seq = _upload(seq, drv.device)
                with obs.span("place.dispatch"):
                    _, _, _, j_rec = drv.dispatch(
                        pool, w, seq, purchase=False, similarity=False,
                        rows=int(w_np.max()))
                with obs.span("place.apply", host=True):
                    drv.apply(j_rec, u_pad, b_all, lo)
        wave_s.append(time.perf_counter() - t0)
        k += 1
    return wave_s, node_type


def run_compiled(batch, phases, fit: str, filling: bool,
                 meta: dict | None = None,
                 telemetry: dict | None = None,
                 device=None):
    """Compiled-stepper body of ``place_many(placement='compiled')``.

    Takes the packed ``ProblemBatch`` and the per-instance ``_Phases`` the
    caller already built and the device to step on (None = the CUDA card;
    the CPU runs the stepper's plain version); returns one
    ``Solution`` per instance (bit-identical to the numpy lockstep engine
    and ``two_phase``), or None when, on the CPU, the padded pool would
    exceed ``MAX_POOL_CELLS`` (the caller then runs the numpy engine on the
    same phases).

    filling=False runs the type-parallel plan: one dispatch for the whole
    placement.  filling=True runs wave-synchronized, one own-pack and one
    cross-fill dispatch per node-type phase.  ``telemetry``, when a dict,
    gets ``engine``, ``mode``, ``waves``, ``wave_s``, ``dispatches`` and
    ``spilled_lanes`` (lanes whose open rows outgrew the kernel's shared
    memory and were kept in device memory).
    """
    with obs.span("place.prep", host=True):
        drv = _Driver(batch, phases, fit, resolve_device(device))
        # wave-mode budget: the widest wave's padded pool
        max_own = max((len(ph.own[k]) for ph in phases
                       for k in range(len(ph.type_order))), default=0)
    if _oversized(drv.device, batch.B * max_own * drv.K):
        if telemetry is not None:
            telemetry["engine"] = "lockstep-fallback"
            telemetry["fallback"] = (
                "padded pool would exceed "
                f"{MAX_POOL_CELLS} cells; using the numpy engine")
        return None

    t0 = time.perf_counter()
    if filling:
        wave_s, node_type = _run_waves(drv, filling)
        mode = "wave-sequential"
    else:
        out = _run_type_parallel(drv)
        if out is None:  # lane pool over the CPU's cap: waves fit it
            wave_s, node_type = _run_waves(drv, filling)
            mode = "wave-sequential"
        else:
            wave_s, node_type = out
            wave_s = [time.perf_counter() - t0] * len(wave_s)
            mode = "type-parallel"

    if telemetry is not None:
        telemetry["engine"] = "compiled"
        telemetry["mode"] = mode
        telemetry["waves"] = len(wave_s)
        telemetry["wave_s"] = wave_s
        telemetry["dispatches"] = drv.dispatches
        telemetry["spilled_lanes"] = drv.spilled_lanes

    with obs.span("place.solutions", host=True):
        return drv.solutions(node_type, meta, fit, filling)
