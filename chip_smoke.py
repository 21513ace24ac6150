#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure raises and the script exits non-zero:

1. card: the card's name and power limit from ``nvidia-smi``;
2. build: compile every CUDA kernel of ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (all at once) and print ptxas' registers, shared memory and
   spills per kernel;
3. edges: each kernel against its plain PyTorch version at edge shapes;
4. main path: ``FleetEngine(solver=SolverConfig(operator="pallas"),
   placement=PlacementConfig(backend="kernel")).evaluate`` over 16 Table-I
   instances (n=1000, m=10, D=5, T=24, seeds 0..15), all four algorithms,
   2000 PDHG iterations, with the kernel launch counts set to 0 just before
   and read just after; then the same evaluate once more, at 250 PDHG
   iterations, under ``torch.profiler`` for the card's busy time and idle
   share (whole evaluate, LP and placement);
5. kernels on the main path's own inputs: every distinct shape the main path
   gave each kernel, held against the plain version, then timed: device
   time per call of the kernel, its plain version and one PyTorch library
   call (from the profiler), the least time the card could take, and the
   wall time per wrapper call (CUDA events).  The library call is
   ``torch.bmm`` of a prebuilt mask for congestion (for the LP's apply, on
   a prebuilt ``x * w`` too) and, for fit, which no single PyTorch call
   computes, the plain version fused by ``torch.compile``: a yardstick only,
   which the port never calls.  The congestion kernel is timed through both
   of its entries: the LP's own apply (``congestion_lp``, the main path's
   every launch) and the TPU contract (``congestion_many``) at G = B*m, the
   shape of the groups the LP's apply once made; one profiled forward apply
   of the ``pallas`` operator must run exactly one device kernel, and is
   timed beside the ``dense`` apply and the three-launch expression the
   ``pallas`` apply replaced;
6. the same fleet with no kernels (``operator="dense"``, ``backend="numpy"``):
   lower bounds and costs must agree;
7. the single-instance path: ``rightsize(instance 0, algo,
   backend="kernel")`` for the four algorithms, with the fleet's LP result,
   counts set to 0 just before and read just after: one launch of the
   ``two_phase`` kernel per ``two_phase`` call (12), none of the B=1 fit
   kernel; then ``backend="numpy"``.  Every cost and ``assign`` must equal
   the numpy route's, lp-map-f's cost the fleet's, and ``verify`` pass.
   Every launch is replayed on the kernel and on its plain version
   (``ref.two_phase_ref``, on the CPU): node counts, stopping tasks,
   attempts and every task's node bit-equal.  The lp-map-f launches are
   timed (kernel, plain version on the card, bound, wall per call) beside
   their latency bound: attempts times one step of ``place_step.cu``'s
   barrier chain (one block barrier and one shared-memory hand-over,
   measured here), which the kernels line carries as ``latency_bound_ms``;
   and
   ``rightsize(lp-map-f)``'s wall by both routes, in turns.  The B=1 fit
   kernel (``fit_scores``, the reference's ``fit_scores_pallas``) is still
   held against its plain version and timed at the shape the per-task route
   gave it (N=2, T'=23, D=5, span 2);
8. the compiled placement stepper: the same fleet through
   ``FleetEngine(solver=SolverConfig(operator="dense"),
   placement=PlacementConfig(engine="compiled")).evaluate``, with the launch
   counts set to 0 just before and read just after: stepper launches must
   equal the telemetry's dispatches (both modes, no fallback, at most
   6 + 6 * 2m) and every cost must equal the kernel-free batched run's
   (phase 6, the same dense LP).  Then, on that run's LP results, every
   ``place_many`` call of the protocol once with the numpy lockstep engine
   and once compiled under ``torch.profiler`` (the compiled placement's
   device idle share): every ``assign`` and purchase must be equal.  Then
   the stepper's every dispatch of the four lp-map placements (first and
   similarity fit, filling off and on) is replayed on the kernel and on its
   plain version (``ref.sub_phase_ref``): node choices, counts,
   infeasibility steps and the pool must be bit-equal; the type-parallel and
   the largest wave dispatch are timed (kernel, plain version, bound).
   Phase 5 also times the G=1 congestion launch (``congestion``, the
   reference's ``congestion_pallas``) at n=1000, T'=24, K=5 against
   ``torch.bmm``, and prints the launch shape the kernel picks for each
   congestion shape it times;
9. tolerance mode: ``FleetEngine(solver=SolverConfig(tol=5e-3, iters=4000,
   operator="pallas"), placement=PlacementConfig(engine="compiled"))
   .evaluate`` over the same fleet, counts set to 0 just before and read
   just after: every lane converged with kkt <= float32(5e-3), congestion
   launches = 13 + the most iterations (12 power iterations, the initial
   apply, one per attempt), each tol lower bound <= phase 6's legacy
   objective and phase 6's lower bound <= each tol objective (rel 1e-6; both
   are certified bounds), and the last tol-mode apply (Ruiz-scaled weights,
   a mass-scaled x) replayed on the plain version (rtol/atol 1e-5).  Then
   the same evaluate with ``operator="dense"``: objectives within the gap
   two tol-converged solves can show, each certified bound under the other
   run's objective, costs equal wherever the two LP mappings are (another
   summation order moves a tolerance-stopped iterate, and canonical
   rounding of a degenerate LP can then pick another type; the flips are
   counted).  Then a 16-instance sweep (n = 850..1000, 4 seeds each) under
   ``SweepConfig(warm_start=4)``, sequential and ``pipeline=True``: 4 and 1
   solver dispatches, the same arithmetic, so every mapping and cost
   equal, objectives within that gap (bit-equality reported).  It prints each run's lp_s beside phase 4's
   legacy ``pallas`` LP, iterations and restarts cold and warm, and the tol
   LP's device busy time and idle share from a marker-checked profile.

10. the constrained and GCT-like fleets, through the same kernels at new
   shapes.  (a) The 16 Table-I instances, each with constraints drawn by
   ``np.random.default_rng(1000 + s)`` over disjoint task sets (40 meetable
   deadlines, 16 malleable tasks whose deadline makes the resolver pick a
   width, 16 affinity groups of 3, 8 anti-affinity groups of 4, 24
   exclusive tasks; a set lowering rejects is weakened: affinity dropped,
   then widths), lowered to D = 14: the tol-mode compiled evaluate (counts
   set to 0 just before and read just after), then ``rightsize(q, algo,
   lp_result=..., backend="kernel")`` for the four algorithms on every
   instance (12 ``two_phase`` launches each), every plan clean under
   ``check_plan`` and equal, ``assign`` and cost, to ``backend="numpy"``;
   every protocol call of the lowered fleet by the numpy lockstep engine
   and the compiled stepper bit-equal, and the lp-map calls through the fit
   kernel (``backend="kernel"``) too; the last congestion apply and every
   lp-map stepper dispatch replayed on the plain versions.  (b) 16 GCT-like
   instances (``gct_like_instance(n=1000, m=10, seed=s)``, T' about 995,
   D = 2) through the same evaluate: the lp-map calls' placements bit-equal
   to the numpy lockstep engine's and their costs equal, the last apply (T' about
   995) within rtol/atol 1e-5 of the plain version, the type-parallel and
   the largest wave dispatch bit-equal to ``ref.sub_phase_ref`` with their
   ``smem_rows`` and spilled lanes.  Both print iterations and convergence
   per lane, lp_s and place_s, and the kernels' times and bounds at these
   shapes; the kernels line carries each kernel's phase-10 launches.

11. the serving loop: ``gct_trace(TraceSpec(fleets=16, requests=160,
   n0=1000, m=10, seed=0))`` (16 admissions of 1000-task GCT-like fleets, T'
   about 997, D = 2, then 144 arrivals, departures and bursts) replayed with
   ``replay(..., push_per_tick=16)`` under ``ServiceConfig()`` into
   ``RightsizingService(engine=FleetEngine(solver=SolverConfig(tol=5e-3,
   iters=4000, operator="pallas"), placement=PlacementConfig(
   engine="compiled"), algos=("lp-map-f",)))``, counts set to 0 just before
   and read just after; then a cold control (``ServiceConfig(warm_start=
   False)``) and a ``replay_with_crash`` of the same trace (snapshot after
   three ticks).  Both replays: one dispatch per tick, every lane
   converged; per tick, congestion launches = 13 + its most iterations and
   stepper launches = the compiled placement's dispatches; median warm
   iterations below the cold control's; the proposed cost totals within
   ``cost_drift_bound_pct``; every adopted plan clean under ``check_plan``
   (on each fleet's start slots, see ``start_slots``);
   the last tick's placements equal to the numpy lockstep engine's, its
   last apply within rtol/atol 1e-5 of the plain version and its first
   stepper dispatch bit-equal to ``ref.sub_phase_ref``; the recovered
   replay's ``total_cost`` and ``proposed_cost_total`` bit-equal to the
   uninterrupted one's.  It prints requests/s, p50/p99 re-plan latency,
   iterations and, per tick, solve_s, place_s, lanes, warm lanes and
   launches; the kernels line carries the phase-11 launches.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and non-tensor-core f32 and
# f64 rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12

CONG_RTOL = CONG_ATOL = 1e-5   # float32 sums in another order
FIT_RTOL = FIT_ATOL = 1e-5     # dot / norm: float32 sums in another order
LB_RTOL = 1e-4                 # two float32 PDHG trajectories
COST_RTOL = 1e-5               # a flipped placement moves a whole node price
FLEET = 16                     # Table-I instances in the main path's fleet
TOL = 5e-3                     # phase 9's SolverConfig(tol=...)
BOUND_RTOL = 1e-6              # phase 9's certified cross-bounds

SOURCES = {
    # one kernel, two entries: the TPU contract at G = B*m groups, and the
    # LP's own forward apply, which the main path launches
    "congestion_many": ("src/repro_torch/kernels/csrc/congestion.cu",
                        "src/repro/kernels/congestion.py:110"),
    "congestion_lp": ("src/repro_torch/kernels/csrc/congestion.cu",
                      "src/repro/kernels/congestion.py:110"),
    "fit_scores_many": ("src/repro_torch/kernels/csrc/fit.cu",
                        "src/repro/kernels/fit.py:184"),
    "fit_scores": ("src/repro_torch/kernels/csrc/fit.cu",
                   "src/repro/kernels/fit.py:104"),
    # the redesign of fit_scores for the single-instance path: the whole
    # two_phase loop around it (src/repro/core/placement.py) in one launch
    "two_phase": ("src/repro_torch/kernels/csrc/place_step.cu",
                  "src/repro/kernels/fit.py:104"),
    # the redesign of fit_scores_many for the compiled path: the scan body
    # of the reference's stepper with its scorer, ops.fit_scores_step
    "place_step": ("src/repro_torch/kernels/csrc/place_step.cu",
                   "src/repro/core/place_step.py:168"),
}


T0 = time.perf_counter()


def log(*parts):
    print(f"[{time.perf_counter() - T0:7.1f}s]", *parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(text: str) -> list[str]:
    """One line per kernel: registers, shared memory, spills."""
    rows, name, spills = [], None, "spills not reported"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            rows.append(f"{name}: {m.group(1)} registers, "
                        f"{smem.group(1) if smem else 0} B shared, {spills}")
    return rows


# --- checking and timing helpers ---------------------------------------------

def check_congestion(torch, ref, cong, start, end, w, T, what):
    got = cong.congestion_many(start, end, w, T)
    want = ref.congestion_many_ref(start, end, w, T)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=CONG_RTOL, atol=CONG_ATOL,
                               msg=lambda m: f"congestion {what}: {m}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_congestion_lp(torch, ref, cong, start, end, w_all, x, T, what):
    got = cong.congestion_lp(start, end, w_all, x, T)
    want = ref.congestion_lp_ref(start, end, w_all, x, T)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=CONG_RTOL, atol=CONG_ATOL,
                               msg=lambda m: f"congestion_lp {what}: {m}")
    again = cong.congestion_lp(start, end, w_all, x, T)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"congestion_lp {what}: two launches differ")
    return float((got - want).abs().max()) if got.numel() else 0.0


def span_mask_btn(torch, start, end, T):
    """(B, T, n) float32 activity mask, built once for the bmm yardstick."""
    t_ids = torch.arange(T, device=start.device, dtype=torch.int32)
    return ((start[:, None, :] <= t_ids[None, :, None])
            & (t_ids[None, :, None] <= end[:, None, :])).float()


def device_kernels(torch, fn, reps: int = 50,
                   warmup: int = 10) -> tuple[float, list[str]]:
    """(device kernels per call, their distinct names) over ``reps``
    profiled calls."""
    names = [name for name, _ in fn_events(torch, fn, reps, warmup)]
    return len(names) / reps, sorted(set(names))


def check_fit(torch, ref, fit, rem, dem, s, e, inv, what):
    """Batched kernel vs plain version; the margin must be bit-equal."""
    got = fit.fit_scores_many(rem, dem, s, e, inv)
    want = ref.fit_scores_many_ref(rem, dem, ref.span_mask(s, e, rem.shape[2]),
                                   inv)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"fit {what}: feasibility margin not bit-equal")
    for g, w_, name in zip(got[1:], want[1:], ("dot", "norm")):
        torch.testing.assert_close(g, w_, rtol=FIT_RTOL, atol=FIT_ATOL,
                                   msg=lambda m: f"fit {what} {name}: {m}")
    return max(float((g - w_).abs().max()) for g, w_ in zip(got, want))


def check_fit1(torch, ref, fit, rem, dem, s, e, inv, what):
    """Single-instance (B=1) kernel vs plain version."""
    got = fit.fit_scores(rem, dem, s, e, inv)
    mask = ref.span_mask(torch.tensor([s]), torch.tensor([e]),
                         rem.shape[1])[0].to(rem.device)
    want = ref.fit_scores_ref(rem, dem, mask, inv)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"fit1 {what}: feasibility margin not bit-equal")
    for g, w_, name in zip(got[1:], want[1:], ("dot", "norm")):
        torch.testing.assert_close(g, w_, rtol=FIT_RTOL, atol=FIT_ATOL,
                                   msg=lambda m: f"fit1 {what} {name}: {m}")
    return max(float((g - w_).abs().max()) for g, w_ in zip(got, want))


def check_fused(torch, fused, plain, args, what):
    """The ``torch.compile`` yardstick must compute what the plain version
    does before its time means anything."""
    for g, w_, name in zip(fused(*args), plain(*args),
                           ("margin", "dot", "norm")):
        torch.testing.assert_close(g, w_, rtol=FIT_RTOL, atol=FIT_ATOL,
                                   msg=lambda m: f"{what} compiled {name}: {m}")


def device_intervals(prof):
    """(merged busy intervals (starts, stops) in ns, seconds per kernel or
    copy name, end of the last congestion kernel in ns) from a finished
    CUDA-activity profile, read straight off the profiler's raw events."""
    import numpy as np
    from torch.autograd import DeviceType

    spans, per_name, cong_end = [], collections.defaultdict(float), None
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        spans.append((ev.start_ns(), ev.end_ns()))
        per_name[ev.name()] += ev.duration_ns() / 1e9
        if "congestion_many_kernel" in ev.name():
            cong_end = max(cong_end or 0, ev.end_ns())
    if not spans:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64)), {}, None
    iv = np.array(sorted(spans), dtype=np.int64)
    ends = np.maximum.accumulate(iv[:, 1])
    # a new busy stretch starts where an interval begins after every
    # earlier one has ended
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    stops = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
    return (starts, stops), dict(per_name), cong_end


def busy_s(merged, lo=None, hi=None) -> float:
    """Busy seconds of merged intervals inside [lo, hi] (ns; None = open)."""
    import numpy as np

    starts, stops = merged
    if lo is not None:
        starts = np.maximum(starts, lo)
    if hi is not None:
        stops = np.minimum(stops, hi)
    return float(np.clip(stops - starts, 0, None).sum()) / 1e9


SENTINELS = 20  # marker kernels around a timed window (see fn_events)
PAD_LAUNCHES, PAD_S = 200, 0.05  # filler before and after the markers
PROFILE_TRIES = 5
POOL_BYTES = 24e9  # pool copies time_dispatch holds at once


def pad(torch):
    """Filler work on the card, at least PAD_LAUNCHES small kernels over at
    least PAD_S seconds, with a host wait every 20 launches."""
    buf = torch.empty(1, device="cuda")
    t0, k = time.perf_counter(), 0
    while k < PAD_LAUNCHES or time.perf_counter() - t0 < PAD_S:
        buf.fill_(k)
        k += 1
        if k % 20 == 0:
            torch.cuda.synchronize()
            time.sleep(0.002)
    torch.cuda.synchronize()


def fn_events(torch, fn, reps: int, warmup: int) -> list[tuple[str, float]]:
    """(name, device seconds) of every kernel and copy that ``reps`` calls
    of ``fn`` put on the card, from a CUDA-activity profile.  The calls sit
    between two runs of marker kernels (``torch.cuda._sleep``), and those
    between filler work (``pad``): after long traces a profile can lose
    its first or last events (up to some ms of them), which the filler
    absorbs.  A profile that lost into the window loses markers on that
    side; one that kept no marker on either side of the calls (some record
    no event at all) is discarded and taken again, up to
    ``PROFILE_TRIES`` times, and then raises rather than under-count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad(torch)
            for _ in range(SENTINELS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            for _ in range(SENTINELS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            pad(torch)
        evs = sorted((ev.start_ns(), ev.name(), ev.duration_ns() / 1e9)
                     for ev in prof.profiler.kineto_results.events()
                     if ev.device_type() == DeviceType.CUDA)
        marks = [i for i, (_, name, _) in enumerate(evs)
                 if "spin_kernel" in name]
        gaps = [i for a, i in zip(marks, marks[1:]) if i != a + 1]
        if len(gaps) == 1:
            lo = marks[marks.index(gaps[0]) - 1] + 1
            return [(name, dur) for _, name, dur in evs[lo:gaps[0]]]
        log(f"profile {attempt + 1} of {reps} timed calls lost its markers "
            f"({len(marks)} of {2 * SENTINELS} kept, at events "
            f"{marks[:1]}..{marks[-1:]} of {len(evs)}); discarded")
    raise RuntimeError(
        f"{PROFILE_TRIES} profiles of {reps} timed calls lost their markers")


def device_ms(torch, fn, reps: int = 100, warmup: int = 10) -> float:
    """Mean milliseconds of device time per call (every kernel and copy the
    call puts on the card), over ``reps`` profiled calls."""
    return sum(d for _, d in fn_events(torch, fn, reps, warmup)) * 1e3 / reps


def cuda_ms(torch, fn, reps: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call, by CUDA events around ``reps`` calls
    (host launch cost included when the calls cannot keep the card busy)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_ms(torch, fn, reps: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call on the host clock, each call synchronized."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound(nbytes: float, flops: float,
          peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def span_sum_ops(groups: int, n: int, T: int, cols: int,
                 scaled: bool = False) -> float:
    """Operations a span sum needs: one add at each task's start and one at
    its end per column (a difference array), a prefix over the T slots, and
    with ``scaled`` the x * w product per task and column."""
    return float(groups) * cols * ((3 if scaled else 2) * n + T)


def timing_line(name, info) -> str:
    lib = info["library_ms"]
    return (f"timing: {name} at {info['shape']}: device ms per call: kernel "
            f"{info['ms']:.6f}, plain {info['plain_ms']:.6f}, library "
            f"{'none' if lib is None else f'{lib:.6f}'}, bound "
            f"{info['bound_ms']:.3e} ({info['bound_by']}); wall ms per "
            f"wrapper call {info['call_ms']:.6f}; max |err| "
            f"{info['max_abs_err']:.3g}")


class Recorder:
    """Wraps a kernel wrapper to keep each distinct call shape's first
    inputs (cloned before the call) and the number of calls per shape, or
    with ``every`` every call's inputs in ``log``; the wrapped function
    still counts its own launches."""

    def __init__(self, torch, module, name, every: bool = False):
        self.torch, self.module, self.name = torch, module, name
        self.orig = getattr(module, name)
        self.calls = collections.Counter()
        self.inputs = {}
        self.every = every
        self.log = []

    def __call__(self, *args, **kwargs):
        key = tuple(tuple(a.shape) if hasattr(a, "shape") else a
                    for a in args)
        self.calls[key] += 1
        if self.every or key not in self.inputs:
            saved = tuple(a.clone() if isinstance(a, self.torch.Tensor) else a
                          for a in args)
            if self.every:
                self.log.append((saved, {k: v for k, v in kwargs.items()
                                         if k != "telemetry"}))
            else:
                self.inputs[key] = saved
        return self.orig(*args, **kwargs)

    @property
    def launches(self):
        # the wrapper counts on itself through its module-level name, which
        # is this recorder while it is installed
        return self.orig.launches

    @launches.setter
    def launches(self, value):
        self.orig.launches = value

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class LastCall:
    """Wraps a kernel wrapper to keep the last call's inputs by reference
    (the LP never writes to a tensor it has passed on, so no copy)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args = None

    def __call__(self, *args):
        self.args = args
        return self.orig(*args)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def objective_slack(a, b, tol=TOL) -> float:
    """Objective gap two tol-converged solves of one LP can show: each is
    within tol * (1 + |primal| + |dual|) of the optimum."""
    return tol * (2.0 + a.objective + a.lower_bound
                  + b.objective + b.lower_bound)


def apply_timing(torch, ref, cong, args) -> dict:
    """A recorded ``congestion_lp`` apply held against the plain version,
    then timed: kernel, plain version, ``torch.bmm`` of a prebuilt mask on a
    prebuilt x * w, and the byte/operation bound."""
    start, end, w_all, x, Tp = args
    B, n, m, D = w_all.shape
    C = m * D
    err = check_congestion_lp(torch, ref, cong, start, end, w_all, x, Tp,
                              f"B={B} n={n} m={m} D={D} T'={Tp}")
    mask = span_mask_btn(torch, start, end, Tp)
    xw = (w_all * x[..., None]).reshape(B, n, C)
    b_ms, b_by = bound(B * n * 8 + B * n * m * 4 + B * n * C * 4
                       + B * Tp * C * 4,
                       span_sum_ops(B, n, Tp, C, scaled=True))
    return {
        "shape": {"B": B, "n": n, "m": m, "D": D, "T": Tp},
        "plan": cong.launch_plan(B, n, m, D, Tp), "max_abs_err": err,
        "ms": device_ms(torch, lambda: cong.congestion_lp(start, end, w_all,
                                                          x, Tp)),
        # the plain version puts about 11 kernels on the card per call; 20
        # calls keep its profile short (long profiles lose their markers)
        "plain_ms": device_ms(torch, lambda: ref.congestion_lp_ref(
            start, end, w_all, x, Tp), reps=20, warmup=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(torch, lambda: torch.bmm(mask, xw)),
        "call_ms": cuda_ms(torch, lambda: cong.congestion_lp(
            start, end, w_all, x, Tp))}


# --- phases ------------------------------------------------------------------

def edge_checks(torch, ref, cong, fit, dev) -> dict:
    """Kernels vs plain versions at edge shapes; returns max |error|."""
    import numpy as np
    from repro_torch import kernels

    g = torch.Generator().manual_seed(1)
    err = collections.defaultdict(float)

    def spans(G, n, T):
        s = torch.randint(0, T, (G, n), generator=g, dtype=torch.int32)
        ln = torch.randint(0, max(T // 2, 1), (G, n), generator=g,
                           dtype=torch.int32)
        return s, torch.clamp(s + ln, max=T - 1)

    for G, n, T, K in [(1, 1, 1, 1), (3, 37, 1, 2), (5, 513, 33, 9),
                       (2, 256, 32, 8), (4, 1000, 24, 5), (1, 5, 200, 50),
                       (2, 5000, 24, 1)]:
        s, e = spans(G, n, T)
        w = torch.rand((G, n, K), generator=g)
        if n > 2:  # point tasks and never-active padding tasks
            e[:, 0] = s[:, 0]
            s[:, 1], e[:, 1] = 1, 0
        err["congestion_many"] = max(err["congestion_many"], check_congestion(
            torch, ref, cong, s.to(dev), e.to(dev), w.to(dev), T,
            f"G={G} n={n} T={T} K={K}"))

    for B, n, m, D, T in [(1, 1, 1, 1, 1), (1, 5, 10, 5, 24),
                          (2, 3000, 3, 2, 33), (3, 300, 10, 5, 200),
                          (2, 77, 50, 1, 24)]:
        s, e = spans(B, n, T)
        w_all = torch.rand((B, n, m, D), generator=g)
        x = torch.rand((B, n, m), generator=g)
        if n > 2:  # the pack's padding task: span [0, 0], zero weight
            s[:, 2], e[:, 2], w_all[:, 2] = 0, 0, 0.0
        err["congestion_lp"] = max(err["congestion_lp"], check_congestion_lp(
            torch, ref, cong, s.to(dev), e.to(dev), w_all.to(dev), x.to(dev),
            T, f"B={B} n={n} m={m} D={D} T={T}"))

    for B, N, T, D in [(1, 1, 1, 1), (3, 33, 1, 2), (2, 9, 300, 7),
                       (16, 41, 24, 5)]:
        rem = torch.rand((B, N, T, D), generator=g)
        dem = torch.rand((B, D), generator=g) * 0.2
        inv = 1.0 / (0.2 + torch.rand((B, D), generator=g))
        s = torch.randint(0, T, (B,), generator=g, dtype=torch.int32)
        e = torch.clamp(s + torch.randint(0, T, (B,), generator=g,
                                          dtype=torch.int32), max=T - 1)
        args = [x.to(dev) for x in (rem, dem, s, e, inv)]
        err["fit_scores_many"] = max(err["fit_scores_many"], check_fit(
            torch, ref, fit, *args, f"B={B} N={N} T={T} D={D}"))
        err["fit_scores"] = max(err["fit_scores"], check_fit1(
            torch, ref, fit, args[0][0], args[1][0], int(s[0]), int(e[0]),
            args[4][0], f"N={N} T={T} D={D}"))

    # feasibility boundary: float32 margins 0, about -1e-7 and about -2e-7,
    # with shortfalls outside the span that must not count
    T, D = 10, 2
    dem = torch.tensor([[0.5, 0.25]])
    rem = torch.stack([dem[0].expand(T, D),
                       (dem[0] - 1e-7).expand(T, D),
                       (dem[0] - 2e-7).expand(T, D)])[None].clone()
    rem[0, :, 8:, :] = 0.0  # outside the span [0, 7]
    s = torch.tensor([0], dtype=torch.int32)
    e = torch.tensor([7], dtype=torch.int32)
    inv = torch.ones((1, D))
    args = [x.to(dev) for x in (rem, dem, s, e, inv)]
    check_fit(torch, ref, fit, *args, "feasibility boundary")
    margin = fit.fit_scores_many(*args)[0].cpu()
    want = (rem[0, :, :8] - dem[0]).amin(dim=(1, 2))[None]
    if not torch.equal(margin, want):
        raise AssertionError("boundary margins differ from float32 rem - dem")
    log(f"edges: boundary margins {margin.tolist()} -> feasible "
        f"{(margin >= -1e-7).tolist()}")

    # a margin of exactly float32(-1e-7) is feasible, the next float32 below
    # it is not, through the host-facing API the placement engines call
    thr = np.float32(-1e-7)
    rem = np.stack([np.full((4, 1), thr, np.float32),
                    np.full((4, 1), np.nextafter(thr, np.float32(-1)),
                            np.float32)])[None]
    zero = np.zeros((1, 1), np.float32)
    one = np.ones((1, 1), np.float32)
    feas, _ = kernels.ops.fit_scores_many(rem, zero, [0], [3], one,
                                          device=dev)
    feas_ref, _ = kernels.ops.fit_scores_many(rem, zero, [0], [3], one,
                                              use_ref=True, device=dev)
    if feas.tolist() != [[True, False]] or feas_ref.tolist() != [[True, False]]:
        raise AssertionError(f"threshold decisions {feas} / {feas_ref}")
    log("edges: a margin of exactly float32(-1e-7) is feasible, the next "
        "float32 below is not")
    return dict(err)


def protocol_calls(batch, lp_results, fits):
    """The (algo, fit, filling, mappings) of every ``place_many`` call the
    batched protocol makes for the four paper algorithms, in its order."""
    from repro_torch.core import penalty_map

    for algo in ("penalty-map", "penalty-map-f", "lp-map", "lp-map-f"):
        if algo.startswith("penalty-map"):
            mapsets = [[penalty_map(t, kind) for t in batch.problems]
                       for kind in ("avg", "max")]
        else:
            mapsets = [[r.mapping for r in lp_results]]
        for maps in mapsets:
            for fit in fits:
                yield algo, fit, algo.endswith("-f"), maps


def stepper_work(args, kwargs, out) -> tuple[float, float]:
    """(bytes, float64 operations) one stepper launch needs on these inputs
    and its result.  Bytes: each lane's live attempts (``lens``, not the
    padded L) read once from the sequences, the per-lane operands read once,
    the node counts, infeasibility steps and every (L, A) node choice
    written once, each open pool row read once and each row the sub-phase
    debited written once.  Operations: per live step, every open node's span
    elements compared (and with similarity divided, multiplied twice and
    summed twice), the chosen row's span debited."""
    import numpy as np

    pool, w, lens, dem, s_seq, e_seq = args[:6]
    A, _, K = pool.shape
    L, _, D = dem.shape
    res = out.cpu().numpy()
    w_fin, j_rec = res[:A].astype(np.int64), res[2 * A:].reshape(L, A)
    span = ((e_seq - s_seq + 1) * D).cpu().numpy().astype(np.float64)
    w_now = w.cpu().numpy().astype(np.int64)
    lens = lens.cpu().numpy()
    per_elem = 6.0 if kwargs["similarity"] else 1.0
    ops = 0.0
    for step in range(L):
        active = step < lens
        live = j_rec[step] >= 0
        ops += float((w_now * span[step] * per_elem)[active].sum()) \
            + float(span[step][live].sum())
        if kwargs["purchase"]:
            w_now = w_now + (live & (j_rec[step] == w_now))
    lane, node = np.nonzero(j_rec.T >= 0)
    debited = len(set(zip(lane.tolist(), j_rec.T[lane, node].tolist())))
    nbytes = (float(lens.sum()) * (D * 8 + 4 + 4 + 8)   # dem, s, e, dn
              + A * (4 + 4 + 2 * D * 8)                # w, lens, capx, cap
              + A * (4 + 4) + L * A * 4                # w, bad, j_rec out
              + (float(w_fin.sum()) + debited) * K * 8)
    return nbytes, ops


def replay_dispatches(torch, ref, kstep, logged, labels) -> tuple[float, int]:
    """Replay recorded stepper dispatches (``Recorder(..., every=True)``'s
    log) on the kernel and on its plain version (``ref.sub_phase_ref``),
    each on its own copy of the inputs: node choices, counts, infeasibility
    steps and the pool after the sub-phase must be bit-equal.  Returns (max
    |pool err|, entries of [w|bad|j_rec] that differ), both 0 or it
    raises."""
    pool_err, mismatches = 0.0, 0
    for (args, kw), label in zip(logged, labels):
        got_args = [a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args]
        want_args = [a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args]
        got = kstep.sub_phase(*got_args, **kw)
        want = ref.sub_phase_ref(*want_args, kw["purchase"],
                                 kw["similarity"])
        torch.cuda.synchronize()
        p_got, p_want = got_args[0], want_args[0]
        diff = torch.where(p_got == p_want, 0.0, (p_got - p_want).abs())
        err = float(diff.max())
        bad_out = int((got != want).sum())
        pool_err, mismatches = max(pool_err, err), mismatches + bad_out
        if bad_out or not torch.equal(p_got, p_want):
            raise AssertionError(
                f"stepper {label} at pool {tuple(args[0].shape)}, "
                f"L={args[3].shape[0]}: kernel differs from plain version "
                f"(max |pool err| {err}, {bad_out} of [w|bad|j_rec] differ)")
    return pool_err, mismatches


def time_dispatch(torch, ref, kstep, args, kw) -> dict:
    """One recorded stepper dispatch timed: device ms per launch (profiled),
    the plain version's ms and the wrapper call's ms (CUDA events), its
    bound (``stepper_work``), and the pool rows each CTA kept in shared
    memory (``smem_rows``) beside the lanes whose rows outgrew them.  Every
    timed call gets a fresh copy of the pool, made before the timing; at
    most ``POOL_BYTES`` of copies at once, so a large pool is timed over
    fewer calls (at least 2)."""
    size = args[0].numel() * args[0].element_size()
    reps = max(2, min(20, int(POOL_BYTES // (size * (PROFILE_TRIES + 1)))))
    warm = min(4, reps)
    # a fresh pool per call, enough for every profile fn_events takes
    pools = [args[0].clone() for _ in range(warm + reps * PROFILE_TRIES)]
    it = iter(pools)
    ms = device_ms(torch, lambda: kstep.sub_phase(next(it), *args[1:], **kw),
                   reps=reps, warmup=warm)
    del pools, it
    # the plain version launches some 10^4 kernels per dispatch; a profile
    # of a few dispatches drops events (fn_events' markers show it), so it
    # is timed by CUDA events instead, idle gaps included
    pools_r = [args[0].clone() for _ in range(4)]
    it_r = iter(pools_r)
    plain = cuda_ms(torch, lambda: ref.sub_phase_ref(
        next(it_r), *args[1:], kw["purchase"], kw["similarity"]),
        reps=3, warmup=1)
    del pools_r, it_r
    # the wrapper call on the card's own clock, beside the profile
    pools_c = [args[0].clone() for _ in range(warm + reps)]
    it_c = iter(pools_c)
    call = cuda_ms(torch, lambda: kstep.sub_phase(next(it_c), *args[1:],
                                                  **kw),
                   reps=reps, warmup=warm)
    del pools_c, it_c
    tel: dict = {}
    out = kstep.sub_phase(args[0].clone(), *args[1:], **dict(kw, telemetry=tel))
    b_ms, b_by = bound(*stepper_work(args, kw, out), PEAK_F64_FLOPS)
    pool = args[0]
    A = pool.shape[0]
    spilled = int((out[:A] > tel["smem_rows"]).sum())
    return {"shape": {"A": A, "n_cap": pool.shape[1], "K": pool.shape[2],
                      "L": args[3].shape[0], "D": args[3].shape[2]},
            "timed_calls": reps, "ms": ms, "plain_ms": plain, "call_ms": call,
            "bound_ms": b_ms, "bound_by": b_by,
            "smem_rows": tel["smem_rows"], "spilled_lanes": spilled}


def compiled_phase(torch, np, ref, kernels, fleet, spec, res_np, tm, tn,
                   report) -> dict:
    """Phase 8: the compiled placement stepper on the fleet (see the module
    docstring).  Returns the stepper's main-path launches and its entry of
    the kernels line."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (FIT_POLICIES, FleetEngine, PlacementConfig,
                                  SolverConfig, place_many)
    from repro_torch.kernels import place_step as kstep

    engine = FleetEngine(solver=SolverConfig(operator="dense"),
                         placement=PlacementConfig(engine="compiled"))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.evaluate(fleet)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    tc = res.timings
    pc = tc["placement"]
    log(f"compiled: wall {wall:.3f} s; LP {tc['lp_s']:.3f} s, placement "
        f"{tc['place_s']:.3f} s; launches {launches}; telemetry {pc}")
    most = 6 + 6 * 2 * spec.m
    if pc["fallbacks"] != 0:
        raise AssertionError(f"compiled stepper fell back {pc['fallbacks']}x")
    if not 0 < launches["place_step"] == pc["dispatches"] <= most:
        raise AssertionError(
            f"stepper launches {launches['place_step']} vs dispatches "
            f"{pc['dispatches']} (must be equal, > 0 and <= {most})")
    if pc["modes"] != ["type-parallel", "wave-sequential"]:
        raise AssertionError(f"stepper modes {pc['modes']}")
    if any(v for k, v in launches.items() if k != "place_step"):
        raise AssertionError(f"the compiled placement launched {launches}")
    flips = []
    for i, (a, b) in enumerate(zip(res.entries, res_np.entries)):
        same_map = np.array_equal(res.lp_results[i].mapping,
                                  res_np.lp_results[i].mapping)
        for algo, c in a["costs"].items():
            if c == b["costs"][algo]:
                continue
            if algo.startswith("lp-map") and not same_map:
                flips.append((i, algo))
                continue
            raise AssertionError(
                f"instance {i} {algo}: compiled cost {c} vs batched numpy "
                f"{b['costs'][algo]}")
    log(f"compiled: every cost equals the batched numpy run's "
        f"({len(flips)} lp-map differences from LP mappings that differ "
        f"between the two dense solves: {flips})")
    log(f"compiled: placement seconds side by side: compiled "
        f"{tc['place_s']:.6f}, batched numpy {tn['place_s']:.6f}, batched "
        f"kernel {tm['place_s']:.6f}")

    # every protocol call on this run's LP results: numpy lockstep vs the
    # compiled stepper (profiled), assign and purchases bit-equal
    bucket = res.plan.buckets[0]
    if res.plan.n_buckets != 1:
        raise AssertionError("the Table-I fleet must pack into one bucket")
    batch = bucket.batch
    lp = [res.lp_results[i] for i in bucket.indices]
    calls = list(protocol_calls(batch, lp, FIT_POLICIES))
    t0 = time.perf_counter()
    sols_np = [place_many(batch, maps, fit=fit, filling=filling)
               for _, fit, filling, maps in calls]
    np_s = time.perf_counter() - t0
    tels = [{} for _ in calls]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sols_c = [place_many(batch, maps, fit=fit, filling=filling,
                             placement="compiled", telemetry=tel)
                  for (_, fit, filling, maps), tel in zip(calls, tels)]
        torch.cuda.synchronize()
        comp_s = time.perf_counter() - t0
    for (algo, fit, filling, _), a, b in zip(calls, sols_c, sols_np):
        for i, (x, y) in enumerate(zip(a, b)):
            if not (np.array_equal(x.assign, y.assign)
                    and np.array_equal(x.node_type, y.node_type)):
                raise AssertionError(
                    f"{algo} {fit} instance {i}: compiled placement differs "
                    f"from the numpy lockstep engine's")
    merged, per_name, _ = device_intervals(prof)
    busy = busy_s(merged)
    step_dev = sum(v for k, v in per_name.items() if "place_step" in k)
    n_disp = sum(t["dispatches"] for t in tels)
    idle = 1.0 - busy / comp_s if busy > 0 else None
    log(f"compiled: {len(calls)} protocol calls, every assign and purchase "
        f"equal; numpy lockstep {np_s:.6f} s, compiled (profiled) "
        f"{comp_s:.6f} s, {n_disp} launches; device busy {busy:.6f} s, idle "
        f"share {idle if idle is None else f'{idle:.4f}'}; stepper device "
        f"time {step_dev:.6f} s ({step_dev * 1e3 / max(n_disp, 1):.6f} ms "
        f"per launch)")

    # every dispatch of the four lp-map placements, kernel vs plain
    rec = Recorder(torch, kstep, "sub_phase", every=True)
    lp_maps = [r.mapping for r in lp]
    with rec:
        modes = []
        for fit in FIT_POLICIES:
            for filling in (False, True):
                tel = {}
                place_many(batch, lp_maps, fit=fit, filling=filling,
                           placement="compiled", telemetry=tel)
                modes += [(tel["mode"], fit)] * tel["dispatches"]
    t0 = time.perf_counter()
    pool_err, mismatches = replay_dispatches(
        torch, ref, kstep, rec.log, [f"{mode} {fit}" for mode, fit in modes])
    check_s = time.perf_counter() - t0
    log(f"compiled: {len(rec.log)} lp-map dispatches of all {len(fleet)} "
        f"instances replayed, kernel bit-equal to the plain version: max "
        f"|pool err| {pool_err}, {mismatches} of [w|bad|j_rec] differ "
        f"({check_s:.1f} s)")

    # the type-parallel similarity dispatch and the largest wave dispatch
    tp = next(i for i, m in enumerate(modes)
              if m == ("type-parallel", "similarity"))
    wave = max((i for i, m in enumerate(modes) if m[0] != "type-parallel"),
               key=lambda i: rec.log[i][0][0].shape[0]
               * rec.log[i][0][3].shape[0])
    per_mode = {"type-parallel": time_dispatch(torch, ref, kstep, *rec.log[tp]),
                "wave-sequential": time_dispatch(torch, ref, kstep,
                                                 *rec.log[wave])}
    for mode, info in per_mode.items():
        log(f"timing: place_step {mode} at {info['shape']}: ms per launch: "
            f"kernel {info['ms']:.6f} (device; {info['call_ms']:.6f} per "
            f"wrapper call by CUDA events), plain {info['plain_ms']:.6f} "
            f"(CUDA events), bound {info['bound_ms']:.3e} ({info['bound_by']})")
    log(f"timing: place_step main path: {launches['place_step']} launches "
        f"(evaluate), {n_disp} in the profiled protocol at "
        f"{step_dev * 1e3 / max(n_disp, 1):.6f} device ms each")
    main = per_mode["type-parallel"]
    report["compiled"] = {
        "wall_s": wall, "timings": tc, "launches": launches, "flips": flips,
        "entries": res.entries, "protocol": {
            "calls": len(calls), "numpy_s": np_s, "compiled_s": comp_s,
            "dispatches": n_disp, "device_busy_s": busy, "idle_share": idle,
            "stepper_device_s": step_dev},
        "checked_dispatches": len(rec.log), "check_s": check_s,
        "max_pool_err": pool_err, "mismatches": mismatches,
        "per_mode": per_mode,
    }
    # no single PyTorch call places
    return {"launches": launches, "kinfo": dict(
        main, max_abs_err=pool_err, mismatches=mismatches, library_ms=None,
        calls=n_disp)}


def iter_summary(np, stats) -> dict:
    """Median/max iterations and total restarts over some lanes' stats."""
    its = np.concatenate([s.iterations for s in stats])
    return {"lanes": int(its.size), "median_iters": float(np.median(its)),
            "max_iters": int(its.max()),
            "restarts": int(sum(int(s.restarts.sum()) for s in stats))}


def compare_tol_runs(np, a_res, b_res, exact=False) -> dict:
    """Hold two tol-mode evaluates of one fleet against each other: every
    lane converged in both, objectives within ``objective_slack``, each
    lower bound under the other run's objective (both are certified), and
    each instance's costs equal wherever its two LP mappings are.  With
    ``exact`` (two runs of the same arithmetic, which only ``scatter_add_``
    atomics can tell apart) every mapping and cost must be equal too.
    Returns the counts (instances whose mappings differ, tasks that differ,
    instances whose costs differ, bit-equal (objective, bound) pairs), each
    algorithm's fleet cost in both runs, and the failed checks, which the
    caller raises after printing the counts."""
    out = {"instances": len(a_res.lp_results), "mapping_differs": 0,
           "tasks_differ": 0, "cost_differs": 0, "bounds_bit_equal": 0,
           "fleet_costs": {algo: [sum(a_res.costs(algo)),
                                  sum(b_res.costs(algo))]
                           for algo in a_res.algos},
           "errors": []}
    for i, (a, b) in enumerate(zip(a_res.lp_results, b_res.lp_results)):
        if not (a.converged and b.converged):
            out["errors"].append(f"instance {i}: a lane did not converge")
        slack = objective_slack(a, b)
        if abs(a.objective - b.objective) > slack \
                or a.lower_bound > b.objective * (1 + BOUND_RTOL) \
                or b.lower_bound > a.objective * (1 + BOUND_RTOL):
            out["errors"].append(
                f"instance {i}: bounds [{a.lower_bound}, {a.objective}] vs "
                f"[{b.lower_bound}, {b.objective}] (slack {slack})")
        diff = int((a.mapping != b.mapping).sum())
        same_cost = a_res.entries[i]["costs"] == b_res.entries[i]["costs"]
        if (diff == 0 or exact) and not same_cost:
            out["errors"].append(f"instance {i}: costs differ")
        if diff and exact:
            out["errors"].append(f"instance {i}: {diff} tasks map "
                                 f"differently")
        out["mapping_differs"] += diff > 0
        out["tasks_differ"] += diff
        out["cost_differs"] += not same_cost
        out["bounds_bit_equal"] += (a.objective, a.lower_bound) == (
            b.objective, b.lower_bound)
    return out


def tol_evaluate(torch, kernels, cong, engine, problems):
    """One evaluate with the launch counts set to 0 just before and read
    just after; returns (result, wall s, launches, the last congestion_lp
    apply's arguments)."""
    with LastCall(cong, "congestion_lp") as last:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.evaluate(problems)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    return res, wall, launches, last.args


def check_tol_launches(res, launches, what):
    """A tol evaluate through the congestion kernel and the stepper: 13 +
    the most iterations congestion launches per bucket, stepper launches,
    nothing else."""
    want = sum(13 + int(s.iterations.max()) for s in res.stats)
    if launches["congestion_many"] != want:
        raise AssertionError(
            f"{what}: congestion launches {launches['congestion_many']} != "
            f"13 + max iterations per bucket = {want}")
    if launches["place_step"] <= 0 or any(
            launches[k] for k in ("fit_scores_many", "fit_scores",
                                  "two_phase")):
        raise AssertionError(f"{what}: the evaluate launched {launches}")


def lane_report(np, res) -> dict:
    """Iterations and convergence per lane, in submission order."""
    return {"iterations": [int(r.iters) for r in res.lp_results],
            "converged": [bool(r.converged) for r in res.lp_results],
            "not_converged": [i for i, r in enumerate(res.lp_results)
                              if not r.converged],
            **iter_summary(np, res.stats)}


def tol_phase(torch, np, ref, kernels, cong, fleet, res_np, tm,
              report) -> dict:
    """Phase 9: tolerance mode (see the module docstring).  Returns the tol
    evaluate's kernel launches."""
    import dataclasses

    from repro_torch.core import (FleetEngine, PlacementConfig, SolverConfig,
                                  SweepConfig, dispatch_count)
    from repro_torch.core import batch as tbatch
    from repro_torch.workload import SyntheticSpec, sweep_specs, synthetic_batch

    t_phase = time.perf_counter()
    solver = SolverConfig(tol=TOL, iters=4000, operator="pallas")
    place = PlacementConfig(engine="compiled")
    tol32 = float(np.float32(TOL))

    def timed_evaluate(engine, problems):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.evaluate(problems)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # 9.1 the tol evaluate through the congestion kernel and the stepper
    engine = FleetEngine(solver=solver, placement=place)
    res, wall, launches, last = tol_evaluate(torch, kernels, cong, engine,
                                             fleet)
    cold = iter_summary(np, res.stats)
    want = sum(13 + int(s.iterations.max()) for s in res.stats)
    log(f"tol: wall {wall:.3f} s; LP {res.timings['lp_s']:.3f} s, placement "
        f"{res.timings['place_s']:.3f} s; launches {launches}; iterations "
        f"{cold}")
    check_tol_launches(res, launches, "tol")
    for i, r in enumerate(res.lp_results):
        legacy = res_np.lp_results[i]
        if not (r.converged and r.kkt <= tol32):
            raise AssertionError(
                f"tol instance {i}: converged {r.converged}, kkt {r.kkt}")
        if r.lower_bound > legacy.objective * (1 + BOUND_RTOL) \
                or legacy.lower_bound > r.objective * (1 + BOUND_RTOL):
            raise AssertionError(
                f"tol instance {i}: bounds [{r.lower_bound}, {r.objective}] "
                f"vs legacy [{legacy.lower_bound}, {legacy.objective}]")
    log(f"tol: all {len(res.lp_results)} lanes converged (kkt <= "
        f"{tol32!r}); congestion launches {want} = 13 + max iterations; tol "
        f"and legacy certified bounds cross-hold (rel {BOUND_RTOL})")

    # the last tol-mode apply, replayed on the plain version
    start, end, w_all, x, Tp = last
    batch = res.plan.buckets[0].batch
    w_plain = torch.as_tensor(batch.weights(), dtype=torch.float32,
                              device=w_all.device)
    rows = x.sum(dim=2)
    if torch.equal(w_all, w_plain) or float((rows - 1).abs().max()) < 1e-3:
        raise AssertionError("the recorded tol apply is not Ruiz-scaled")
    e_tol = check_congestion_lp(torch, ref, cong, start, end, w_all, x, Tp,
                                "tol-mode apply")
    log(f"tol: last apply (Ruiz-scaled weights, x row sums "
        f"{float(rows.min()):.4f}..{float(rows.max()):.4f}) within rtol/atol "
        f"{CONG_RTOL} of the plain version, max |err| {e_tol:.3g}")

    # 9.2 the same evaluate with the dense operator
    dense = FleetEngine(solver=dataclasses.replace(solver, operator="dense"),
                        placement=place)
    kernels.reset_launch_counts()
    res_d, wall_d = timed_evaluate(dense, fleet)
    if kernels.launch_counts()["congestion_many"]:
        raise AssertionError("the dense tol evaluate launched the kernel")
    cmp_d = compare_tol_runs(np, res, res_d)
    log(f"tol: dense wall {wall_d:.3f} s, LP {res_d.timings['lp_s']:.3f} s; "
        f"iterations {iter_summary(np, res_d.stats)}; against pallas: "
        f"{cmp_d}")
    failed = [f"pallas vs dense {e}" for e in cmp_d["errors"]]

    # 9.3 the warm-started sweep, sequential and pipelined
    grid = synthetic_batch(sweep_specs(SyntheticSpec(), seeds=4,
                                       n=(850, 900, 950, 1000)))
    sweeps = {}
    for pipeline in (False, True):
        eng = FleetEngine(solver=solver, placement=place,
                          sweep=SweepConfig(warm_start=4, pipeline=pipeline))
        d0 = dispatch_count()
        r, w = timed_evaluate(eng, grid)
        sweeps[pipeline] = (r, w, dispatch_count() - d0)
    (seq, w_seq, d_seq), (pipe, w_pipe, d_pipe) = sweeps[False], sweeps[True]
    warm = iter_summary(np, seq.stats[1:])
    log(f"tol: sweep sequential wall {w_seq:.3f} s (LP "
        f"{seq.timings['lp_s']:.3f} s, {d_seq} dispatches), pipelined "
        f"{w_pipe:.3f} s (LP {pipe.timings['lp_s']:.3f} s, {d_pipe} "
        f"dispatch); group 0 (cold) {iter_summary(np, seq.stats[:1])}, "
        f"groups 1-3 (warm) {warm}")
    if (d_seq, d_pipe) != (4, 1):
        failed.append(f"sweep dispatches {d_seq} / {d_pipe}, want 4 / 1")
    cmp_s = compare_tol_runs(np, seq, pipe, exact=True)
    log(f"tol: sweep sequential vs pipelined: {cmp_s}")
    failed += [f"sweep sequential vs pipelined {e}" for e in cmp_s["errors"]]

    # 9.4 the tol LP alone under a marker-checked profile
    def tol_lp():
        t0 = time.perf_counter()
        out = tbatch.solve_lp_many(batch, tol=TOL, iters=4000,
                                   operator="pallas", full_output=True)
        timing["wall_s"] = time.perf_counter() - t0
        timing["iters"] = int(out[1].iterations.max())

    timing: dict = {}
    busy = idle = idle_unprof = None
    try:
        events = fn_events(torch, tol_lp, reps=1, warmup=0)
    except RuntimeError as exc:
        log(f"tol: the LP's profile failed ({exc}); busy time not measured")
    else:
        n_cong = sum("congestion_many_kernel" in name for name, _ in events)
        if n_cong != 13 + timing["iters"]:
            log(f"tol: the LP's profile kept {n_cong} of "
                f"{13 + timing['iters']} congestion kernels; busy time not "
                f"measured")
        else:
            busy = sum(d for _, d in events)
            idle = 1.0 - busy / timing["wall_s"]
            idle_unprof = 1.0 - busy / res.timings["lp_s"]
            log(f"tol: LP profiled: {len(events)} device events, busy "
                f"{busy:.6f} s of {timing['wall_s']:.3f} s, idle share "
                f"{idle:.4f} ({idle_unprof:.4f} of run 1's unprofiled LP)")
    lp_s = {"tol pallas": res.timings["lp_s"],
            "tol dense": res_d.timings["lp_s"],
            "sweep sequential": seq.timings["lp_s"],
            "sweep pipelined": pipe.timings["lp_s"],
            "legacy pallas (phase 4)": tm["lp_s"]}
    log("tol: lp_s " + ", ".join(f"{k} {v:.3f}" for k, v in lp_s.items()))
    phase_s = time.perf_counter() - t_phase
    log(f"tol: phase 9 took {phase_s:.1f} s")
    if failed:
        raise AssertionError("tol: " + "; ".join(failed))
    report["tol"] = {
        "wall_s": wall, "timings": res.timings, "launches": launches,
        "entries": res.entries, "iterations_cold": cold,
        "iterations_dense": iter_summary(np, res_d.stats),
        "iterations_sweep_cold": iter_summary(np, seq.stats[:1]),
        "iterations_sweep_warm": warm,
        "iterations_pipeline_warm": iter_summary(np, pipe.stats[1:]),
        "dense": {"wall_s": wall_d, "timings": res_d.timings,
                  "entries": res_d.entries, "against_pallas": cmp_d},
        "sweep": {"sequential_wall_s": w_seq, "pipelined_wall_s": w_pipe,
                  "dispatches": [d_seq, d_pipe], "compared": cmp_s},
        "replay_max_abs_err": e_tol, "lp_s": lp_s,
        "profiled": {"wall_s": timing.get("wall_s"), "device_busy_s": busy,
                     "idle_share": idle,
                     "idle_share_of_unprofiled_lp": idle_unprof},
        "phase_s": phase_s}
    return {"launches": launches, "max_abs_err": e_tol}


# --- phase 10: the constrained and GCT-like fleets -----------------------------

def constrained_fleet(np, fleet) -> tuple[list, list, list]:
    """Phase 10a's fleet: each Table-I instance of ``fleet`` (seed s) with
    constraints drawn by ``np.random.default_rng(1000 + s)`` over disjoint
    task sets: 40 meetable deadlines (at or after the natural finish), 16
    malleable tasks (max_width in {2, 3, 4}, serial_frac U[0, 0.6], a
    deadline between the fastest and the natural finish), 16 affinity
    groups of 3, 8 anti-affinity groups of 4 and 24 exclusive tasks.  A set
    that lowering rejects is weakened as the reference's tests do (drop
    affinity, then widths).  Returns (problems, lowerings, [(instance,
    weakening step)])."""
    import dataclasses

    from repro_torch.core import (TaskConstraints, lower_constraints,
                                  width_duration)

    problems, lows, weakened = [], [], []
    for s, p in enumerate(fleet):
        rng = np.random.default_rng(1000 + s)
        pool = list(rng.permutation(p.n))

        def pop(k):
            return [int(pool.pop()) for _ in range(k)]

        deadlines = {u: int(rng.integers(int(p.end[u]), p.T))
                     for u in pop(40)}
        widths = {}
        for u in pop(16):
            w, f = int(rng.integers(2, 5)), float(rng.uniform(0.0, 0.6))
            widths[u] = (w, f)
            dur0 = int(p.end[u] - p.start[u] + 1)
            fastest = int(p.start[u]) + int(width_duration(dur0, w, f)) - 1
            deadlines[u] = int(rng.integers(fastest, int(p.end[u]) + 1))
        affinity = {f"aff{g}": pop(3) for g in range(16)}
        anti = {f"anti{g}": pop(4) for g in range(8)}
        exclusive = pop(24)
        sets = [
            dict(deadlines=deadlines, affinity=affinity, anti_affinity=anti,
                 exclusive=exclusive, widths=widths),
            dict(deadlines=deadlines, anti_affinity=anti,
                 exclusive=exclusive, widths=widths),
            dict(deadlines={u: d for u, d in deadlines.items()
                            if u not in widths},
                 anti_affinity=anti, exclusive=exclusive),
        ]
        for step, kw in enumerate(sets):
            q = dataclasses.replace(
                p, constraints=TaskConstraints.from_groups(p.n, **kw))
            try:
                low = lower_constraints(q)
            except ValueError as exc:
                log(f"constrained: instance {s}, set {step} rejected: {exc}")
                continue
            break
        else:
            raise AssertionError(f"instance {s}: no constraint set lowers")
        if step:
            weakened.append((s, step))
        problems.append(q)
        lows.append(low)
    return problems, lows, weakened


def protocol_against_numpy(torch, np, kernels, kstep, res, what,
                           kernel_lp=False, record=None, algos=None) -> dict:
    """Every ``place_many`` call of the protocol (of ``algos`` only, when
    given), bucket by bucket, on the evaluate's own LP results: by the numpy
    lockstep engine and by the compiled stepper, every ``assign`` and
    purchase bit-equal, and each instance's best cost per algorithm equal
    to the evaluate's entry.  The
    compiled dispatches of the lp-map calls are recorded, or, with
    ``record``, those of its (algo, fit) calls only.  With ``kernel_lp`` the
    lp-map calls run once more through the fit kernel
    (``backend="kernel"``), counts set to 0 just before and read just
    after, placements bit-equal to numpy's."""
    from repro_torch.core import FIT_POLICIES, place_many

    out = {"numpy_s": 0.0, "compiled_s": 0.0, "kernel_s": 0.0, "calls": 0,
           "dispatches": [], "labels": [], "modes": [],
           "kernel_launches": None}
    best = [{} for _ in res.entries]
    kernel_calls = []
    for bucket in res.plan.buckets:
        batch = bucket.batch
        lp = [res.lp_results[i] for i in bucket.indices]
        for algo, fit, filling, maps in protocol_calls(batch, lp,
                                                       FIT_POLICIES):
            if algos is not None and algo not in algos:
                continue
            t0 = time.perf_counter()
            sols_n = place_many(batch, maps, fit=fit, filling=filling)
            out["numpy_s"] += time.perf_counter() - t0
            tel: dict = {}
            rec = Recorder(torch, kstep, "sub_phase", every=True)
            lp_call = algo.startswith("lp-map")
            keep = lp_call if record is None else (algo, fit) in record
            t0 = time.perf_counter()
            if keep:
                with rec:
                    sols_c = place_many(batch, maps, fit=fit, filling=filling,
                                        placement="compiled", telemetry=tel)
            else:
                sols_c = place_many(batch, maps, fit=fit, filling=filling,
                                    placement="compiled", telemetry=tel)
            torch.cuda.synchronize()
            out["compiled_s"] += time.perf_counter() - t0
            out["calls"] += 1
            if keep:
                out["dispatches"] += rec.log
                out["labels"] += [f"{algo} {fit} {tel['mode']}"] * len(rec.log)
                out["modes"] += [tel["mode"]] * len(rec.log)
            if lp_call and kernel_lp:
                kernel_calls.append((batch, maps, fit, filling, sols_n))
            for k, (i, a, b) in enumerate(zip(bucket.indices, sols_c,
                                              sols_n)):
                if not (np.array_equal(a.assign, b.assign)
                        and np.array_equal(a.node_type, b.node_type)):
                    raise AssertionError(
                        f"{what}: {algo} {fit} instance {i}: compiled "
                        f"placement differs from the numpy lockstep engine's")
                c = b.cost(batch.problems[k])
                best[i][algo] = min(best[i].get(algo, np.inf), c)
    for i, (entry, want) in enumerate(zip(res.entries, best)):
        if {a: entry["costs"][a] for a in want} != want:
            raise AssertionError(
                f"{what}: instance {i}: evaluate costs {entry['costs']} vs "
                f"numpy lockstep {want}")
    if kernel_lp:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for batch, maps, fit, filling, sols_n in kernel_calls:
            sols_k = place_many(batch, maps, fit=fit, filling=filling,
                                backend="kernel")
            for i, (a, b) in enumerate(zip(sols_k, sols_n)):
                if not (np.array_equal(a.assign, b.assign)
                        and np.array_equal(a.node_type, b.node_type)):
                    raise AssertionError(
                        f"{what}: lp-map {fit} filling={filling} instance "
                        f"{i}: fit-kernel placement differs from numpy's")
        torch.cuda.synchronize()
        out["kernel_s"] = time.perf_counter() - t0
        out["kernel_launches"] = kernels.launch_counts()
        if out["kernel_launches"]["fit_scores_many"] <= 0:
            raise AssertionError(f"{what}: the fit kernel never launched")
    return out


def constrained_phase(torch, np, ref, kernels, cong, fleet, report) -> dict:
    """Phase 10a: the constrained Table-I fleet (see the module docstring).
    Returns its launches per kernel and its timings at the lowered shape."""
    from repro_torch.core import (ALGORITHMS, FleetEngine, PlacementConfig,
                                  SolverConfig, check_plan, rightsize)
    from repro_torch.kernels import place_step as kstep

    t_phase = time.perf_counter()
    problems, lows, weakened = constrained_fleet(np, fleet)
    dims = sorted({low.lowered.D for low in lows})
    rows = [low.lowered.n for low in lows]
    log(f"constrained: {len(problems)} instances, {len(weakened)} constraint "
        f"sets weakened {weakened}; lowered D {dims}, rows {min(rows)}.."
        f"{max(rows)}")
    engine = FleetEngine(solver=SolverConfig(tol=TOL, iters=4000,
                                             operator="pallas"),
                         placement=PlacementConfig(engine="compiled"))
    res, wall, launches, last = tol_evaluate(torch, kernels, cong, engine,
                                             problems)
    lanes = lane_report(np, res)
    tm = res.timings
    log(f"constrained: wall {wall:.3f} s; LP {tm['lp_s']:.3f} s, placement "
        f"{tm['place_s']:.3f} s; {res.plan.n_buckets} buckets; launches "
        f"{launches}; lanes {lanes}")
    check_tol_launches(res, launches, "constrained")
    if last[2].shape[-1] not in dims:
        raise AssertionError(f"the last apply's D {last[2].shape[-1]} is not "
                             f"a lowered D {dims}")

    # rightsize, four algorithms per instance on the fleet's LP results:
    # the two_phase kernel, then numpy; the oracle on every kernel plan
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols_k = [[rightsize(q, algo, backend="kernel", check=False,
                         lp_result=r) for algo in ALGORITHMS]
              for q, r in zip(problems, res.lp_results)]
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    launches_r = kernels.launch_counts()
    t0 = time.perf_counter()
    sols_n = [[rightsize(q, algo, check=False, lp_result=r)
               for algo in ALGORITHMS]
              for q, r in zip(problems, res.lp_results)]
    numpy_s = time.perf_counter() - t0
    calls = len(problems) * (4 + 4 + 2 + 2)
    if launches_r["two_phase"] != calls or any(
            v for k, v in launches_r.items() if k != "two_phase"):
        raise AssertionError(f"constrained rightsize launched {launches_r}, "
                             f"want {calls} two_phase launches only")
    t0 = time.perf_counter()
    violations, plans = [], 0
    for i, (q, ks, ns) in enumerate(zip(problems, sols_k, sols_n)):
        for algo, a, b in zip(ALGORITHMS, ks, ns):
            if not (np.array_equal(a.assign, b.assign)
                    and np.array_equal(a.node_type, b.node_type)
                    and a.cost(q) == b.cost(q)):
                raise AssertionError(
                    f"constrained instance {i} {algo}: kernel route "
                    f"{a.cost(q)} vs numpy {b.cost(q)}")
            violations += [f"instance {i} {algo}: {v}"
                           for v in check_plan(q, a)]
            plans += 1
    check_s = time.perf_counter() - t0
    log(f"constrained: rightsize x {len(ALGORITHMS)} algorithms on "
        f"{len(problems)} instances: {launches_r['two_phase']} two_phase "
        f"launches, kernel route {kern_s:.3f} s, numpy route {numpy_s:.3f} "
        f"s, assigns and costs equal; check_plan on {plans} plans: "
        f"{len(violations)} violations ({check_s:.1f} s)")
    if violations:
        raise AssertionError("constrained: " + "; ".join(violations[:10]))

    # the lowered fleet's protocol: numpy lockstep, compiled, fit kernel
    prot = protocol_against_numpy(torch, np, kernels, kstep, res,
                                  "constrained", kernel_lp=True)
    log(f"constrained: {prot['calls']} protocol calls, compiled and numpy "
        f"lockstep placements equal, best costs equal the evaluate's; numpy "
        f"{prot['numpy_s']:.3f} s, compiled {prot['compiled_s']:.3f} s; the "
        f"lp-map calls through the fit kernel equal too ({prot['kernel_s']:.3f}"
        f" s, launches {prot['kernel_launches']})")

    # replays at the lowered shape: the last apply, every lp-map dispatch
    t0 = time.perf_counter()
    apply = apply_timing(torch, ref, cong, last)
    pool_err, mismatches = replay_dispatches(torch, ref, kstep,
                                             prot["dispatches"],
                                             prot["labels"])
    log(f"constrained: the last apply at {apply['shape']} within rtol/atol "
        f"{CONG_RTOL} of the plain version (max |err| "
        f"{apply['max_abs_err']:.3g}); {len(prot['dispatches'])} lp-map "
        f"dispatches replayed bit-equal (max |pool err| {pool_err}, "
        f"{mismatches} differ) in {time.perf_counter() - t0:.1f} s")
    tp = next(i for i, m in enumerate(prot["modes"]) if m == "type-parallel")
    step = time_dispatch(torch, ref, kstep, *prot["dispatches"][tp])
    log(timing_line("congestion_lp (constrained)", apply))
    log(f"timing: congestion_lp (constrained) launch shape {apply['plan']}")
    log(f"timing: place_step type-parallel (constrained) at {step['shape']}: "
        f"kernel {step['ms']:.6f} ms (device; {step['call_ms']:.6f} per "
        f"wrapper call), plain {step['plain_ms']:.6f} (CUDA events), bound "
        f"{step['bound_ms']:.3e} ({step['bound_by']}); smem_rows "
        f"{step['smem_rows']}, spilled lanes {step['spilled_lanes']}")
    phase_s = time.perf_counter() - t_phase
    log(f"constrained: phase 10a took {phase_s:.1f} s")
    runs = {k: launches[k] + launches_r[k] + prot["kernel_launches"][k]
            for k in launches}
    report["constrained"] = {
        "weakened": weakened, "lowered_D": dims, "rows": rows, "wall_s": wall,
        "timings": tm, "launches": launches, "lanes": lanes,
        "entries": res.entries, "rightsize": {
            "launches": launches_r, "kernel_s": kern_s, "numpy_s": numpy_s,
            "plans": plans, "violations": len(violations)},
        "protocol": {k: v for k, v in prot.items()
                     if k not in ("dispatches", "labels", "modes")},
        "replayed_dispatches": len(prot["dispatches"]),
        "apply": apply, "place_step": step, "phase_s": phase_s}
    return {"launches": runs, "apply": apply, "place_step": step,
            "max_abs_err": apply["max_abs_err"], "pool_err": pool_err}


def gct_phase(torch, np, ref, kernels, cong, report) -> dict:
    """Phase 10b: the GCT-like fleet (see the module docstring).  Returns
    its launches per kernel and its timings at T' of about 995."""
    from repro_torch.core import FleetEngine, PlacementConfig, SolverConfig
    from repro_torch.kernels import place_step as kstep
    from repro_torch.workload import gct_like_instance

    t_phase = time.perf_counter()
    problems = [gct_like_instance(n=1000, m=10, seed=s) for s in range(FLEET)]
    engine = FleetEngine(solver=SolverConfig(tol=TOL, iters=4000,
                                             operator="pallas"),
                         placement=PlacementConfig(engine="compiled"))
    res, wall, launches, last = tol_evaluate(torch, kernels, cong, engine,
                                             problems)
    lanes = lane_report(np, res)
    tm = res.timings
    tps = [b.batch.Tp for b in res.plan.buckets]
    log(f"gct: {FLEET} instances n=1000 m=10 D=2; {res.plan.n_buckets} "
        f"buckets at T' {tps}; wall {wall:.3f} s; LP {tm['lp_s']:.3f} s, "
        f"placement {tm['place_s']:.3f} s; launches {launches}; telemetry "
        f"{tm['placement']}")
    log(f"gct: lanes {lanes}")
    check_tol_launches(res, launches, "gct")
    for i, e in enumerate(res.entries):
        if not (np.isfinite(e["lb"]) and e["lb"] > 0
                and all(np.isfinite(list(e["costs"].values())))):
            raise AssertionError(f"gct instance {i}: non-finite result {e}")

    # the numpy control runs the lp-map calls (the penalty-map ones would
    # add about 15 s to the smoke); the dispatches of their similarity calls
    # are recorded: the type-parallel one (no filling) and the waves
    prot = protocol_against_numpy(
        torch, np, kernels, kstep, res, "gct",
        record={("lp-map", "similarity"), ("lp-map-f", "similarity")},
        algos=("lp-map", "lp-map-f"))
    log(f"gct: {prot['calls']} lp-map protocol calls, compiled and numpy "
        f"lockstep placements equal, best costs equal the evaluate's; numpy "
        f"{prot['numpy_s']:.3f} s, compiled {prot['compiled_s']:.3f} s")

    apply = apply_timing(torch, ref, cong, last)
    modes = prot["modes"]
    tp = next(i for i, m in enumerate(modes) if m == "type-parallel")
    wave = max((i for i, m in enumerate(modes) if m != "type-parallel"),
               key=lambda i: prot["dispatches"][i][0][0].shape[0]
               * prot["dispatches"][i][0][3].shape[0])
    pool_err, mismatches = replay_dispatches(
        torch, ref, kstep, [prot["dispatches"][i] for i in (tp, wave)],
        [prot["labels"][i] for i in (tp, wave)])
    steps = {"type-parallel": time_dispatch(torch, ref, kstep,
                                            *prot["dispatches"][tp]),
             "wave-sequential": time_dispatch(torch, ref, kstep,
                                              *prot["dispatches"][wave])}
    log(f"gct: the last apply at {apply['shape']} within rtol/atol "
        f"{CONG_RTOL} of the plain version (max |err| "
        f"{apply['max_abs_err']:.3g}); the type-parallel and the largest "
        f"wave dispatch replayed bit-equal (max |pool err| {pool_err}, "
        f"{mismatches} differ)")
    log(timing_line("congestion_lp (gct)", apply))
    log(f"timing: congestion_lp (gct) launch shape {apply['plan']}")
    for mode, info in steps.items():
        log(f"timing: place_step {mode} (gct) at {info['shape']}: kernel "
            f"{info['ms']:.6f} ms (device; {info['call_ms']:.6f} per wrapper "
            f"call), plain {info['plain_ms']:.6f} (CUDA events), bound "
            f"{info['bound_ms']:.3e} ({info['bound_by']}); smem_rows "
            f"{info['smem_rows']}, spilled lanes {info['spilled_lanes']}")
    phase_s = time.perf_counter() - t_phase
    log(f"gct: phase 10b took {phase_s:.1f} s")
    report["gct"] = {
        "T": tps, "wall_s": wall, "timings": tm, "launches": launches,
        "lanes": lanes, "entries": res.entries,
        "protocol": {k: v for k, v in prot.items()
                     if k not in ("dispatches", "labels", "modes")},
        "apply": apply, "place_step": steps, "phase_s": phase_s}
    return {"launches": launches, "apply": apply, "place_step": steps,
            "max_abs_err": apply["max_abs_err"], "pool_err": pool_err}


# --- phase 11: the serving loop ----------------------------------------------

SERVE_SPEC = dict(fleets=16, requests=160, n0=1000, m=10, seed=0)
SERVE_PUSH = 16                # replay(..., push_per_tick=...)
SERVE_CRASH_AFTER = 3          # replay_with_crash(crash_after_ticks=...)


class FirstDispatch(Recorder):
    """Keeps the inputs (cloned before the call) of the first stepper
    dispatch since ``log`` was last emptied: one pool copy at a time."""

    def __call__(self, *args, **kwargs):
        if not self.log:
            saved = tuple(a.clone() if isinstance(a, self.torch.Tensor) else a
                          for a in args)
            self.log.append((saved, {k: v for k, v in kwargs.items()
                                     if k != "telemetry"}))
        return self.orig(*args, **kwargs)


def start_slots(np, problem):
    """``problem`` (unconstrained) on the slots where one of its tasks
    starts, each task ending at the last such slot at or before its end.  A
    node's load rises only where a task starts, so ``check_plan`` finds a
    plan over capacity here exactly where it would on the whole timeline,
    whose scan walks every one of a GCT-like fleet's 86400 slots for every
    node in Python."""
    import dataclasses

    if problem.constraints is not None:
        raise ValueError("start_slots keeps no constraint semantics")
    slots = np.unique(problem.start)
    return dataclasses.replace(
        problem, start=np.searchsorted(slots, problem.start),
        end=np.searchsorted(slots, problem.end, side="right") - 1,
        T=len(slots))


def serve_engine():
    """The serving loop's card configuration: the congestion kernel on every
    LP apply, the compiled stepper on every placement sub-phase."""
    from repro_torch.core import FleetEngine, PlacementConfig, SolverConfig

    return FleetEngine(solver=SolverConfig(tol=TOL, iters=4000,
                                           operator="pallas"),
                       placement=PlacementConfig(engine="compiled"),
                       algos=("lp-map-f",))


def probed_replay(torch, kernels, svc, trace, cong, kstep):
    """``replay`` with each tick probed: its record, launches per kernel
    (the counts read before and after it), the compiled placement's
    telemetry and, for the last tick that solved, its placement calls'
    inputs and results, its last ``congestion_lp`` apply and its first
    stepper dispatch.  Returns (report, [per-tick dict], those probes)."""
    from repro_torch.core import engine as eng_mod
    from repro_torch.serve import replay

    ticks, cur, solved = [], {}, {}
    place, tick = eng_mod.place_many, svc.tick

    def placed(batch, maps, **kw):
        tel: dict = {}
        sols = place(batch, maps, telemetry=tel, **kw)
        cur["place"].append((batch, maps, kw, sols, tel))
        return sols

    def probed_tick():
        cur.clear()
        cur["place"] = []
        first.log = []
        before = kernels.launch_counts()
        rec = tick()
        after = kernels.launch_counts()
        if rec is not None:
            ticks.append({"record": rec,
                          "launches": {k: after[k] - before[k]
                                       for k in after},
                          "telemetry": [c[4] for c in cur["place"]]})
            if rec.dispatches:
                solved.clear()
                solved.update(place=cur["place"], apply=last.args,
                              dispatch=list(first.log))
        return rec

    eng_mod.place_many = placed
    svc.tick = probed_tick
    try:
        with LastCall(cong, "congestion_lp") as last, \
                FirstDispatch(torch, kstep, "sub_phase") as first:
            rep = replay(svc, trace, push_per_tick=SERVE_PUSH)
    finally:
        eng_mod.place_many = place
        del svc.tick
    return rep, ticks, solved


def serve_phase(torch, np, ref, kernels, cong, report) -> dict:
    """Phase 11: the serving loop (see the module docstring).  Returns the
    warm replay's launches per kernel."""
    import tempfile

    from repro_torch.core import check_plan, place_many
    from repro_torch.kernels import place_step as kstep
    from repro_torch.serve import (RightsizingService, ServiceConfig,
                                   TraceSpec, gct_trace, replay,
                                   replay_with_crash)

    t_phase = time.perf_counter()
    trace = gct_trace(TraceSpec(**SERVE_SPEC))
    log(f"serve: gct_trace {SERVE_SPEC}: {len(trace)} requests, "
        f"replay(push_per_tick={SERVE_PUSH}) under ServiceConfig()")

    svc = RightsizingService(engine=serve_engine())
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep, ticks, last = probed_replay(torch, kernels, svc, trace, cong, kstep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    cold_svc = RightsizingService(engine=serve_engine(),
                                  config=ServiceConfig(warm_start=False))
    cold = replay(cold_svc, trace, push_per_tick=SERVE_PUSH)
    cold_wall = time.perf_counter() - t0

    for label, r in (("warm", rep), ("cold", cold)):
        log(f"serve: {label} replay: ticks {r['ticks']}, requests "
            f"{r['requests']}, requests_per_s {r['requests_per_s']}, p50 "
            f"{r['p50_replan_s']} s, p99 {r['p99_replan_s']} s, median "
            f"iterations warm {r['median_iters_warm']} cold "
            f"{r['median_iters_cold']} admit {r['median_iters_admit']}, "
            f"converged_frac {r['converged_frac']}, dispatches_per_tick "
            f"{r['dispatches_per_tick']}, total_cost {r['total_cost']}, "
            f"proposed_cost_total {r['proposed_cost_total']}")
        if r["dispatches_per_tick"] != 1 or r["converged_frac"] != 1.0:
            raise AssertionError(f"serve {label}: {r}")
    log(f"serve: warm replay wall {wall:.3f} s, cold {cold_wall:.3f} s; "
        f"launches {launches}")
    rows = []
    for t in ticks:
        rec, got = t["record"], t["launches"]
        dispatches = sum(tel.get("dispatches", 0) for tel in t["telemetry"])
        rows.append({"tick": rec.tick, "solve_s": rec.solve_s,
                     "place_s": rec.place_s, "lanes": len(rec.iters),
                     "warm_lanes": rec.warm_lanes,
                     "max_iters": max(rec.iters, default=0),
                     "congestion": got["congestion_many"],
                     "place_step": got["place_step"],
                     "dispatches": dispatches})
        log(f"serve: tick {rec.tick}: solve_s {rec.solve_s:.4f} place_s "
            f"{rec.place_s:.4f}, lanes {len(rec.iters)} (warm "
            f"{rec.warm_lanes}), iterations {list(rec.iters)}, congestion "
            f"launches {got['congestion_many']}, stepper launches "
            f"{got['place_step']}")
        want = 13 + max(rec.iters) if rec.dispatches else 0
        if got["congestion_many"] != want:
            raise AssertionError(
                f"serve tick {rec.tick}: {got['congestion_many']} congestion "
                f"launches, want 13 + max iterations = {want}")
        if any(tel.get("engine") != "compiled" for tel in t["telemetry"]) \
                or got["place_step"] != dispatches:
            raise AssertionError(
                f"serve tick {rec.tick}: {got['place_step']} stepper "
                f"launches vs telemetry {t['telemetry']}")
        if any(got[k] for k in ("fit_scores_many", "fit_scores",
                                "two_phase")):
            raise AssertionError(f"serve tick {rec.tick}: launched {got}")
    if launches["place_step"] <= 0 or launches["congestion_many"] <= 0:
        raise AssertionError(f"serve: the kernels never launched: {launches}")
    warm_med, cold_med = rep["median_iters_warm"], cold["median_iters_cold"]
    if warm_med is None or cold_med is None or not warm_med < cold_med:
        raise AssertionError(
            f"serve: median warm iterations {warm_med} not below the cold "
            f"control's {cold_med}")
    drift = abs(rep["proposed_cost_total"] - cold["proposed_cost_total"]) \
        / cold["proposed_cost_total"] * 100.0
    if drift > ServiceConfig().cost_drift_bound_pct:
        raise AssertionError(f"serve: warm/cold drift {drift:.3f}%")
    for label, s in (("warm", svc), ("cold", cold_svc)):
        for name in s.fleets:
            st = s._fleets[name]
            bad = check_plan(start_slots(np, st.problem), st.solution)
            if bad:
                raise AssertionError(f"serve {label} {name}: {bad[:3]}")
    log(f"serve: warm/cold proposed cost drift {drift:.4f}% (bound "
        f"{ServiceConfig().cost_drift_bound_pct}%); {len(svc.fleets)} + "
        f"{len(cold_svc.fleets)} adopted plans clean under check_plan")

    # the last tick that solved: placements, its last apply and one stepper
    # dispatch against the numpy engine and the plain versions
    for batch, maps, kw, sols, _ in last["place"]:
        want = place_many(batch, maps, fit=kw["fit"], filling=kw["filling"])
        for b, (g, w) in enumerate(zip(sols, want)):
            if not (np.array_equal(g.assign, w.assign)
                    and np.array_equal(g.node_type, w.node_type)):
                raise AssertionError(
                    f"serve last tick {kw['fit']} lane {b}: compiled "
                    f"placement differs from the numpy lockstep engine's")
    start, end, w_all, x, Tp = last["apply"]
    B, n, m, D = w_all.shape
    apply_err = check_congestion_lp(torch, ref, cong, start, end, w_all, x,
                                    Tp, f"serve B={B} n={n} m={m} D={D} "
                                        f"T'={Tp}")
    pool_err, mismatches = replay_dispatches(
        torch, ref, kstep, last["dispatch"], ["serve last tick"])
    log(f"serve: last tick: {len(last['place'])} placement calls equal to "
        f"the numpy lockstep engine's; last apply at B={B} n={n} m={m} "
        f"D={D} T'={Tp} within rtol/atol {CONG_RTOL} of the plain version "
        f"(max |err| {apply_err:.3g}); first stepper dispatch (pool "
        f"{tuple(last['dispatch'][0][0][0].shape)}) bit-equal to the plain "
        f"version (max |pool err| {pool_err}, {mismatches} differ)")
    last.clear()

    # crash and recover: the same trace, snapshot after three ticks
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as snap:
        crash, crashed = replay_with_crash(
            RightsizingService(engine=serve_engine()), trace,
            crash_after_ticks=SERVE_CRASH_AFTER, snapshot_dir=snap,
            push_per_tick=SERVE_PUSH)
    crash_wall = time.perf_counter() - t0
    log(f"serve: crash after {SERVE_CRASH_AFTER} ticks and restore: "
        f"total_cost {crash['total_cost']} proposed_cost_total "
        f"{crash['proposed_cost_total']} (uninterrupted {rep['total_cost']}, "
        f"{rep['proposed_cost_total']}); {crash_wall:.3f} s")
    if not crashed or crash["total_cost"] != rep["total_cost"] or \
            crash["proposed_cost_total"] != rep["proposed_cost_total"]:
        raise AssertionError(
            f"serve: the recovered replay differs: {crash} vs {rep}")
    phase_s = time.perf_counter() - t_phase
    log(f"serve: phase 11 took {phase_s:.1f} s")
    report["serve"] = {
        "spec": SERVE_SPEC, "push_per_tick": SERVE_PUSH, "warm": rep,
        "cold": cold, "crash": crash, "warm_wall_s": wall,
        "cold_wall_s": cold_wall, "crash_wall_s": crash_wall,
        "ticks": rows, "launches": launches, "drift_pct": drift,
        "apply_max_abs_err": apply_err, "phase_s": phase_s}
    return {"launches": launches, "max_abs_err": apply_err}


def walk_work(args, work) -> tuple[float, float]:
    """(bytes, float64 operations) one two_phase launch needs on these
    inputs, with ``work`` the plain version's tally of the same launch.
    Bytes: the walk, the phase bounds and capacities, every task's demand,
    span and norm read once, the result written once.  Operations: the
    comparisons the attempts need (each node's up to its first violation;
    first fit stops at the first node that fits), five more per element of
    each feasible node a similarity attempt scores (a divide, two
    multiplies, two adds) and each placement's debit."""
    walk, bounds, cap, dem = args[:4]
    P, D = cap.shape
    n = dem.shape[0]
    nbytes = (walk.numel() * 4 + P * 3 * 4 + P * D * 8 + n * D * 8
              + n * (4 + 4 + 8) + (3 * P + 2 * n) * 4)
    ops = work["scored"] + 5 * work["similar"] + work["debited"]
    return float(nbytes), float(ops)


def chain_ns_per_step(torch, dev, steps: int = 1 << 17) -> float:
    """Device ns per step of ``place_step.cu``'s barrier chain: one block
    barrier and one shared-memory hand-over by a CTA shaped as the
    two_phase kernel's, the least an attempt of its serial chain costs."""
    from repro_torch.kernels import build

    lib = build.load("place_step")
    out = torch.zeros(1, dtype=torch.int32, device=dev)

    def fn(n=steps):
        err = lib.barrier_chain_launch(
            n, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"barrier chain launch failed: CUDA error "
                               f"{err}")

    fn()
    if int(out.item()) != steps:
        raise AssertionError(f"barrier chain returned {int(out.item())}, "
                             f"want {steps}")
    return device_ms(torch, fn, reps=5, warmup=1) * 1e6 / steps


def single_phase(torch, np, ref, kernels, fleet, res, report) -> dict:
    """Phase 7: the single-instance path (see the module docstring).
    Returns its launches and the two_phase kernel's entry of the kernels
    line."""
    from repro_torch.core import ALGORITHMS, rightsize, verify
    from repro_torch.kernels import place_step as kstep

    p0, lp0 = fleet[0], res.lp_results[0]
    trimmed = res.plan.buckets[0].batch.problems[0]

    def run(algo, backend):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = rightsize(p0, algo, backend=backend, lp_result=lp0)
        torch.cuda.synchronize()
        return sol, time.perf_counter() - t0

    rec = Recorder(torch, kstep, "two_phase_walk", every=True)
    with rec:
        kernels.reset_launch_counts()
        kern = {algo: run(algo, "kernel") for algo in ALGORITHMS}
        launches = kernels.launch_counts()
    numpy_ = {algo: run(algo, "numpy") for algo in ALGORITHMS}
    for algo in ALGORITHMS:
        (a, wa), (b, wb) = kern[algo], numpy_[algo]
        verify(trimmed, a)
        if a.cost(p0) != b.cost(p0) or not (
                np.array_equal(a.assign, b.assign)
                and np.array_equal(a.node_type, b.node_type)):
            raise AssertionError(
                f"single {algo}: kernel route cost {a.cost(p0)} vs numpy "
                f"{b.cost(p0)}, or a different assign")
        log(f"single: rightsize({algo}) cost {a.cost(p0)} on both routes; "
            f"wall kernel {wa:.6f} s, numpy {wb:.6f} s (first call)")
    want = res.entries[0]["costs"]["lp-map-f"]
    if kern["lp-map-f"][0].cost(p0) != want:
        raise AssertionError(
            f"single lp-map-f cost {kern['lp-map-f'][0].cost(p0)} != fleet "
            f"{want}")
    calls = 4 + 4 + 2 + 2  # two_phase calls of the four algorithms
    log(f"single: launches {launches}; {len(rec.log)} two_phase calls")
    if launches["two_phase"] != calls or len(rec.log) != calls:
        raise AssertionError(
            f"two_phase launches {launches['two_phase']}, calls "
            f"{len(rec.log)}; want {calls} of each")
    if any(v for k, v in launches.items() if k != "two_phase"):
        raise AssertionError(f"the single-instance path launched {launches}")

    # every launch again, on the kernel and on the plain version (CPU)
    t0 = time.perf_counter()
    works, steps = [], []
    max_err = mismatches = 0
    for i, (args, kw) in enumerate(rec.log):
        got = kstep.two_phase_walk(*args, **kw).cpu()
        work: dict = {}
        want_out = ref.two_phase_ref(
            *[a.cpu() if isinstance(a, torch.Tensor) else a for a in args],
            kw["similarity"], kw["sequential"], kw["rows"], work=work)
        P, n = args[2].shape[0], args[3].shape[0]
        diff = int((got != want_out).sum())
        max_err = max(max_err, int((got.long() - want_out.long()).abs()
                                   .max()))
        mismatches += diff
        if diff:
            raise AssertionError(
                f"two_phase launch {i} ({kw}): {diff} of "
                f"[w|bad|steps|phase|node] differ from the plain version")
        works.append(work)
        steps.append(int(kstep.split_walk(want_out, P, n)[2].sum()))
    check_s = time.perf_counter() - t0
    log(f"single: {len(rec.log)} launches replayed, kernel bit-equal to the "
        f"plain version (max |kernel - plain| {max_err}, {mismatches} "
        f"entries differ); attempts per launch {steps} ({check_s:.1f} s)")
    chain_ns = chain_ns_per_step(torch, args[0].device)
    log(f"single: barrier chain {chain_ns:.3f} device ns per step (one block "
        f"barrier and one shared-memory hand-over, {1 << 17} steps)")

    def timed(idx):
        args, kw = rec.log[idx]
        fn = lambda: kstep.two_phase_walk(*args, **kw)  # noqa: E731
        ms = device_ms(torch, fn, reps=20, warmup=3)
        plain = cuda_ms(torch, lambda: ref.two_phase_ref(
            *args, kw["similarity"], kw["sequential"], kw["rows"]),
            reps=2, warmup=1)
        call = cuda_ms(torch, fn, reps=20, warmup=3)
        b_ms, b_by = bound(*walk_work(args, works[idx]), PEAK_F64_FLOPS)
        info = {"telemetry": {}}
        kstep.two_phase_walk(*args, **kw, telemetry=info["telemetry"])
        return {"shape": {"n": args[3].shape[0], "P": args[2].shape[0],
                          "T": args[7], "D": args[3].shape[1],
                          "E": args[0].shape[0], **kw,
                          "smem_rows": info["telemetry"]["smem_rows"]},
                "steps": steps[idx], "ms": ms, "plain_ms": plain,
                "call_ms": call, "bound_ms": b_ms, "bound_by": b_by,
                "latency_bound_ms": steps[idx] * chain_ns * 1e-6,
                "ns_per_step": ms * 1e6 / max(steps[idx], 1)}

    # lp-map-f's two launches (first, then similarity fit)
    per_fit = {("similarity" if rec.log[i][1]["similarity"] else "first"):
               timed(i) for i in (calls - 2, calls - 1)}
    for fit_name, info in per_fit.items():
        log(f"timing: two_phase lp-map-f {fit_name} at {info['shape']}: ms "
            f"per launch: kernel {info['ms']:.6f} (device; "
            f"{info['call_ms']:.6f} per wrapper call by CUDA events), plain "
            f"{info['plain_ms']:.6f} (CUDA events), bound "
            f"{info['bound_ms']:.3e} ({info['bound_by']}), latency bound "
            f"{info['latency_bound_ms']:.6f} ({info['steps']} attempts x "
            f"{chain_ns:.3f} ns barrier chain); {info['ns_per_step']:.1f} "
            f"device ns per attempt")

    # rightsize(lp-map-f) by both routes, in turns
    walls = {"kernel": [], "numpy": []}
    for backend in ("kernel", "numpy", "numpy", "kernel",
                    "kernel", "numpy"):
        walls[backend].append(run("lp-map-f", backend)[1])
    log(f"single: rightsize(lp-map-f) wall s, in turns: kernel "
        f"{walls['kernel']}, numpy {walls['numpy']}")
    report["single"] = {
        "costs": {a: kern[a][0].cost(p0) for a in ALGORITHMS},
        "first_wall_s": {a: {"kernel": kern[a][1], "numpy": numpy_[a][1]}
                         for a in ALGORITHMS},
        "lp_map_f_wall_s": walls, "launches": launches, "attempts": steps,
        "check_s": check_s, "per_fit": per_fit,
        "chain_ns_per_step": chain_ns, "replay_max_abs_err": max_err,
        "replay_mismatches": mismatches}
    main = per_fit["similarity"]
    # no single PyTorch call places
    return {"launches": launches, "kinfo": dict(
        main, max_abs_err=float(max_err), library_ms=None, calls=calls)}


def fit1_timing(torch, np, ref, fit, p0, dev, edge_err) -> dict:
    """The B=1 fit kernel at the shape the per-task route gave it on
    instance 0 (N=2 open nodes, T'=23, D=5, a span of 2 slots): held
    against its plain version, then timed beside the plain version fused
    by ``torch.compile`` (a yardstick only)."""
    from repro_torch.core import trim_timeline

    t = trim_timeline(p0)[0]
    g = np.random.default_rng(7)
    cap = t.node_types.cap[0]
    rem = cap[None, None, :] - g.random((2, t.T, t.D)) * 0.3 * cap
    rem1 = torch.as_tensor(rem, dtype=torch.float32, device=dev)
    dem1 = torch.as_tensor(t.dem[0], dtype=torch.float32, device=dev)
    inv1 = torch.as_tensor(1.0 / cap, dtype=torch.float32, device=dev)
    s1, e1 = 5, 6
    e_1 = check_fit1(torch, ref, fit, rem1, dem1, s1, e1, inv1,
                     "single-path shape")
    N1, T1, D1 = rem1.shape
    sp1 = e1 - s1 + 1
    b_ms, b_by = bound(N1 * sp1 * D1 * 4 + (2 * D1) * 4 + 3 * N1 * 4,
                       8.0 * N1 * sp1 * D1)
    mask1 = ref.span_mask(torch.tensor([s1]), torch.tensor([e1]),
                          T1)[0].to(dev)
    fused1 = torch.compile(ref.fit_scores_ref, fullgraph=True, dynamic=False)
    check_fused(torch, fused1, ref.fit_scores_ref, (rem1, dem1, mask1, inv1),
                "fit_scores")
    return {
        "shape": {"N": N1, "T": T1, "D": D1, "span": sp1}, "calls": 0,
        "max_abs_err": max(e_1, edge_err),
        "ms": device_ms(torch, lambda: fit.fit_scores(rem1, dem1, s1, e1,
                                                        inv1)),
        "plain_ms": device_ms(
            torch, lambda: ref.fit_scores_ref(rem1, dem1, mask1, inv1)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(torch,
                                lambda: fused1(rem1, dem1, mask1, inv1)),
        "call_ms": cuda_ms(
            torch, lambda: fit.fit_scores(rem1, dem1, s1, e1, inv1)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    import os

    # torch.compile (the fit yardstick) caches its kernels in the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(HERE / "build" / sub))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 2
    if not (HERE / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2

    from repro_torch import kernels
    from repro_torch.core import FleetEngine, PlacementConfig, SolverConfig
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import congestion as cong
    from repro_torch.kernels import fit
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report: dict = {}

    # 1. card
    card = card_line()
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    report["card"] = card

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.2f} s")
    for name, text in logs.items():
        for row in ptxas_summary(text):
            log(f"build: {name}.cu {row}")

    # 3. edges
    err = edge_checks(torch, ref, cong, fit, dev)
    log(f"edges: max |kernel - plain| {err}")

    # 4. main path
    spec = SyntheticSpec()  # Table I: n=1000, m=10, D=5, T=24
    fleet = [synthetic_instance(SyntheticSpec(seed=s)) for s in range(FLEET)]
    log(f"main: {FLEET} Table-I instances n={spec.n} m={spec.m} D={spec.D} "
        f"T={spec.T}, iters=2000")
    engine = FleetEngine(solver=SolverConfig(operator="pallas"),
                         placement=PlacementConfig(backend="kernel"))
    with Recorder(torch, cong, "congestion_lp") as rec_c, \
            Recorder(torch, fit, "fit_scores_many") as rec_f:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.evaluate(fleet)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    buckets = res.plan.n_buckets
    log(f"main: launches {launches}, buckets {buckets}")
    if launches["congestion_many"] != buckets * 2013:
        raise AssertionError(
            f"congestion launches {launches['congestion_many']} != "
            f"{buckets} buckets x 2013")
    if sum(rec_c.calls.values()) != launches["congestion_many"]:
        raise AssertionError(
            f"{sum(rec_c.calls.values())} LP applies through congestion_lp "
            f"vs {launches['congestion_many']} congestion launches")
    if launches["fit_scores_many"] <= 0:
        raise AssertionError("the batched fit kernel never launched")
    tm = res.timings
    log(f"main: wall {wall:.3f} s; pack {tm['pack_s']:.3f} s, LP "
        f"{tm['lp_s']:.3f} s, placement {tm['place_s']:.3f} s "
        f"({tm['placement']['calls']} place_many calls)")

    # the same evaluate again under the profiler, for the card's busy time
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res_p = engine.evaluate(fleet)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    merged, per_name, cong_end = device_intervals(prof)
    busy = busy_s(merged)
    tp = res_p.timings
    if busy > 0:
        idle_p, idle = 1.0 - busy / wall_p, 1.0 - busy / wall
        # the LP phase ends with its last congestion launch on the card
        busy_lp, busy_place = busy_s(merged, hi=cong_end), \
            busy_s(merged, lo=cong_end)
        idle_lp = 1.0 - busy_lp / tp["lp_s"]
        idle_place = 1.0 - busy_place / tp["place_s"]
        log(f"profiled: wall {wall_p:.3f} s (LP {tp['lp_s']:.3f} s, "
            f"placement {tp['place_s']:.3f} s); device busy {busy:.4f} s "
            f"(LP {busy_lp:.4f} s, placement {busy_place:.4f} s); idle share "
            f"{idle_p:.4f} of the profiled wall ({idle:.4f} of the "
            f"unprofiled wall), LP {idle_lp:.4f}, placement "
            f"{idle_place:.4f}")
    else:
        idle_p = idle = idle_lp = idle_place = None
        log("profiled: the profiler recorded no device time; idle share "
            "not measured")
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    for key, sec in top:
        log(f"profiled: device time {sec:.4f} s  {key[:90]}")
    for i, (entry, p) in enumerate(zip(res.entries, fleet)):
        if not all(np.isfinite(list(entry["costs"].values()))) \
                or not np.isfinite(entry["lb"]) or entry["lb"] <= 0:
            raise AssertionError(f"instance {i}: non-finite result {entry}")
        log(f"main: instance {i} lb {entry['lb']:.6f} costs "
            + " ".join(f"{a}={c:.6f}" for a, c in entry["costs"].items())
            + " normalized "
            + " ".join(f"{a}={v:.4f}" for a, v in entry["normalized"].items()))
    report["main"] = {
        "instances": FLEET, "wall_s": wall, "timings": tm, "launches": launches,
        "entries": res.entries,
        "profiled": {"wall_s": wall_p, "timings": tp,
                     "device_busy_s": busy, "idle_share": idle_p,
                     "idle_share_of_unprofiled_wall": idle,
                     "idle_share_lp": idle_lp,
                     "idle_share_placement": idle_place,
                     "device_time_s": dict(top)},
    }

    # 5. kernels on the main path's own inputs
    from repro_torch.core import batch as tbatch

    kinfo = {}
    calls_c = sum(rec_c.calls.values())
    e_c = max(check_congestion_lp(torch, ref, cong, *a, "main-path input")
              for a in rec_c.inputs.values())
    key_c, n_c = rec_c.calls.most_common(1)[0]
    start, end, w_all, x, Tp = rec_c.inputs[key_c]
    B, n, m, D = w_all.shape
    info = apply_timing(torch, ref, cong, rec_c.inputs[key_c])
    kinfo["congestion_lp"] = dict(
        info, calls=calls_c,
        max_abs_err=max(e_c, info["max_abs_err"], err["congestion_lp"]))

    # one forward apply of the LP operator on these inputs: pallas (one
    # launch), dense, and the three launches the pallas apply made before
    # (x permuted, w * x written out, the kernel over B*m groups)
    fwd_p, _ = tbatch._make_operators(w_all, start, end, Tp, "pallas")
    fwd_d, _ = tbatch._make_operators(w_all, start, end, Tp, "dense")
    start_g = start.repeat_interleave(m, dim=0).contiguous()
    end_g = end.repeat_interleave(m, dim=0).contiguous()
    w_g = w_all.permute(0, 2, 1, 3).reshape(B * m, n, D)

    def three_launch_apply():
        x_g = x.permute(0, 2, 1).reshape(B * m, n)
        cong_g = cong.congestion_many(start_g, end_g,
                                      (w_g * x_g[:, :, None]).contiguous(), Tp)
        return cong_g.reshape(B, m, Tp, D).permute(0, 2, 1, 3)

    torch.testing.assert_close(fwd_p(x), fwd_d(x), rtol=CONG_RTOL,
                               atol=CONG_ATOL,
                               msg=lambda msg: f"pallas vs dense apply: {msg}")
    torch.testing.assert_close(fwd_p(x), three_launch_apply(), rtol=CONG_RTOL,
                               atol=CONG_ATOL,
                               msg=lambda msg: f"one vs three launches: {msg}")
    applies = {}
    for name, fn in (("pallas", lambda: fwd_p(x)), ("dense", lambda: fwd_d(x)),
                     ("three_launch", three_launch_apply)):
        k, names = device_kernels(torch, fn)
        applies[name] = {"device_kernels": k, "ms": device_ms(torch, fn),
                         "kernel_names": names}
    pallas = applies["pallas"]
    if pallas["device_kernels"] != 1 or len(pallas["kernel_names"]) != 1 \
            or "congestion_many_kernel" not in pallas["kernel_names"][0]:
        raise AssertionError(
            f"a pallas forward apply ran {pallas['device_kernels']} device "
            f"kernels: {pallas['kernel_names']}")
    for name, info in applies.items():
        log(f"apply: {name} forward at B={B} n={n} m={m} D={D} T'={Tp}: "
            f"{info['device_kernels']:g} device kernels, {info['ms']:.6f} "
            f"device ms per apply")
    report["applies"] = applies

    # the TPU contract at the groups the LP's apply once made: G = B*m
    w_gc = (w_g * x.permute(0, 2, 1).reshape(B * m, n)[:, :, None]).contiguous()
    G, K = B * m, D
    e_g = check_congestion(torch, ref, cong, start_g, end_g, w_gc, Tp,
                           f"G={G}")
    mask_g = span_mask_btn(torch, start_g, end_g, Tp)
    b_ms, b_by = bound(G * n * (8 + 4 * K) + G * Tp * K * 4,
                       span_sum_ops(G, n, Tp, K))
    kinfo["congestion_many"] = {
        "shape": {"G": G, "n": n, "T": Tp, "K": K}, "calls": 0,
        "plan": cong.launch_plan(G, n, 1, K, Tp, lp=False),
        "max_abs_err": max(e_g, err["congestion_many"]),
        "ms": device_ms(torch, lambda: cong.congestion_many(start_g, end_g,
                                                            w_gc, Tp)),
        "plain_ms": device_ms(torch, lambda: ref.congestion_many_ref(
            start_g, end_g, w_gc, Tp)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(torch, lambda: torch.bmm(mask_g, w_gc)),
        "call_ms": cuda_ms(torch, lambda: cong.congestion_many(
            start_g, end_g, w_gc, Tp)),
    }

    # the G=1 launch (the reference's congestion_pallas) at one instance's
    # own tasks: n=1000, T'=24, K=5
    p0 = fleet[0]
    s1c = torch.as_tensor(p0.start, dtype=torch.int32, device=dev)
    e1c = torch.as_tensor(p0.end, dtype=torch.int32, device=dev)
    w1c = torch.as_tensor(p0.dem, dtype=torch.float32, device=dev)
    T1c = int(p0.T)
    e_g1 = check_congestion(torch, ref, cong, s1c[None], e1c[None], w1c[None],
                            T1c, "G=1")
    mask1c = span_mask_btn(torch, s1c[None], e1c[None], T1c)
    n1c, K1c = w1c.shape
    b_ms, b_by = bound(n1c * (8 + 4 * K1c) + T1c * K1c * 4,
                       span_sum_ops(1, n1c, T1c, K1c))
    kinfo["congestion"] = {
        "shape": {"G": 1, "n": n1c, "T": T1c, "K": K1c}, "calls": 0,
        "plan": cong.launch_plan(1, n1c, 1, K1c, T1c, lp=False),
        "max_abs_err": e_g1,
        "ms": device_ms(torch, lambda: cong.congestion(s1c, e1c, w1c, T1c)),
        "plain_ms": device_ms(
            torch, lambda: ref.congestion_ref(s1c, e1c, w1c, T1c)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(torch, lambda: torch.bmm(mask1c, w1c[None])),
        "call_ms": cuda_ms(
            torch, lambda: cong.congestion(s1c, e1c, w1c, T1c)),
    }

    calls_f = sum(rec_f.calls.values())
    e_f = max(check_fit(torch, ref, fit, *a, "main-path input")
              for a in rec_f.inputs.values())
    key_f, n_f = rec_f.calls.most_common(1)[0]
    rem, dem, s, e, inv = rec_f.inputs[key_f]
    Bf, N, Tf, D = rem.shape
    span = int((e - s + 1).sum())
    b_ms, b_by = bound(N * span * D * 4 + Bf * (2 * D + 2) * 4 + 3 * Bf * N * 4,
                       8.0 * N * span * D)
    mask_f = ref.span_mask(s, e, Tf)
    fused = torch.compile(ref.fit_scores_many_ref, fullgraph=True,
                          dynamic=False)
    check_fused(torch, fused, ref.fit_scores_many_ref,
                (rem, dem, mask_f, inv), "fit_scores_many")
    rem_host = rem.cpu().double().numpy()
    copy_ms = host_ms(torch, lambda: torch.from_numpy(
        np.ascontiguousarray(rem_host, dtype=np.float32)).to(dev))
    ops_ms = host_ms(torch, lambda: kernels.ops.fit_scores_many(
        rem_host, dem.cpu().numpy(), s.cpu().numpy(), e.cpu().numpy(),
        inv.cpu().numpy(), scored=True), reps=100)
    kinfo["fit_scores_many"] = {
        "shape": {"B": Bf, "N": N, "T": Tf, "D": D}, "calls": calls_f,
        "distinct_shapes": len(rec_f.calls), "calls_at_shape": n_f,
        "max_abs_err": max(e_f, err["fit_scores_many"]),
        "ms": device_ms(torch, lambda: fit.fit_scores_many(rem, dem, s, e,
                                                             inv)),
        "plain_ms": device_ms(
            torch, lambda: ref.fit_scores_many_ref(rem, dem, mask_f, inv)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(torch, lambda: fused(rem, dem, mask_f, inv)),
        "call_ms": cuda_ms(
            torch, lambda: fit.fit_scores_many(rem, dem, s, e, inv)),
        "pool_copy_ms": copy_ms, "host_call_ms": ops_ms,
    }
    for name, info in kinfo.items():
        log(timing_line(name, info))
        if "plan" in info:
            log(f"timing: {name} launch shape {info['plan']}")
    log(f"timing: fit pool window host->card copy {copy_ms:.5f} ms, whole "
        f"host call {ops_ms:.5f} ms at {kinfo['fit_scores_many']['shape']} "
        f"({calls_f} calls over {len(rec_f.calls)} shapes)")

    # 6. the same fleet with no kernels
    plain_engine = FleetEngine(solver=SolverConfig(operator="dense"),
                               placement=PlacementConfig(backend="numpy"))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res_np = plain_engine.evaluate(fleet)
    wall_np = time.perf_counter() - t0
    if any(kernels.launch_counts().values()):
        raise AssertionError("the kernel-free run launched a kernel")
    tn = res_np.timings
    log(f"plain: wall {wall_np:.3f} s; pack {tn['pack_s']:.3f} s, LP "
        f"{tn['lp_s']:.3f} s, placement {tn['place_s']:.3f} s")
    flips = []
    for i, (a, b) in enumerate(zip(res.entries, res_np.entries)):
        if abs(a["lb"] / b["lb"] - 1) > LB_RTOL:
            raise AssertionError(
                f"instance {i}: lower bound {a['lb']} vs dense {b['lb']}")
        ra, rb = res.lp_results[i], res_np.lp_results[i]
        flipped = np.flatnonzero(ra.mapping != rb.mapping)
        for algo, c in a["costs"].items():
            c_np = b["costs"][algo]
            if abs(c / c_np - 1) <= COST_RTOL:
                continue
            if algo.startswith("lp-map") and len(flipped):
                flips.append((i, algo))
                log(f"plain: instance {i} {algo} cost {c} vs {c_np}: LP "
                    f"mapping flipped at tasks {flipped.tolist()}, x rows "
                    f"(pallas) {ra.x[flipped].tolist()} (dense) "
                    f"{rb.x[flipped].tolist()}")
                continue
            raise AssertionError(
                f"instance {i} {algo}: cost {c} with kernels vs {c_np} "
                f"without, same mapping")
    log(f"plain: lower bounds within rel {LB_RTOL}, costs within rel "
        f"{COST_RTOL} ({len(flips)} differences from flipped LP mappings)")
    report["plain"] = {"wall_s": wall_np, "timings": tn, "flips": flips,
                       "entries": res_np.entries}

    # 7. the single-instance path: one two_phase launch per two_phase call
    single = single_phase(torch, np, ref, kernels, fleet, res, report)
    kinfo["two_phase"] = single["kinfo"]
    kinfo["fit_scores"] = fit1_timing(torch, np, ref, fit, fleet[0], dev,
                                      err["fit_scores"])
    log(timing_line("fit_scores", kinfo["fit_scores"]))
    launches_1 = single["launches"]

    # 8. the compiled placement stepper
    stepper = compiled_phase(torch, np, ref, kernels, fleet, spec, res_np,
                             tm, tn, report)
    kinfo["place_step"] = stepper["kinfo"]

    # 9. tolerance mode
    tol = tol_phase(torch, np, ref, kernels, cong, fleet, res_np, tm, report)
    for name in ("congestion_many", "congestion_lp"):  # one counter
        kinfo[name]["tol_launches"] = tol["launches"]["congestion_many"]
    kinfo["congestion_lp"]["max_abs_err"] = max(
        kinfo["congestion_lp"]["max_abs_err"], tol["max_abs_err"])

    # 10. the constrained Table-I fleet and the GCT-like fleet
    con = constrained_phase(torch, np, ref, kernels, cong, fleet, report)
    gct = gct_phase(torch, np, ref, kernels, cong, report)
    counter = {"congestion_many": "congestion_many",
               "congestion_lp": "congestion_many",
               "fit_scores_many": "fit_scores_many",
               "fit_scores": "fit_scores", "place_step": "place_step",
               "two_phase": "two_phase"}
    for name, key in counter.items():
        kinfo[name]["phase10_launches"] = {
            "constrained": con["launches"][key], "gct": gct["launches"][key]}
    kinfo["congestion_lp"]["max_abs_err"] = max(
        kinfo["congestion_lp"]["max_abs_err"], con["max_abs_err"],
        gct["max_abs_err"])
    kinfo["congestion_lp"]["phase10_ms"] = {
        "constrained": con["apply"]["ms"], "gct": gct["apply"]["ms"]}
    kinfo["place_step"]["phase10_ms"] = {
        "constrained": con["place_step"]["ms"],
        "gct type-parallel": gct["place_step"]["type-parallel"]["ms"],
        "gct wave": gct["place_step"]["wave-sequential"]["ms"]}

    # 11. the serving loop on a GCT-like trace
    serve = serve_phase(torch, np, ref, kernels, cong, report)
    for name, key in (("congestion_many", "congestion_many"),
                      ("congestion_lp", "congestion_many"),
                      ("place_step", "place_step")):
        kinfo[name]["phase11_launches"] = serve["launches"][key]
    kinfo["congestion_lp"]["max_abs_err"] = max(
        kinfo["congestion_lp"]["max_abs_err"], serve["max_abs_err"])

    # the congestion kernel's one counter counts both of its entries; the
    # main path launches it only through congestion_lp
    runs = {"congestion_many": launches["congestion_many"],
            "congestion_lp": calls_c,
            "fit_scores_many": launches["fit_scores_many"],
            "fit_scores": launches_1["fit_scores"],
            "place_step": stepper["launches"]["place_step"],
            "two_phase": launches_1["two_phase"]}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": runs[name],
         "max_abs_err": kinfo[name]["max_abs_err"], "ms": kinfo[name]["ms"],
         "plain_ms": kinfo[name]["plain_ms"],
         "bound_ms": kinfo[name]["bound_ms"],
         "bound_by": kinfo[name]["bound_by"],
         "library_ms": kinfo[name]["library_ms"],
         # the serial chain's floor, where a kernel is one (two_phase), and
         # the tol-mode evaluate's launches (the congestion kernel)
         **{key: kinfo[name][key] for key in ("latency_bound_ms",
                                              "tol_launches",
                                              "phase10_launches",
                                              "phase10_ms",
                                              "phase11_launches")
            if key in kinfo[name]}}
        for name in SOURCES]}
    report["kernels"] = kinfo
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1, default=float))
    # the result lines carry no time stamp: they are read as they are
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
