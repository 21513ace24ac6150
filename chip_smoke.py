#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json] [--phase 9|10|15|16]

Phases, in order; any failure raises and the script exits non-zero:

1. card: the card's name and power limit from ``nvidia-smi``;
2. build: compile every CUDA kernel of ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (all at once) and print ptxas' registers, shared memory and
   spills per kernel;
3. edges: each kernel against its plain PyTorch version at edge shapes,
   then past the kernels' old width limits: the congestion kernel at K =
   9000 and at m * D = 8280 (its column axis tiled; launch plans held to
   ``congestion.column_tiles``), the compiled stepper at D = 257 and 600
   and the two_phase kernel at D = 33, 64 and 276, bit-equal, with rows
   spilled past shared memory.  Wherever m * D fits one column tile, every
   launch plan the script reports is held to the plan the kernel picked
   before the columns were tiled (``tests/_torch_congestion_plan.py``);
4. main path: ``FleetEngine(solver=SolverConfig(operator="pallas"),
   placement=PlacementConfig(backend="kernel")).evaluate`` over 16 Table-I
   instances (n=1000, m=10, D=5, T=24, seeds 0..15), all four algorithms,
   2000 PDHG iterations, with the kernel launch counts set to 0 just before
   and read just after; then the same evaluate once more under
   ``torch.profiler`` for the card's busy time and idle share (whole
   evaluate, LP and placement);
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
   equal, objectives within that gap (bit-equality reported).  Then the
   pipelined sweep sharded over cards (``SweepConfig(devices=k)``): k = 1,
   through the sharded code, and where more than one card is visible the
   largest divisor of 4 no larger than the card count; one dispatch, the
   congestion kernel's launches on each card = the sum over groups of 13 +
   the most iterations of that card's lanes, and lane for lane against the
   pipelined run: iterations, restarts and convergence equal, objectives
   and bounds bit-equal or within rel 1e-6 (the largest gap printed), and
   the lane-sum kernel launched.  With one card a line says the sharding
   over several did not run.  The lane-sum kernel (``lane_sum.cu``, the tol
   LP's sums over a lane's elements in an order that does not depend on the
   batch) is held on every distinct input of the first tol evaluate:
   bit-equal to ``ref.lane_sum_ordered``, each lane alone bit-equal to its
   batch, within ``LANE_SUM_SLACK`` * eps * sum |x| of ``torch.sum``; timed
   at the most frequent input beside ``torch.sum``.  It prints
   each run's lp_s beside phase 4's legacy ``pallas`` LP, iterations and
   restarts cold and warm, and the tol LP's device busy time and idle share
   from a marker-checked profile.

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
   (c) A wide constrained fleet past every old width limit: 4 instances of
   ``SyntheticSpec(n=1000, m=30, D=5, T=24, seed=s)``, each with 270
   anti-affinity pairs and 8 exclusive tasks over disjoint tasks drawn by
   ``np.random.default_rng(2000 + s)``, lowered to D = 276 (m * D = 8280).
   The tol-mode compiled evaluate with ``operator="pallas"`` (counts set
   to 0 just before and read just after, launches as in phase 9) against
   the same evaluate with ``dense``: every lane converged, the bounds
   bracketing each other (rel 1e-6); the protocol's placements compiled
   and numpy lockstep bit-equal; ``rightsize(q, algo, backend="kernel")``
   with ``check=True`` (the oracle) for the four algorithms on every
   instance, one ``two_phase`` launch per ``two_phase`` call, instance 0
   equal to the numpy route; then the last apply, the lp-map type-parallel
   dispatches and lp-map-f's similarity launch replayed on the plain
   versions and timed (kernel, plain, bound, ``torch.bmm`` for the apply,
   launch shape and ``smem_rows``); the kernels line carries them as
   ``wide``.  (d) The README's quickstart fleet through the legacy shim
   ``repro_torch.core.evaluate_many`` on the card against
   ``device="cpu"``: a legacy and a tolerance call (see
   ``quickstart_phase``).  ``--phase 10`` runs phases 1, 2, 3, 10c and
   10d only.

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

12. stochastic planning, in phase 11's card configuration, each run with
   the launch counts set to 0 just before and read just after.  (a)
   ``plan_stochastic(gct_forecast(n=1000, m=10, seed=0, cost_model="gce",
   load_sigma=0.15, diurnal_amp=0.10, burst_prob=0.15, burst_alpha=1.6,
   burst_cap=8.0), StochasticConfig(scenarios=64, cvar_lambda=2.0, ...))``
   (the reference's golden burst grid at the paper's real-world width): one
   LP dispatch in one bucket, every lane converged, congestion launches =
   13 + the most iterations, stepper launches = the compiled placements'
   dispatches; every placement call and every scenario's plan and cost
   equal to the numpy lockstep engine's on the same LP mappings; the last
   apply within rtol/atol 1e-5 of the plain version, the first and the
   widest stepper dispatch bit-equal to ``ref.sub_phase_ref`` (both timed,
   with their bounds); ``fleet_cost <= max_fleet_cost``; a second call's
   ``summary()`` bit-equal.  (b) the golden grid at its own width (n=120,
   m=6): the structural invariants of ``benchmarks/check_stochastic.py``
   held, and how many of the golden's pinned fields and frontier rows it
   reproduces within 1e-6 printed.  (c) a zero-variance forecast at K = 1
   on Table-I instance 0: its scenario cost equal to
   ``FleetEngine.evaluate``'s lp-map-f cost.  (d)
   ``svc.preprovision(<first fleet>)`` on phase 11's warm-replayed service:
   one dispatch, launches as in (a), the plan grown elementwise, one
   ``ScaleEvent(scope="preprovision")`` priced at the adopted plan, the
   placement untouched.  (e) ``python -m repro_torch.launch.rightsize plan
   --scenarios 16 --lp-tol 5e-3 --lp-iters 4000 --operator pallas
   --placement compiled`` on the jobs fleet: the point plan's LP and one
   scenario dispatch, launches counted.  The kernels line carries each
   run's phase-12 launches.
13. the LM serving path, which runs no kernel of the repo (the reference's
   attention is plain JAX, ported as plain PyTorch).  (a) ``gemma2-9b`` at
   full width in bf16 (9.241 B parameters from a seeded generator on the
   card) through ``launch.serve``'s ``make_batch`` and ``generate``: batch
   4, a 4100-token prompt (past the 4096 window, so every local ring wraps),
   16 greedy tokens, twice (cold, warm; the same ids), every logit finite;
   prefill tok/s, decode ms/step, peak memory and the ids of row 0 printed,
   then three decode steps and one prefill under marker-checked profiles
   (kernels, busy ms, idle share, the costliest kernels) beside their bounds
   (prefill: its matmul operations at the bf16 peak; a decode step: every
   weight and filled cache entry read once).  (b) the same model in float32,
   batch 1: prefill 4100 tokens, decode 8 greedy tokens; at steps 0, 3 and 7
   the logits within 5e-3 of a fresh prefill of the same tokens.  (c) the
   ten architectures' smoke configs in float32 with local windows of 8 (below
   the 12-token prompt): one model run on the CPU, then moved to the card,
   prefill and 4 decode steps on the same tokens; logits and decode states
   within 1e-4, every MoE dispatch's slots and kept flags equal.
14. the LM training path, which runs no kernel of the repo either (the
   reference takes its gradients from ``jax.value_and_grad`` through the same
   plain attention).  (a) ``qwen2.5-3b`` at full width (3.086 B bf16
   parameters from a seeded generator, float32 AdamW moments) through
   ``launch.train.run(["--arch", "qwen2.5-3b", "--preset", "full",
   "--batch", "4", "--seq", "2048", "--steps", "10", "--ckpt-every", "10",
   "--ckpt-dir", <a fresh directory under build/>])``: remat, a loss chunk
   of 256; every loss and grad norm finite; the losses, step seconds (cold,
   then the median of the warm steps), tokens/s, peak memory and the
   checkpoint's bytes, snapshot and commit seconds printed, with the host's
   memory and the disk's free space; the checkpoint restored into a fresh
   model and state on the card, bit-equal to the live ones, and again with
   ``shardings=`` onto a one-card ``DeviceMesh`` (``Replicate()``, an NCCL
   group of one rank), every local tensor bit-equal, its seconds beside the
   plain restore's; then one warm
   step, and apart its data, forward + backward and optimizer update, under
   marker-checked profiles (kernels, busy ms, idle share, the costliest
   kernels) beside their bounds (the step's matmul operations at the bf16
   peak; the optimizer's bytes at the memory rate).  (b) the ten
   architectures' smoke configs in float32: one loss (remat, a loss chunk
   that pads S) and backward on the CPU and on the card, on the same
   weights and batch; the loss and every gradient within 1e-4 (against the
   gradient's own max |value|), every MoE dispatch's slots and kept flags
   equal (``tests/_torch_train_card.py``).  (c) the reference test's setups
   (``tests/test_train.py``: qwen2.5-3b smoke, lr 1e-3, warmup 5, B = 4, S =
   32, loss chunk 64): 30 steps lower the loss by more than 0.2, plain and
   with int8 gradient compression; microbatch 4 within 5e-5 of microbatch
   1; ``run_with_restarts`` with faults at steps 7 and 13 within rtol 1e-6 /
   atol 1e-7 of a clean 20-step run (bit-equality printed); ``launch.train``
   with ``--crash-at 12`` raises, and the same command again resumes from
   step 10.  (d) ``compressed_psum`` over an NCCL group of every visible card
   (a world of one in this process on one card, else one spawned process
   per card), leaf by leaf over qwen2.5-3b's 3.086 B parameter elements in
   float32 drawn from seeded generators: a world of one bit-equal to
   ``compress_decompress``, more cards within each block's quantization
   bound of a float32 ``all_reduce``; ms for the whole tree beside the
   ``all_reduce``'s, and bytes on the wire.  With one card a line says the
   forms over several did not run.  ``--phase 9`` runs phases 1, 2, 9.3's
   pipelined and sharded sweeps and 14d only.
15. the LM dry-run (``repro_torch.launch.dryrun``), which runs no kernel,
   then the rightsizer on its records, which runs two.  (a) ``python -m
   repro_torch.launch.dryrun`` in one process per cell of ``DRYRUN_CELLS``
   (qwen2.5-3b's train_4k, prefill_32k and decode_32k on 16x16 and
   2x16x16, and on 16x16 every other cell a schedule job reads, rwkv6-7b's
   train_4k among them), six at once on a thread started after phase 2,
   beside phases 3-12 (host work on otherwise idle cores; stopped during
   phases 13, 14 and 16, whose decode readings are host-bound), into ``build/dryrun/``; per
   record the per-device argument, temp and output GB, FLOPs, collective
   bytes by kind and trace seconds.  (b) The dry-run's
   accounting of phase 14's step (qwen2.5-3b, B = 4, S = 2048, its
   ``TrainConfig``) on the 1x1 host mesh over the card, against one such
   step run on the card: argument + temp + output must lie within [0.9, 2]
   times ``torch.cuda.max_memory_allocated``; the counted FLOPs beside
   ``train_bounds``'.  (c) ``workload.fleet_problem(DEFAULT_SCHEDULE,
   dryrun_dir="build/dryrun")`` through ``FleetEngine().evaluate`` in the
   card configuration (tol, ``pallas``, the compiled stepper): every one of
   the ten jobs' demands from a record (each job's source printed),
   launches checked, every placement call equal to the numpy lockstep
   engine's, every algorithm's plan clean under ``check_plan``.  ``--phase
   15`` runs phases 1, 2 and 15 only.
16. the recurrent families through the WKV and linear-scan kernels
   (``kernels/csrc/wkv.cu``, ``scan.cu``), which replace no Pallas kernel
   but the reference's compiled time loops; it runs after phase 14, while
   15a's processes wait.  First each kernel, forward and backward, against
   its plain loop on the card at full-width layer shapes and the path's
   lengths (forwards S = 4100, backwards S = 2048): the WKV at B = 4, H =
   64, N = 64 in float32 and bfloat16 with log-decays, a hundredth of the
   decays exactly 0, then at the ragged lengths S = 1, 63 and 65 (the chunk
   is 64 steps) and at S = 300 with a tenth of the decays exactly 0 (half of
   them lw = -inf); the backward's scratch bytes
   (``torch.cuda.max_memory_allocated`` around one call at S = 2048); the
   scan pair bit-equal at (B, S, W) = (1, 1, 1), (2, 7, 300), (1, 65, 33),
   (3, 300, 4098) and (4, 4100, 4096), then at B = 4, W = 4096 and the
   path's lengths, each launch plan printed and held to the plan rule's
   transcription (``tests/_torch_scan_tiles.py``), the path's in one wave
   on the card's SMs; then each timed (kernel, plain loop,
   bound: the WKV's operations at the TF32 tensor-core rate over the 3-pass
   split, which its kernels run, beside the same count at the CUDA cores'
   float32 rate, ``bound_ms_f32_rate``, the bound of the earlier serial
   kernels; the log line gives the chunked form's own operation count,
   counted from the kernels' loops, not measured).  (a) ``rwkv6-7b``
   (7.786 B bf16 parameters), then
   ``recurrentgemma-9b`` (9.396 B), at full width from a seeded generator
   through ``launch.serve``'s ``make_batch``/``generate``: B = 4, a
   4100-token prompt (past recurrentgemma's 2048-token window), 16 greedy
   tokens, cold and warm; launch counts set to 0 just before each call and
   read just after (one ``wkv`` a rwkv layer, one ``linear_scan`` an RG-LRU
   layer); prefill s and tok/s, decode ms/step, peak memory.  (b) both in
   float32 at B = 1: prefill 4100 tokens, 8 greedy decode steps (the O(1)
   step path), steps 0, 3 and 7 within 5e-3 of a fresh prefill.  (c)
   ``rwkv6-7b`` cut to 8 layers (``--layers``, the only cut: float32 AdamW
   state of 32 layers does not fit the card) through ``launch.train.run``
   (B = 4, S = 2048, 10 steps, remat): losses finite and falling, one
   ``wkv_backward`` a layer a step; then ``recurrentgemma-9b`` cut to 6
   layers through ``make_train_step`` for 3 steps, one
   ``linear_scan_backward`` an RG-LRU layer a step.  Phases 13c and 14b run
   the recurrent smoke models through these kernels.  ``--phase 16`` runs
   phases 1, 2 and 16 only.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import json
import math
import pathlib
import re
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, non-tensor-core f32 and
# f64 rates and the dense TF32 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3   # the WKV kernels' split: a_hi b_hi + a_hi b_lo + a_lo b_hi

CONG_RTOL = CONG_ATOL = 1e-5   # float32 sums in another order
FIT_RTOL = FIT_ATOL = 1e-5     # dot / norm: float32 sums in another order
LB_RTOL = 1e-4                 # two float32 PDHG trajectories
COST_RTOL = 1e-5               # a flipped placement moves a whole node price
FLEET = 16                     # Table-I instances in the main path's fleet
TOL = 5e-3                     # phase 9's SolverConfig(tol=...)
BOUND_RTOL = 1e-6              # phase 9's certified cross-bounds
# the lane-sum kernel against torch's sum: each within depth * eps * sum |x|
# of the exact sum, depth the adds on an element's way (64 in a thread's run
# of a chunk, 10 in the butterflies, as many again past one chunk), torch's
# taken as the kernel's: |kernel - torch| <= LANE_SUM_SLACK * eps * sum |x|
LANE_SUM_SLACK = 2 * (64 + 10 + 20)

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
    # the recurrences replace no Pallas kernel: the reference compiles
    # these time loops (phase 16)
    "wkv": ("src/repro_torch/kernels/csrc/wkv.cu",
            "none — src/repro/models/rwkv.py:116 lax.scan"),
    "wkv_backward": ("src/repro_torch/kernels/csrc/wkv.cu",
                     "none — src/repro/models/rwkv.py:116 lax.scan"),
    "linear_scan": ("src/repro_torch/kernels/csrc/scan.cu",
                    "none — src/repro/models/rglru.py:84 associative_scan"),
    "linear_scan_backward": (
        "src/repro_torch/kernels/csrc/scan.cu",
        "none — src/repro/models/rglru.py:84 associative_scan"),
    # replaces no Pallas kernel: the tol LP's sums over a lane's elements,
    # which the reference leaves to XLA (phase 9)
    "lane_sum": ("src/repro_torch/kernels/csrc/lane_sum.cu",
                 "none — src/repro/core/batch.py:318 jnp.sum"),
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
    """Wraps a kernel wrapper to keep each distinct call shape's (shapes
    and dtypes) first inputs (cloned before the call) and the number of
    calls per shape, or with ``every`` every call's inputs in ``log``; the
    wrapped function still counts its own launches."""

    def __init__(self, torch, module, name, every: bool = False):
        self.torch, self.module, self.name = torch, module, name
        self.orig = getattr(module, name)
        self.calls = collections.Counter()
        self.inputs = {}
        self.every = every
        self.log = []

    def __call__(self, *args, **kwargs):
        key = tuple((tuple(a.shape), str(a.dtype)) if hasattr(a, "shape")
                    else a for a in args)
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


def checked_plan(torch, cong, B, n, m, D, T, lp=True) -> dict:
    """The launch plan the built congestion kernel picks, held to
    ``congestion.column_tiles`` and, where m * D fits one column tile, to
    the plan it picked before the columns were tiled
    (``tests/_torch_congestion_plan.py``)."""
    if str(HERE / "tests") not in sys.path:
        sys.path.append(str(HERE / "tests"))
    from _torch_congestion_plan import one_tile_plan

    plan = cong.launch_plan(B, n, m, D, T, lp=lp)
    what = f"launch plan at B={B} n={n} m={m} D={D} T={T} lp={lp}: {plan}"
    if (plan["c_tile"], plan["c_tiles"]) != cong.column_tiles(m * D, T):
        raise AssertionError(f"{what}; column tiles "
                             f"{cong.column_tiles(m * D, T)} expected")
    if plan["c_tiles"] == 1:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        want = one_tile_plan(B, n, m, D, T, lp, sms)
        if {k: plan[k] for k in want} != want:
            raise AssertionError(f"{what}; the one-tile plan is {want}")
    return plan


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
        "plan": checked_plan(torch, cong, B, n, m, D, Tp),
        "max_abs_err": err,
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


def wide_edge_checks(torch, ref, cong, kstep, dev) -> dict:
    """Phase 3, past the kernels' old width limits: the congestion kernel
    at K = 9000 (the TPU contract) and at m * D = 8280 (the LP's apply; its
    column axis tiled), the compiled stepper at D = 257 and 600, the
    two_phase kernel at D = 33, 64 and 276, each against its plain version:
    congestion within rtol/atol 1e-5, the steppers bit-equal (node choices,
    counts, stopping steps and the pool; every task's node), with the rows
    past the shared-memory budget spilled (the inputs of
    ``tests/test_torch_cuda.py``'s, from ``tests/_torch_stepper_inputs.py``).
    Returns max |error| per kernel."""
    import numpy as np

    if str(HERE / "tests") not in sys.path:
        sys.path.append(str(HERE / "tests"))
    from _torch_stepper_inputs import sub_phase_inputs, walk_inputs

    g = torch.Generator().manual_seed(24)
    err = collections.defaultdict(float)

    def spans(B, n, T):
        s = torch.randint(0, T, (B, n), generator=g, dtype=torch.int32)
        ln = torch.randint(0, max(T // 2, 1), (B, n), generator=g,
                           dtype=torch.int32)
        return s, torch.clamp(s + ln, max=T - 1)

    for G, n, T, K in [(1, 8, 4, 9000), (3, 300, 40, 9000)]:
        s, e = spans(G, n, T)
        w = torch.rand((G, n, K), generator=g)
        err["congestion_many"] = max(err["congestion_many"], check_congestion(
            torch, ref, cong, s.to(dev), e.to(dev), w.to(dev), T,
            f"G={G} n={n} T={T} K={K}"))
        checked_plan(torch, cong, G, n, 1, K, T, lp=False)
    for B, n, m, D, T in [(2, 300, 30, 276, 24), (1, 40, 10, 820, 4)]:
        s, e = spans(B, n, T)
        w_all = torch.rand((B, n, m, D), generator=g)
        x = torch.rand((B, n, m), generator=g)
        s[:, 2], e[:, 2], w_all[:, 2] = 0, 0, 0.0  # the pack's padding task
        err["congestion_lp"] = max(err["congestion_lp"], check_congestion_lp(
            torch, ref, cong, s.to(dev), e.to(dev), w_all.to(dev), x.to(dev),
            T, f"B={B} n={n} m={m} D={D} T={T}"))
        checked_plan(torch, cong, B, n, m, D, T)

    spilled = {}
    for A, L, T, D, scale in [(16, 40, 24, 257, 0.3), (8, 30, 24, 600, 0.2)]:
        args, rows = sub_phase_inputs(g, A, L, T, D, scale, 0, True)
        for sim in (False, True):
            got_a = [t.to(dev) for t in args]
            want_a = [t.to(dev) for t in args]
            tel: dict = {}
            got = kstep.sub_phase(*got_a, 1e9, True, sim, rows=rows,
                                  telemetry=tel)
            want = ref.sub_phase_ref(*want_a, 1e9, True, sim)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got_a[0],
                                                           want_a[0])):
                raise AssertionError(f"place_step at A={A} L={L} T={T} "
                                     f"D={D} similarity={sim}: kernel "
                                     f"differs from the plain version")
            spilled[f"place_step D={D}"] = (tel["smem_rows"],
                                            int(got[:A].max()))
    rng = np.random.default_rng(24)
    for n, P, D, T in [(200, 4, 33, 12), (300, 5, 64, 24),
                       (400, 10, 276, 24)]:
        for filling in (False, True):
            args, _, rows = walk_inputs(rng, n, P, D, T, 0.3, filling,
                                        False)
            for sim in (False, True):
                want = ref.two_phase_ref(*args, T, 1e9, sim, filling, rows)
                tel = {}
                got = kstep.two_phase_walk(*[t.to(dev) for t in args], T,
                                           1e9, sim, filling, rows,
                                           telemetry=tel).cpu()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"two_phase at n={n} P={P} D={D} T={T} "
                        f"filling={filling} similarity={sim}: kernel "
                        f"differs from the plain version")
            spilled[f"two_phase D={D} filling={filling}"] = (
                tel["smem_rows"], int(kstep.split_walk(want, P, n)[0].max()))
    log(f"edges: past the old limits, congestion within rtol/atol "
        f"{CONG_RTOL} (max |err| {dict(err)}), place_step at D = 257, 600 "
        f"and two_phase at D = 33, 64, 276 bit-equal to their plain "
        f"versions; (smem_rows, most rows opened) {spilled}")
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


def sweep_shard_counts(torch) -> list[int]:
    """Phase 9.3's shard counts: 1 (one shard, through the sharded code),
    and where more than one card is visible the largest divisor of the
    group size 4 that is no larger than the card count."""
    most = max(d for d in (1, 2, 4) if d <= torch.cuda.device_count())
    return [1] if most == 1 else [1, most]


def compare_lanes(np, a_res, b_res) -> dict:
    """Two runs of one sweep lane for lane: iterations, restarts and
    convergence equal; objectives and bounds bit-equal, or their largest
    relative gap held to ``BOUND_RTOL``.  Returns the counts, that gap and
    the failed checks."""
    out = {"lanes": len(a_res.lp_results), "bit_equal": 0,
           "max_rel_gap": 0.0, "mappings_equal": 0, "costs_equal": 0,
           "errors": []}
    for i, (a, b) in enumerate(zip(a_res.lp_results, b_res.lp_results)):
        if (a.iters, a.restarts, a.converged) != (b.iters, b.restarts,
                                                  b.converged):
            out["errors"].append(
                f"lane {i}: iterations/restarts/convergence "
                f"{(a.iters, a.restarts, a.converged)} vs "
                f"{(b.iters, b.restarts, b.converged)}")
        pairs = ((a.objective, b.objective), (a.lower_bound, b.lower_bound))
        out["bit_equal"] += all(x == y for x, y in pairs)
        gap = max(abs(x - y) / max(abs(x), abs(y), 1e-30) for x, y in pairs)
        out["max_rel_gap"] = max(out["max_rel_gap"], gap)
        out["mappings_equal"] += bool(np.array_equal(a.mapping, b.mapping))
        out["costs_equal"] += (a_res.entries[i]["costs"]
                               == b_res.entries[i]["costs"])
    if out["max_rel_gap"] > BOUND_RTOL:
        out["errors"].append(f"objectives/bounds rel gap "
                             f"{out['max_rel_gap']:.3e} > {BOUND_RTOL}")
    return out


def lane_sum_checks(torch, ref, klane, rec) -> dict:
    """The lane-sum kernel on every distinct input the tol path gave it
    (``rec``, a ``Recorder``): bit-equal to ``ref.lane_sum_ordered`` (its
    order of adds), each lane alone bit-equal to the same lane in the
    batch, and within ``LANE_SUM_SLACK`` * eps * sum |x| of torch's sum
    (the plain version; the largest gap also as a share of sum |x|); then
    timed at the most frequent input: device ms of the kernel, the plain
    version and ``torch.sum``, and the bound (each element read once and
    added once).  Returns the kernels line's fields."""
    worst = worst_rel = 0.0
    for (x, dims) in rec.inputs.values():
        got = klane.lane_sum(x, dims)
        plain = ref.lane_sum_ref(x, dims)
        if not torch.equal(got, ref.lane_sum_ordered(x, dims, klane.CHUNK)):
            raise AssertionError(f"lane_sum {tuple(x.shape)} {dims}: not the "
                                 f"kernel's order of adds")
        for b in range(x.shape[0]):
            if not torch.equal(klane.lane_sum(x[b:b + 1].clone(), dims),
                               got[b:b + 1]):
                raise AssertionError(f"lane_sum {tuple(x.shape)} {dims}: "
                                     f"lane {b} alone has other bits")
        diff = (got.double() - plain.double()).abs()
        mag = x.abs().double().sum(dim=dims, keepdim=True)
        slack = LANE_SUM_SLACK * torch.finfo(x.dtype).eps * mag
        if not bool((diff <= slack).all()):
            raise AssertionError(f"lane_sum {tuple(x.shape)} {dims}: |kernel "
                                 f"- torch.sum| {float(diff.max()):.3e} past "
                                 f"its slack")
        worst = max(worst, float(diff.max()))
        worst_rel = max(worst_rel, float((diff / mag.clamp_min(1e-300)).max()))
    key = rec.calls.most_common(1)[0][0]
    x, dims = rec.inputs[key]
    wide = x.dtype == torch.float64
    outs = x.numel() // max(1, math.prod(x.shape[d] for d in dims))
    nbytes = (x.numel() + outs) * x.element_size()
    b_ms, b_by = bound(nbytes, x.numel(),
                       PEAK_F64_FLOPS if wide else PEAK_F32_FLOPS)
    info = {"shape": {"x": list(x.shape), "dims": list(dims),
                      "dtype": str(x.dtype)},
            "inputs": len(rec.inputs), "calls": sum(rec.calls.values()),
            "max_abs_err": worst, "max_rel_err": worst_rel,
            "ms": device_ms(torch, lambda: klane.lane_sum(x, dims)),
            "plain_ms": device_ms(torch, lambda: ref.lane_sum_ref(x, dims)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(torch, lambda: torch.sum(
                x, dim=dims, keepdim=True)),
            "call_ms": cuda_ms(torch, lambda: klane.lane_sum(x, dims)),
            # the host's cost of the call the kernel replaced, for the
            # launch-bound tol loop
            "library_call_ms": cuda_ms(torch, lambda: torch.sum(
                x, dim=dims, keepdim=True))}
    log(f"lane_sum: {len(rec.inputs)} distinct inputs of "
        f"{info['calls']} calls bit-equal to the ordered plain version, "
        f"every lane alone bit-equal to its batch, max |kernel - torch.sum| "
        f"{worst:.3e} (the padded types' caps are huge), at most "
        f"{worst_rel:.3e} of sum |x|")
    log(timing_line("lane_sum", info))
    log(f"lane_sum: wall ms per call back to back, torch.sum "
        f"{info['library_call_ms']:.6f} against the wrapper's "
        f"{info['call_ms']:.6f}")
    return info


def sharded_sweeps(torch, np, kernels, cong, solver, place, grid,
                   pipe) -> dict:
    """9.3: the pipelined sweep sharded over cards (``SweepConfig(devices=
    k)`` for each of ``sweep_shard_counts``), counts set to 0 just before
    and read just after: one dispatch; each run held lane for lane against
    the pipelined run ``pipe`` (``compare_lanes``); the congestion kernel's
    launches on card i = the sum over groups of 13 + the most iterations of
    card i's lanes (each shard's early exit stops on its own).  Returns per
    k its lp_s, wall, launches per card and comparison, and the failed
    checks under "errors"."""
    from repro_torch.core import FleetEngine, SweepConfig, dispatch_count

    out: dict = {"errors": []}
    for k in sweep_shard_counts(torch):
        eng = FleetEngine(solver=solver, placement=place,
                          sweep=SweepConfig(warm_start=4, pipeline=True,
                                            devices=k))
        for i in range(k):
            torch.cuda.synchronize(i)
        kernels.reset_launch_counts()
        d0 = dispatch_count()
        t0 = time.perf_counter()
        r = eng.evaluate(grid)
        for i in range(k):
            torch.cuda.synchronize(i)
        wall = time.perf_counter() - t0
        disp = dispatch_count() - d0
        by_card = cong.launches_by_card()
        n_sum = kernels.launch_counts()["lane_sum"]
        per = 4 // k
        want = {i: sum(13 + int(st.iterations[i * per:(i + 1) * per].max())
                       for st in r.stats) for i in range(k)}
        cmp = compare_lanes(np, pipe, r)
        log(f"tol: sweep sharded devices={k}: wall {wall:.3f} s, LP "
            f"{r.timings['lp_s']:.3f} s (pipelined LP "
            f"{pipe.timings['lp_s']:.3f} s), {disp} dispatch; congestion "
            f"launches per card {by_card} (want {want}), lane_sum launches "
            f"{n_sum}; lane for lane vs pipelined: {cmp}")
        errors = [f"sweep devices={k} {e}" for e in cmp.pop("errors")]
        if disp != 1:
            errors.append(f"sweep devices={k}: {disp} dispatches, want 1")
        if n_sum <= 0:
            errors.append(f"sweep devices={k}: the lane-sum kernel never "
                          f"launched")
        if by_card != want:
            errors.append(f"sweep devices={k}: congestion launches per card "
                          f"{by_card}, want {want}")
        out["errors"] += errors
        out[k] = {"wall_s": wall, "lp_s": r.timings["lp_s"],
                  "launches_by_card": by_card, "lane_sum_launches": n_sum,
                  "compared": cmp}
    if len(out) == 2:
        log(f"tol: sweep sharded over more than one card not run: "
            f"{torch.cuda.device_count()} card visible")
    return out


def multicard_phase(torch, np, kernels, cong, report) -> None:
    """``--phase 9``: phase 9.3's pipelined sweep (once to warm up, then the
    run it keeps), its sharded runs (``sharded_sweeps``) and phase 14d
    (``collective_phase``): the paths that run over every visible card."""
    from repro_torch.core import (FleetEngine, PlacementConfig, SolverConfig,
                                  SweepConfig)
    from repro_torch.kernels import lane_sum as klane
    from repro_torch.kernels import ref
    from repro_torch.workload import SyntheticSpec, sweep_specs, synthetic_batch

    solver = SolverConfig(tol=TOL, iters=4000, operator="pallas")
    place = PlacementConfig(engine="compiled")
    grid = synthetic_batch(sweep_specs(SyntheticSpec(), seeds=4,
                                       n=(850, 900, 950, 1000)))
    eng = FleetEngine(solver=solver, placement=place,
                      sweep=SweepConfig(warm_start=4, pipeline=True))
    with Recorder(torch, klane, "lane_sum") as rec_s:
        pipe = eng.evaluate(grid)  # warm-up, its lane-sum inputs kept
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = eng.evaluate(grid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"tol: sweep pipelined wall {wall:.3f} s, LP "
        f"{pipe.timings['lp_s']:.3f} s")
    lane_sum = lane_sum_checks(torch, ref, klane, rec_s)
    sharded = sharded_sweeps(torch, np, kernels, cong, solver, place, grid,
                             pipe)
    errors = sharded.pop("errors")
    report["multicard"] = {"pipelined_wall_s": wall,
                           "pipelined_lp_s": pipe.timings["lp_s"],
                           "lane_sum": lane_sum, "sharded": sharded,
                           "collective": collective_phase(torch)}
    if errors:
        raise AssertionError("tol: " + "; ".join(errors))


def tol_phase(torch, np, ref, kernels, cong, fleet, res_np, tm,
              report) -> dict:
    """Phase 9: tolerance mode (see the module docstring).  Returns the tol
    evaluate's kernel launches."""
    import dataclasses

    from repro_torch.core import (FleetEngine, PlacementConfig, SolverConfig,
                                  SweepConfig, dispatch_count)
    from repro_torch.core import batch as tbatch
    from repro_torch.kernels import lane_sum as klane
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
    with Recorder(torch, klane, "lane_sum") as rec_s:
        res, wall, launches, last = tol_evaluate(torch, kernels, cong,
                                                 engine, fleet)
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
    if launches["lane_sum"] <= 0:
        raise AssertionError("tol: the lane-sum kernel never launched")
    lane_sum = lane_sum_checks(torch, ref, klane, rec_s)

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
    sharded = sharded_sweeps(torch, np, kernels, cong, solver, place, grid,
                             pipe)
    failed += sharded.pop("errors")

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
            **{f"sweep sharded devices={k}": run["lp_s"]
               for k, run in sharded.items()},
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
                  "dispatches": [d_seq, d_pipe], "compared": cmp_s,
                  "sharded": sharded},
        "replay_max_abs_err": e_tol, "lp_s": lp_s, "lane_sum": lane_sum,
        "profiled": {"wall_s": timing.get("wall_s"), "device_busy_s": busy,
                     "idle_share": idle,
                     "idle_share_of_unprofiled_lp": idle_unprof},
        "phase_s": phase_s}
    # the lane-sum kernel's launches on this slice's path: the sharded
    # sweep over the most cards
    lane_sum["sharded_launches"] = {
        k: run["lane_sum_launches"] for k, run in sharded.items()}
    lane_sum["launches"] = sharded[max(sharded)]["lane_sum_launches"]
    return {"launches": launches, "max_abs_err": e_tol, "lane_sum": lane_sum}


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

WIDE_FLEET = 4        # phase 10c's instances (seeds 0..3)
WIDE_PAIRS = 270      # anti-affinity pairs per instance: a dimension each
WIDE_EXCLUSIVE = 8    # exclusive tasks per instance: one dimension


def wide_fleet(np) -> list:
    """Phase 10c's fleet: ``SyntheticSpec(n=1000, m=30, D=5, T=24,
    seed=s)``, s < ``WIDE_FLEET``, each with ``WIDE_PAIRS`` anti-affinity
    pairs and ``WIDE_EXCLUSIVE`` exclusive tasks over disjoint tasks drawn
    by ``np.random.default_rng(2000 + s)`` (``tests/test_torch_wide_dims.py``
    draws its instances so): lowered, D = 5 + 1 + 270 = 276 and m * D =
    8280."""
    import dataclasses

    from repro_torch.core import TaskConstraints
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    problems = []
    for s in range(WIDE_FLEET):
        p = synthetic_instance(SyntheticSpec(n=1000, m=30, D=5, T=24,
                                             seed=s))
        rng = np.random.default_rng(2000 + s)
        pool = list(rng.permutation(p.n))

        def pop(k):
            return [int(pool.pop()) for _ in range(k)]

        anti = {f"anti{g}": pop(2) for g in range(WIDE_PAIRS)}
        c = TaskConstraints.from_groups(p.n, anti_affinity=anti,
                                        exclusive=pop(WIDE_EXCLUSIVE))
        problems.append(dataclasses.replace(p, constraints=c))
    return problems


def wide_phase(torch, np, ref, kernels, cong, report) -> dict:
    """Phase 10c: a wide constrained fleet past every old width limit (see
    the module docstring).  Returns its launches per kernel and the three
    kernels' timings at its shapes."""
    from repro_torch.core import (ALGORITHMS, FleetEngine, PlacementConfig,
                                  SolverConfig, lower_constraints, rightsize)
    from repro_torch.kernels import place_step as kstep

    t_phase = time.perf_counter()
    problems = wide_fleet(np)
    dims = sorted({lower_constraints(q).lowered.D for q in problems})
    log(f"wide: {len(problems)} instances n=1000 m=30 with {WIDE_PAIRS} "
        f"anti-affinity pairs and {WIDE_EXCLUSIVE} exclusive tasks each; "
        f"lowered D {dims}")
    runs = {}
    for op in ("pallas", "dense"):
        engine = FleetEngine(solver=SolverConfig(tol=TOL, iters=4000,
                                                 operator=op),
                             placement=PlacementConfig(engine="compiled"))
        runs[op] = tol_evaluate(torch, kernels, cong, engine, problems)
        res, wall, launches, _ = runs[op]
        tm = res.timings
        log(f"wide: {op} wall {wall:.3f} s; LP {tm['lp_s']:.3f} s, placement "
            f"{tm['place_s']:.3f} s; launches {launches}; lanes "
            f"{lane_report(np, res)}")
    res, wall, launches, last = runs["pallas"]
    check_tol_launches(res, launches, "wide")
    B, n, m, D = last[2].shape
    if m * D <= cong.PART_FLOATS:
        raise AssertionError(f"wide: the last apply has m*D = {m * D}")
    cmp = compare_tol_runs(np, res, runs["dense"][0])
    log(f"wide: pallas against dense: {cmp['mapping_differs']} instances' "
        f"mappings differ ({cmp['tasks_differ']} tasks), "
        f"{cmp['cost_differs']} instances' costs differ; every lane "
        f"converged and the bounds bracket each other (rel {BOUND_RTOL})"
        if not cmp["errors"] else f"wide: {cmp['errors']}")
    if cmp["errors"]:
        raise AssertionError("wide: " + "; ".join(cmp["errors"]))

    # the protocol's placements, compiled against numpy lockstep; the lp-map
    # calls (type-parallel dispatches) recorded for the replay and timing
    prot = protocol_against_numpy(
        torch, np, kernels, kstep, res, "wide",
        record={("lp-map", "first"), ("lp-map", "similarity")})
    log(f"wide: {prot['calls']} protocol calls, compiled and numpy lockstep "
        f"placements bit-equal, best costs equal the evaluate's; numpy "
        f"{prot['numpy_s']:.3f} s, compiled {prot['compiled_s']:.3f} s")

    # rightsize: every instance through the two_phase kernel (check=True:
    # verify, and the oracle check_plan through assert_feasible), instance
    # 0 also through numpy
    rec = Recorder(torch, kstep, "two_phase_walk", every=True)
    with rec:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sols = [[rightsize(q, algo, backend="kernel", lp_result=r)
                 for algo in ALGORITHMS]
                for q, r in zip(problems, res.lp_results)]
        torch.cuda.synchronize()
        kern_s = time.perf_counter() - t0
        launches_r = kernels.launch_counts()
    calls = len(problems) * (4 + 4 + 2 + 2)
    if launches_r["two_phase"] != calls or any(
            v for k, v in launches_r.items() if k != "two_phase"):
        raise AssertionError(f"wide rightsize launched {launches_r}, want "
                             f"{calls} two_phase launches only")
    t0 = time.perf_counter()
    q0, r0 = problems[0], res.lp_results[0]
    for algo, a in zip(ALGORITHMS, sols[0]):
        b = rightsize(q0, algo, lp_result=r0)
        if not (np.array_equal(a.assign, b.assign)
                and np.array_equal(a.node_type, b.node_type)
                and a.cost(q0) == b.cost(q0)):
            raise AssertionError(f"wide instance 0 {algo}: kernel route "
                                 f"{a.cost(q0)} vs numpy {b.cost(q0)}")
    numpy_s = time.perf_counter() - t0
    log(f"wide: rightsize x {len(ALGORITHMS)} algorithms on "
        f"{len(problems)} instances through the two_phase kernel: "
        f"{launches_r['two_phase']} launches in {kern_s:.3f} s, "
        f"{len(problems) * len(ALGORITHMS)} plans with 0 check_plan "
        f"violations (check=True); instance 0 equal to the numpy route "
        f"({numpy_s:.3f} s)")

    # the three kernels at these shapes: the last apply, a type-parallel
    # dispatch and lp-map-f's similarity launch on instance 0, each replayed
    # on its plain version first
    apply = apply_timing(torch, ref, cong, last)
    pool_err, _ = replay_dispatches(torch, ref, kstep, prot["dispatches"],
                                    prot["labels"])
    tp = prot["modes"].index("type-parallel")
    step = time_dispatch(torch, ref, kstep, *prot["dispatches"][tp])
    i_walk = 11  # instance 0's last call: lp-map-f, similarity fit
    args, kw = rec.log[i_walk]
    work: dict = {}
    want = ref.two_phase_ref(
        *[a.cpu() if isinstance(a, torch.Tensor) else a for a in args],
        kw["similarity"], kw["sequential"], kw["rows"], work=work)
    if not (kw["similarity"] and torch.equal(
            kstep.two_phase_walk(*args, **kw).cpu(), want)):
        raise AssertionError("wide: lp-map-f's similarity launch differs "
                             "from the plain version")
    P_walk, n_walk = args[2].shape[0], args[3].shape[0]
    steps = int(kstep.split_walk(want, P_walk, n_walk)[2].sum())
    chain_ns = chain_ns_per_step(torch, args[0].device)
    walk = time_walk(torch, ref, kstep, args, kw, work, steps, chain_ns)
    log(f"wide: the last apply within rtol/atol {CONG_RTOL} of the plain "
        f"version (max |err| {apply['max_abs_err']:.3g}); "
        f"{len(prot['dispatches'])} type-parallel dispatches and lp-map-f's "
        f"similarity launch replayed bit-equal")
    log(timing_line("congestion_lp (wide)", apply))
    log(f"timing: congestion_lp (wide) launch shape {apply['plan']}")
    log(f"timing: place_step type-parallel (wide) at {step['shape']}: "
        f"kernel {step['ms']:.6f} ms (device; {step['call_ms']:.6f} per "
        f"wrapper call), plain {step['plain_ms']:.6f} (CUDA events), bound "
        f"{step['bound_ms']:.3e} ({step['bound_by']}); smem_rows "
        f"{step['smem_rows']}, spilled lanes {step['spilled_lanes']}")
    log(walk_line("two_phase lp-map-f similarity (wide)", walk, chain_ns))
    phase_s = time.perf_counter() - t_phase
    log(f"wide: phase 10c took {phase_s:.1f} s")
    total = {k: launches[k] + runs["dense"][2][k] + launches_r[k]
             for k in launches}
    report["wide"] = {
        "lowered_D": dims, "launches": total, "phase_s": phase_s,
        "runs": {op: {"wall_s": r[1], "timings": r[0].timings,
                      "launches": r[2], "lanes": lane_report(np, r[0]),
                      "entries": r[0].entries} for op, r in runs.items()},
        "compare": cmp,
        "protocol": {k: v for k, v in prot.items()
                     if k not in ("dispatches", "labels", "modes")},
        "rightsize": {"launches": launches_r, "kernel_s": kern_s,
                      "numpy_s": numpy_s, "violations": 0},
        "apply": apply, "place_step": step, "two_phase": walk}
    return {"launches": total, "apply": apply, "place_step": step,
            "two_phase": walk, "max_abs_err": apply["max_abs_err"],
            "pool_err": pool_err}


def quickstart_phase(torch, np, report) -> dict:
    """Phase 10d: the quickstart fleet (``sweep_specs(SyntheticSpec(n=80,
    m=5), seeds=2, D=(2, 5))``) through the legacy shim
    ``repro_torch.core.evaluate_many`` on the card and with
    ``device="cpu"``: the legacy call (``lp_iters=400``) with lower bounds
    within rel 1e-4 and costs within rel 1e-5, and the tolerance call with
    the compiled stepper (``lp_tol=5e-3, lp_iters=4000,
    placement="compiled", return_stats=True``) with every lane converged and
    the bounds within tol * (2 + 2 * both bounds), costs within rel 1e-5;
    the same deprecation warning on both devices; the card's stepper
    launches counted (the shim's ``operator="auto"`` is dense here)."""
    import warnings

    from repro_torch import kernels
    from repro_torch.core import evaluate_many
    from repro_torch.workload import (SyntheticSpec, sweep_specs,
                                      synthetic_batch)

    t_phase = time.perf_counter()
    grid = synthetic_batch(sweep_specs(SyntheticSpec(n=80, m=5), seeds=2,
                                       D=(2, 5)))
    calls = {"legacy": dict(lp_iters=400),
             "tol": dict(lp_tol=TOL, lp_iters=4000, placement="compiled",
                         return_stats=True)}
    out, launches = {}, {}
    for device in (None, "cpu"):
        for name, kw in calls.items():
            kernels.reset_launch_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = evaluate_many(grid, device=device, **kw)
            out[name, device] = (got, [str(w.message) for w in caught
                                       if w.category is DeprecationWarning])
            launches[name, device] = kernels.launch_counts()
    for name in calls:
        (a, wa), (b, wb) = out[name, None], out[name, "cpu"]
        if name == "tol":
            (a, sa), (b, sb) = a, b
            if not all(st.converged.all() for st in sa + sb):
                raise AssertionError("quickstart: a tol lane did not "
                                     "converge")
        if wa != wb or len(wa) != 1:
            raise AssertionError(f"quickstart {name}: warnings {wa} vs {wb}")
        for i, (x, y) in enumerate(zip(a, b)):
            if x.keys() != y.keys() or x["costs"].keys() != y["costs"].keys():
                raise AssertionError(f"quickstart {name} {i}: keys differ")
            slack = (LB_RTOL * y["lb"] if name == "legacy"
                     else TOL * (2.0 + 2.0 * (x["lb"] + y["lb"])))
            if abs(x["lb"] - y["lb"]) > slack or any(
                    abs(x["costs"][k] / c - 1) > COST_RTOL
                    for k, c in y["costs"].items()):
                raise AssertionError(f"quickstart {name} {i}: card {x} vs "
                                     f"cpu {y}")
        log(f"quickstart: evaluate_many {calls[name]} on the card equals "
            f"device='cpu' over {len(a)} instances; card launches "
            f"{launches[name, None]}, cpu {launches[name, 'cpu']}")
    # the shim's operator="auto" picks dense (no kernel) at this size; the
    # tol call's compiled placement runs the stepper
    if any(launches["legacy", None].values()) \
            or not launches["tol", None]["place_step"]:
        raise AssertionError(f"quickstart: card launches {launches}")
    if any(v for (name, dev), got in launches.items() if dev == "cpu"
           for v in got.values()):
        raise AssertionError(f"quickstart: the CPU runs launched {launches}")
    phase_s = time.perf_counter() - t_phase
    log(f"quickstart: phase 10d took {phase_s:.1f} s")
    report["quickstart"] = {
        "phase_s": phase_s,
        "launches": {f"{name} {dev or 'card'}": got
                     for (name, dev), got in launches.items()},
        "entries": {f"{name} {dev or 'card'}": (got[0][0] if name == "tol"
                                                else got[0])
                    for (name, dev), got in out.items()}}
    return {"launches": launches["tol", None]}


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
    return {"launches": launches, "max_abs_err": apply_err, "service": svc}


# --- phase 12: stochastic planning -------------------------------------------

# the reference's golden burst grid (benchmarks/stochastic_smoke.py
# GOLDEN_FORECAST, GOLDEN_SELECT, GOLDEN_K), at its own width and at the
# paper's real-world width
STOCH_CHANNELS = dict(cost_model="gce", e=1.0, load_sigma=0.15,
                      diurnal_amp=0.10, burst_prob=0.15, burst_alpha=1.6,
                      burst_cap=8.0)
STOCH_SELECT = dict(seed=0, cvar_alpha=0.9, cvar_lambda=2.0,
                    overload_premium=3.0, recfg_weight=0.0, quantiles=9,
                    algo="lp-map-f")
STOCH_K = 64
STOCH_FULL = dict(n=1000, m=10, seed=0)
STOCH_GOLDEN = dict(n=120, m=6, seed=0)
# benchmarks/check_stochastic.py's _PINNED summary fields
STOCH_PINNED = ("fleet", "fleet_cost", "expected_fleet",
                "expected_fleet_cost", "mean_scenario_cost",
                "worst_scenario_cost", "max_fleet_cost", "mean_overload",
                "cvar_overload", "worst_overload",
                "expected_fleet_worst_overload")
STOCH_GOLDEN_TOL = 1e-6        # check_stochastic's relative slack


class WidestDispatch(FirstDispatch):
    """``FirstDispatch`` that also keeps, in ``widest``, the inputs of the
    dispatch with the most lane-steps (A x L) since it was last reset."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.widest = None

    def __call__(self, *args, **kwargs):
        size = args[0].shape[0] * args[3].shape[0]
        if self.widest is None or \
                size > self.widest[0][0].shape[0] * self.widest[0][3].shape[0]:
            self.widest = None  # one copy at a time
            self.widest = (tuple(a.clone() if isinstance(a, self.torch.Tensor)
                                 else a for a in args),
                           {k: v for k, v in kwargs.items()
                            if k != "telemetry"})
        return super().__call__(*args, **kwargs)


def probed_plan(torch, kernels, cong, kstep, engine, run):
    """``run()`` (a ``plan_stochastic`` or ``preprovision`` call through
    ``engine``) probed: launch counts set to 0 just before it and read just
    after, solver dispatches, its ``solve_scenarios`` LP results, each
    placement call's inputs, telemetry and placements, its last
    ``congestion_lp`` apply and its first and widest stepper dispatches."""
    from repro_torch.core import engine as eng_mod
    from repro_torch.core.batch import dispatch_count

    probe = {"lp": [], "place": []}
    solve, place = engine.solve_scenarios, eng_mod.place_many

    def solved(problems, init=None):
        out = solve(problems, init=init)
        probe["lp"].append(out[0])
        return out

    def placed(batch, maps, **kw):
        tel: dict = {}
        sols = place(batch, maps, telemetry=tel, **kw)
        probe["place"].append((batch, maps, kw, tel, sols))
        return sols

    engine.solve_scenarios = solved
    eng_mod.place_many = placed
    try:
        with LastCall(cong, "congestion_lp") as last, \
                WidestDispatch(torch, kstep, "sub_phase") as disp:
            kernels.reset_launch_counts()
            d0 = dispatch_count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            probe["wall_s"] = time.perf_counter() - t0
            probe["launches"] = kernels.launch_counts()
            probe["dispatches"] = dispatch_count() - d0
    finally:
        eng_mod.place_many = place
        del engine.solve_scenarios
    probe.update(apply=last.args, first=list(disp.log), widest=disp.widest)
    return res, probe


def check_plan_launches(res, probe, what):
    """One LP dispatch, congestion launches = 13 + the most iterations,
    stepper launches = the compiled placements' dispatches, no fallback and
    no other kernel."""
    got = probe["launches"]
    its = res.stats[0].iterations
    steps = sum(tel.get("dispatches", 0) for *_, tel, _ in probe["place"])
    if probe["dispatches"] != 1 or res.lp_dispatches != 1 \
            or res.buckets != 1 or len(probe["lp"]) != 1:
        raise AssertionError(
            f"{what}: {probe['dispatches']} solver dispatches "
            f"(lp_dispatches {res.lp_dispatches}, buckets {res.buckets})")
    if not all(bool(s.converged.all()) for s in res.stats):
        raise AssertionError(f"{what}: a lane did not converge: {its}")
    if got["congestion_many"] != 13 + int(its.max()):
        raise AssertionError(
            f"{what}: {got['congestion_many']} congestion launches, want 13 "
            f"+ max iterations = {13 + int(its.max())}")
    if any(tel.get("engine") != "compiled" for *_, tel, _ in probe["place"]) \
            or got["place_step"] != steps or steps <= 0:
        raise AssertionError(
            f"{what}: {got['place_step']} stepper launches vs telemetry "
            f"{[tel for *_, tel, _ in probe['place']]}")
    if any(got[k] for k in ("fit_scores_many", "fit_scores", "two_phase")):
        raise AssertionError(f"{what}: launched {got}")
    return steps


def plans_against_numpy(np, res, probe, what) -> float:
    """Every placement call of the run against the numpy lockstep engine on
    the same LP mappings, fit for fit: placements equal, and each
    scenario's cheapest plan and cost equal to the run's.  Returns the
    numpy seconds."""
    from repro_torch.core import place_many

    best = np.full(res.K, np.inf)
    plans = np.zeros_like(res.scenario_plans)
    t0 = time.perf_counter()
    for batch, maps, kw, _, sols in probe["place"]:
        want = place_many(batch, maps, fit=kw["fit"], filling=kw["filling"],
                          device="cpu")
        for b, (g, w, t) in enumerate(zip(sols, want, batch.problems)):
            if not (np.array_equal(g.assign, w.assign)
                    and np.array_equal(g.node_type, w.node_type)):
                raise AssertionError(
                    f"{what} {kw['fit']} scenario {b}: compiled placement "
                    f"differs from the numpy lockstep engine's")
            cost = w.cost(t)
            if cost < best[b]:
                best[b], plans[b] = cost, w.nodes_per_type(t)
    if not (np.array_equal(best, res.scenario_costs)
            and np.array_equal(plans, res.scenario_plans)):
        raise AssertionError(
            f"{what}: scenario plans or costs differ from the numpy lockstep "
            f"engine's")
    return time.perf_counter() - t0


def stochastic_line(np, res) -> str:
    its = res.stats[0].iterations
    return (f"K {res.K}, lp_s {res.timings['lp_s']:.3f}, place_s "
            f"{res.timings['place_s']:.3f}, iterations median "
            f"{float(np.median(its))} max {int(its.max())}, restarts "
            f"{int(res.stats[0].restarts.sum())}")


def stochastic_phase(torch, np, ref, kernels, cong, fleet, svc,
                     report) -> dict:
    """Phase 12: stochastic planning (see the module docstring).  ``svc`` is
    phase 11's warm-replayed service.  Returns each run's launches and the
    kernels' timings at the full-width shapes."""
    import contextlib
    import io

    from repro_torch.core.batch import dispatch_count
    from repro_torch.kernels import place_step as kstep
    from repro_torch.launch import rightsize as cli
    from repro_torch.stochastic import (DemandForecast, StochasticConfig,
                                        gct_forecast, plan_stochastic)

    t_phase = time.perf_counter()
    out: dict = {"launches": {}}

    # (a) the golden burst grid at full width
    fc = gct_forecast(**STOCH_FULL, **STOCH_CHANNELS)
    config = StochasticConfig(scenarios=STOCH_K, **STOCH_SELECT)
    engine = serve_engine()
    log(f"stochastic: gct_forecast({STOCH_FULL}, {STOCH_CHANNELS}), "
        f"StochasticConfig(scenarios={STOCH_K}, {STOCH_SELECT}), the serving "
        f"loop's card engine")
    res, probe = probed_plan(torch, kernels, cong, kstep, engine,
                             lambda: plan_stochastic(fc, config,
                                                     engine=engine))
    steps = check_plan_launches(res, probe, "stochastic full")
    out["launches"]["full"] = probe["launches"]
    summ = res.summary()
    log(f"stochastic full: {stochastic_line(np, res)}; wall "
        f"{probe['wall_s']:.3f} s; launches {probe['launches']} ({steps} "
        f"stepper dispatches over {len(probe['place'])} placement calls, "
        f"modes {sorted({tel['mode'] for *_, tel, _ in probe['place']})})")
    if not summ["fleet_cost"] <= summ["max_fleet_cost"] + STOCH_GOLDEN_TOL:
        raise AssertionError(f"stochastic full: {summ}")
    numpy_s = plans_against_numpy(np, res, probe, "stochastic full")
    start, end, w_all, x, Tp = probe["apply"]
    B, n, m, D = w_all.shape
    apply = apply_timing(torch, ref, cong, probe["apply"])
    pool_err, mismatches = replay_dispatches(
        torch, ref, kstep, probe["first"] + [probe["widest"]],
        ["stochastic first", "stochastic widest"])
    step = time_dispatch(torch, ref, kstep, *probe["widest"])
    log(f"stochastic full: {len(probe['place'])} placement calls equal to the "
        f"numpy lockstep engine's ({numpy_s:.3f} s), every scenario's plan "
        f"and cost equal; last apply at B={B} n={n} m={m} D={D} T'={Tp} "
        f"within rtol/atol {CONG_RTOL} of the plain version (max |err| "
        f"{apply['max_abs_err']:.3g}); the first and the widest stepper "
        f"dispatch bit-equal to the plain version (max |pool err| "
        f"{pool_err}, {mismatches} differ)")
    log(timing_line("congestion_lp (stochastic)", apply))
    log(f"timing: congestion_lp (stochastic) launch shape {apply['plan']}")
    log(f"timing: place_step widest wave (stochastic) at {step['shape']}: "
        f"kernel {step['ms']:.6f} ms (device; {step['call_ms']:.6f} per "
        f"wrapper call), plain {step['plain_ms']:.6f} (CUDA events), bound "
        f"{step['bound_ms']:.3e} ({step['bound_by']}); smem_rows "
        f"{step['smem_rows']}, spilled lanes {step['spilled_lanes']}")
    wall = probe["wall_s"]
    probe.clear()
    log(f"stochastic full: fleet {summ['fleet']} (cost {summ['fleet_cost']}), "
        f"expected-only {summ['expected_fleet']} (cost "
        f"{summ['expected_fleet_cost']}), max fleet cost "
        f"{summ['max_fleet_cost']}, mean scenario cost "
        f"{summ['mean_scenario_cost']}; worst overload {summ['worst_overload']}"
        f" against the expected-only fleet's "
        f"{summ['expected_fleet_worst_overload']} (a reading); frontier:")
    for row in summ["frontier"]:
        log(f"stochastic full: frontier {row}")
    t0 = time.perf_counter()
    again = plan_stochastic(fc, config, engine=engine)
    again_s = time.perf_counter() - t0
    if again.summary() != summ:
        raise AssertionError(
            f"stochastic full: a second call differs: {again.summary()} vs "
            f"{summ}")
    log(f"stochastic full: a second call's summary() bit-equal "
        f"({again_s:.3f} s)")
    out["full"] = {"summary": summ, "timings": res.timings,
                   "wall_s": wall, "again_s": again_s,
                   "numpy_s": numpy_s, "apply": apply, "place_step": step,
                   "iterations": res.stats[0].iterations.tolist()}
    del res, again

    # (b) the golden grid at its own width
    gfc = gct_forecast(**STOCH_GOLDEN, **STOCH_CHANNELS)
    gres, gprobe = probed_plan(torch, kernels, cong, kstep, engine,
                               lambda: plan_stochastic(gfc, config,
                                                       engine=engine))
    check_plan_launches(gres, gprobe, "stochastic golden")
    out["launches"]["golden"] = gprobe["launches"]
    cur = gres.summary()
    if not (cur["mean_scenario_cost"] <= cur["fleet_cost"] + STOCH_GOLDEN_TOL
            and cur["fleet_cost"] <= cur["max_fleet_cost"] + STOCH_GOLDEN_TOL
            and cur["worst_overload"] < cur["expected_fleet_worst_overload"]):
        raise AssertionError(f"stochastic golden: invariants broken: {cur}")
    golden = json.loads((HERE / "results" / "golden" /
                         "stochastic.json").read_text())
    same = [k for k in STOCH_PINNED
            if close_to(cur[k], golden[k], STOCH_GOLDEN_TOL)]
    rows = sum(close_to(a, b, STOCH_GOLDEN_TOL)
               for a, b in zip(cur["frontier"], golden["frontier"]))
    log(f"stochastic golden: {stochastic_line(np, gres)}; launches "
        f"{gprobe['launches']}; mean scenario cost "
        f"{cur['mean_scenario_cost']} <= fleet cost {cur['fleet_cost']} <= "
        f"max {cur['max_fleet_cost']}; worst overload {cur['worst_overload']}"
        f" < expected-only {cur['expected_fleet_worst_overload']}; reproduces "
        f"{len(same)} of {len(STOCH_PINNED)} pinned fields and {rows} of "
        f"{len(golden['frontier'])} frontier rows of the golden within "
        f"{STOCH_GOLDEN_TOL} (a reading); apart: "
        + ", ".join(f"{k} {cur[k]} vs {golden[k]}" for k in STOCH_PINNED
                    if k not in same))
    out["golden"] = {"summary": cur, "pinned_matched": same,
                     "frontier_rows_matched": rows, "timings": gres.timings}
    del gres, gprobe

    # (c) degeneracy: every channel off, K = 1, Table-I instance 0
    dfc = DemandForecast(base=fleet[0], load_sigma=0.0, diurnal_amp=0.0,
                         burst_prob=0.0)
    dres, dprobe = probed_plan(
        torch, kernels, cong, kstep, engine,
        lambda: plan_stochastic(dfc, StochasticConfig(scenarios=1,
                                                      quantiles=2),
                                engine=engine))
    check_plan_launches(dres, dprobe, "stochastic degenerate")
    out["launches"]["degenerate"] = dprobe["launches"]
    point = engine.evaluate([fleet[0]]).entries[0]["costs"]["lp-map-f"]
    if dres.scenario_costs[0] != point or dres.worst_overload != 0.0:
        raise AssertionError(
            f"stochastic degenerate: scenario cost {dres.scenario_costs[0]} "
            f"vs evaluate's {point}")
    log(f"stochastic degenerate: {stochastic_line(np, dres)}; K=1 "
        f"zero-variance scenario cost {dres.scenario_costs[0]} equal to "
        f"FleetEngine.evaluate's lp-map-f cost on Table-I instance 0; "
        f"launches {dprobe['launches']}")
    out["degenerate"] = {"cost": float(point)}
    del dres, dprobe

    # (d) preprovision on phase 11's warm-replayed service
    name = svc.fleets[0]
    st = svc._fleets[name]
    before, sol = st.plan.copy(), st.solution
    assign = sol.assign.copy()
    n_events = len(svc.events)
    pres, pprobe = probed_plan(torch, kernels, cong, kstep, svc.engine,
                               lambda: svc.preprovision(name))
    check_plan_launches(pres, pprobe, "preprovision")
    out["launches"]["preprovision"] = pprobe["launches"]
    after = st.plan
    ev = svc.events[-1]
    cost = float(after @ st.problem.node_types.cost)
    if pres.K != 16 or not (after >= before).all() \
            or len(svc.events) != n_events + 1 \
            or ev.scope != "preprovision" or ev.fleet != name \
            or ev.cost_after != cost or st.plan_cost != cost \
            or st.solution is not sol \
            or not np.array_equal(st.solution.assign, assign):
        raise AssertionError(
            f"preprovision {name}: plan {before} -> {after}, event {ev}")
    log(f"preprovision {name}: {stochastic_line(np, pres)}; launches "
        f"{pprobe['launches']}; plan {before.tolist()} -> {after.tolist()} "
        f"(growth only), ScaleEvent cost {ev.cost_before} -> "
        f"{ev.cost_after}; placement unchanged")
    out["preprovision"] = {"fleet": name, "before": before.tolist(),
                           "after": after.tolist(),
                           "cost_before": ev.cost_before,
                           "cost_after": ev.cost_after,
                           "timings": pres.timings}
    del pres, pprobe

    # (e) the CLI on the jobs fleet, in the card configuration
    argv = ["plan", "--scenarios", "16", "--lp-tol", "5e-3", "--lp-iters",
            "4000", "--operator", "pallas", "--placement", "compiled"]
    kernels.reset_launch_counts()
    d0 = dispatch_count()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cres = cli.run(argv)
    torch.cuda.synchronize()
    cl = kernels.launch_counts()
    # the point plan's LP solve, then the scenario group's one dispatch
    if cres.lp_dispatches != 1 or dispatch_count() - d0 != 2 \
            or cl["congestion_many"] <= 0 or cl["place_step"] <= 0:
        raise AssertionError(
            f"CLI plan --scenarios 16: lp_dispatches {cres.lp_dispatches}, "
            f"dispatches {dispatch_count() - d0}, launches {cl}")
    out["launches"]["cli"] = cl
    head = [ln for ln in text.getvalue().splitlines()
            if ln.startswith(("== ", "  robust", "  expected"))]
    log(f"CLI {' '.join(argv)}: {stochastic_line(np, cres)}; launches {cl}; "
        + " | ".join(head))
    phase_s = time.perf_counter() - t_phase
    log(f"stochastic: phase 12 took {phase_s:.1f} s")
    out["phase_s"] = phase_s
    report["stochastic"] = out
    return {"launches": out["launches"], "apply": apply, "place_step": step,
            "max_abs_err": apply["max_abs_err"]}


def close_to(a, b, tol) -> bool:
    """``benchmarks/check_stochastic.py``'s comparison: lists and dicts item
    by item, floats within ``tol`` relative slack, the rest equal."""
    if isinstance(a, list) or isinstance(b, list):
        return (isinstance(a, list) and isinstance(b, list)
                and len(a) == len(b)
                and all(close_to(x, y, tol) for x, y in zip(a, b)))
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys()
                and all(close_to(a[k], b[k], tol) for k in a))
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b)) <= tol * max(1.0, abs(float(a)),
                                                     abs(float(b)))
    return a == b


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


def time_walk(torch, ref, kstep, args, kw, work, steps, chain_ns) -> dict:
    """One recorded two_phase launch timed: device ms per launch
    (profiled), the plain version's and the wrapper call's ms (CUDA
    events), its bytes/operations bound (``walk_work`` on the plain
    version's ``work`` tally) and its latency bound (``steps`` attempts
    times ``chain_ns``), with the rows each CTA kept in shared memory."""
    fn = lambda: kstep.two_phase_walk(*args, **kw)  # noqa: E731
    ms = device_ms(torch, fn, reps=20, warmup=3)
    plain = cuda_ms(torch, lambda: ref.two_phase_ref(
        *args, kw["similarity"], kw["sequential"], kw["rows"]),
        reps=2, warmup=1)
    call = cuda_ms(torch, fn, reps=20, warmup=3)
    b_ms, b_by = bound(*walk_work(args, work), PEAK_F64_FLOPS)
    tel: dict = {}
    kstep.two_phase_walk(*args, **kw, telemetry=tel)
    return {"shape": {"n": args[3].shape[0], "P": args[2].shape[0],
                      "T": args[7], "D": args[3].shape[1],
                      "E": args[0].shape[0], **kw,
                      "smem_rows": tel["smem_rows"]},
            "steps": steps, "ms": ms, "plain_ms": plain, "call_ms": call,
            "bound_ms": b_ms, "bound_by": b_by,
            "latency_bound_ms": steps * chain_ns * 1e-6,
            "ns_per_step": ms * 1e6 / max(steps, 1)}


def walk_line(what, info, chain_ns) -> str:
    return (f"timing: {what} at {info['shape']}: ms per launch: kernel "
            f"{info['ms']:.6f} (device; {info['call_ms']:.6f} per wrapper "
            f"call by CUDA events), plain {info['plain_ms']:.6f} (CUDA "
            f"events), bound {info['bound_ms']:.3e} ({info['bound_by']}), "
            f"latency bound {info['latency_bound_ms']:.6f} ({info['steps']} "
            f"attempts x {chain_ns:.3f} ns barrier chain); "
            f"{info['ns_per_step']:.1f} device ns per attempt")


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

    # lp-map-f's two launches (first, then similarity fit)
    per_fit = {("similarity" if rec.log[i][1]["similarity"] else "first"):
               time_walk(torch, ref, kstep, *rec.log[i], works[i], steps[i],
                         chain_ns) for i in (calls - 2, calls - 1)}
    for fit_name, info in per_fit.items():
        log(walk_line(f"two_phase lp-map-f {fit_name}", info, chain_ns))

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


# --- phase 13: the LM serving path -------------------------------------------

LM_ARCH = "gemma2-9b"            # repro.launch.serve's default --arch
LM_BATCH, LM_PROMPT, LM_GEN = 4, 4100, 16  # the prompt passes the 4096 window
LM_PARITY_AT = (0, 3, 7)         # 13b: decode steps held against a prefill
LM_PARITY_ATOL = 5e-3            # tests/test_archs.py test_prefill_decode_parity
LM_CARD_ATOL = 1e-4              # 13c: the card against the port's CPU run
PEAK_BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core rate


def lm_bounds(model, cfg, B: int, S: int) -> dict:
    """Least times (ms) of one prefill of B x S tokens and of the decode
    step after it, from the shapes.  Prefill: the matmul operations (two per
    weight per token, the unembedding on the last token only, and QK and PV
    over the query/key pairs the causal and window masks keep) at the bf16
    peak.  Decode step: every parameter read once (the unembedding reads the
    whole table) and every filled cache entry read once, at the memory
    rate."""
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = cfg.vocab_size * cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pairs = 0
    filled = 0
    for kind, window, _t, _m in cfg.pattern:
        w = S if window < 0 else min(window, S)
        pairs += sum(min(i + 1, w) for i in range(S))
        filled += min(S + 1, w if window > 0 else S + 1)
    flops = (2.0 * (n_params - n_embed) * B * S + 2.0 * n_embed * B
             + 4.0 * B * H * hd * pairs)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    elt = next(model.parameters()).element_size()
    kv_bytes = 2.0 * B * filled * KV * hd * elt
    return {"prefill_ms": flops / PEAK_BF16_FLOPS * 1e3,
            "prefill_flops": flops,
            "decode_ms": (weight_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3,
            "decode_bytes": weight_bytes + kv_bytes,
            "decode_weight_bytes": float(weight_bytes),
            "decode_kv_bytes": kv_bytes}


def lm_serve_full(torch, report) -> dict:
    """13a: gemma2-9b at full width in bf16 through ``launch.serve``'s own
    functions: B = 4, a 4100-token prompt, 16 greedy tokens, twice (the
    first call warms cuBLAS); then three profiled decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import decode_step, init_params, prefill

    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(gen, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weights = torch.cuda.memory_allocated() - base
    log(f"lm: {cfg.name} bf16 {n_params} parameters ({weights / 1e9:.3f} GB "
        f"on the card; {base / 1e9:.3f} GB held by earlier phases) "
        f"initialized in {init_s:.2f} s")
    batch = lm_serve.make_batch(cfg, LM_BATCH, LM_PROMPT, gen)
    runs = []
    for call in ("cold", "warm"):
        ids, info = lm_serve.generate(model, batch, LM_GEN)
        if not info["finite"]:
            raise AssertionError(f"13a {call}: non-finite logits")
        if tuple(ids.shape) != (LM_BATCH, LM_GEN) or not bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()):
            raise AssertionError(f"13a {call}: ids {tuple(ids.shape)} out "
                                 f"of range")
        run = {"call": call, "prefill_s": info["prefill_s"],
               "decode_s": info["decode_s"], "steps": info["steps"],
               "prefill_tok_s": LM_BATCH * LM_PROMPT / info["prefill_s"],
               "decode_ms_step": info["decode_s"] / info["steps"] * 1e3,
               "ids_row0": ids[0].tolist()}
        runs.append(run)
        log(f"lm 13a {call}: prefill batch={LM_BATCH} len={LM_PROMPT} "
            f"{run['prefill_s']:.3f} s ({run['prefill_tok_s']:.1f} tok/s); "
            f"decode {run['steps']} steps {run['decode_s']:.3f} s "
            f"({run['decode_ms_step']:.3f} ms/step); generated ids (row 0) "
            f"{run['ids_row0']}")
    if runs[0]["ids_row0"] != runs[1]["ids_row0"]:
        raise AssertionError("13a: two greedy calls generated other ids")
    peak = torch.cuda.max_memory_allocated()
    # three decode steps under a marker-checked profile: device kernels and
    # busy time per step, beside the host's wall per step
    _logits, state = prefill(model, batch, max_len=LM_PROMPT + 4)
    tokens = batch["tokens"][:, -1]
    steps = [state]

    def step():
        steps[0] = decode_step(model, steps[0], tokens)[1]

    evs = fn_events(torch, step, reps=3, warmup=0)
    del state, steps, _logits
    # and one prefill
    evs_p = fn_events(torch, lambda: prefill(model, batch, LM_PROMPT + 4),
                      reps=1, warmup=0)
    bounds = lm_bounds(model, cfg, LM_BATCH, LM_PROMPT)
    warm = runs[1]
    profiled = {}
    for what, ev, reps, wall_ms in (
            ("decode step", evs, 3, warm["decode_ms_step"]),
            ("prefill", evs_p, 1, warm["prefill_s"] * 1e3)):
        busy_ms = sum(d for _, d in ev) * 1e3 / reps
        top = collections.Counter()
        for name, d in ev:
            top[name[:80]] += d * 1e3 / reps
        profiled[what] = {"kernels": len(ev) / reps, "busy_ms": busy_ms,
                          "idle_share": 1.0 - busy_ms / wall_ms,
                          "top_ms": dict(top.most_common(8))}
        log(f"lm 13a: a {what} puts {len(ev) / reps:.1f} kernels and copies "
            f"on the card, {busy_ms:.3f} ms busy of {wall_ms:.3f} ms (idle "
            f"share {1.0 - busy_ms / wall_ms:.4f})")
        for name, ms in top.most_common(8):
            log(f"lm 13a: {what} device ms {ms:.4f}  {name}")
    log(f"lm 13a: peak memory {peak / 1e9:.3f} GB "
        f"(torch.cuda.max_memory_allocated; {(peak - base) / 1e9:.3f} GB "
        f"above what earlier phases hold); bounds: prefill "
        f"{bounds['prefill_ms']:.3f} ms ({bounds['prefill_flops']:.4g} "
        f"operations at the bf16 peak), decode step "
        f"{bounds['decode_ms']:.3f} ms ({bounds['decode_bytes'] / 1e9:.3f} "
        f"GB at the memory rate)")
    out = {"arch": cfg.name, "params": n_params, "init_s": init_s,
           "weight_bytes": weights, "peak_bytes": peak,
           "earlier_phases_bytes": base, "runs": runs,
           "profiled": profiled, "bounds": bounds, "card": report["card"]}
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_consistency_f32(torch) -> dict:
    """13b: gemma2-9b at full width in float32, batch 1: prefill 4100
    tokens, decode 8 greedy tokens, and at LM_PARITY_AT hold the decode
    logits against a fresh prefill of the same tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(1)
    model = init_params(gen, cfg, dev)
    seq = torch.randint(0, cfg.vocab_size, (1, LM_PROMPT), generator=gen,
                        device=dev)
    steps = max(LM_PARITY_AT) + 1
    logits, state = prefill(model, {"tokens": seq}, max_len=LM_PROMPT + steps)
    tok = torch.argmax(logits, dim=-1)
    errs = {}
    for j in range(steps):
        logits, state = decode_step(model, state, tok)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        if j in LM_PARITY_AT:
            fresh, _ = prefill(model, {"tokens": seq}, max_len=seq.shape[1])
            errs[j] = float((logits - fresh).abs().max())
            log(f"lm 13b: decode step {j} (position {LM_PROMPT + j}) against "
                f"a fresh prefill of {seq.shape[1]} tokens: max |diff| "
                f"{errs[j]:.3e}")
            if not errs[j] <= LM_PARITY_ATOL:
                raise AssertionError(f"13b: decode step {j} differs from a "
                                     f"fresh prefill by {errs[j]}")
            del fresh
        tok = torch.argmax(logits, dim=-1)
    del model, state, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_err": errs, "atol": LM_PARITY_ATOL}


def lm_archs_card_vs_cpu(torch) -> dict:
    """13c: every architecture's smoke config in float32 (local windows
    cut below the prompt), one model run on the CPU and then moved to the
    card (``tests/_torch_lm_card.py``, which the card tests share): logits,
    states and MoE routing must agree."""
    sys.path.append(str(HERE / "tests"))
    from _torch_lm_card import card_vs_cpu

    from repro_torch.configs import ARCHS

    from repro_torch import kernels

    out = {}
    for arch in sorted(ARCHS):
        kernels.reset_launch_counts()
        r = card_vs_cpu(arch, torch.device("cuda"))
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        log(f"lm 13c {arch}: card vs CPU max |diff| logits {r['logits']:.3e}, "
            f"states {r['states']:.3e}; MoE dispatches {r['moe_dispatches']} "
            f"(slots equal: {r['moe_equal']}, dropped {r['dropped']}); "
            f"kernel launches {launches}")
        rec = REC_KERNEL.get(arch)
        if rec and not launches.get(rec, 0) > 0:
            raise AssertionError(f"13c {arch}: the card run did not go "
                                 f"through {rec}: {launches}")
        if not (r["logits"] <= LM_CARD_ATOL and r["states"] <= LM_CARD_ATOL):
            raise AssertionError(f"13c {arch}: card vs CPU logits "
                                 f"{r['logits']}, states {r['states']}")
        if not r["ints_equal"]:
            raise AssertionError(f"13c {arch}: slot positions differ")
        if not r["moe_equal"]:
            raise AssertionError(f"13c {arch}: MoE routing differs")
        out[arch] = {k: r[k] for k in ("logits", "states", "moe_dispatches",
                                       "dropped")}
    return out


def lm_phase(torch, report) -> dict:
    """Phase 13: the LM serving path (13a bf16 serving, 13b f32
    prefill/decode consistency, 13c every architecture card vs CPU)."""
    t_phase = time.perf_counter()
    out = {"serve": lm_serve_full(torch, report)}
    t_b = time.perf_counter()
    out["consistency"] = lm_consistency_f32(torch)
    t_c = time.perf_counter()
    out["archs"] = lm_archs_card_vs_cpu(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"lm: phase 13 took {out['phase_s']:.1f} s (13a {t_b - t_phase:.1f} "
        f"s, 13b {t_c - t_b:.1f} s, 13c {time.perf_counter() - t_c:.1f} s)")
    report["lm"] = out
    return out


# --- phase 14: the LM training path ------------------------------------------

TRAIN_ARCH = "qwen2.5-3b"        # repro.launch.train's default --arch
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 10
TRAIN_CARD_ATOL = 1e-4           # 14b: the card against the port's CPU run
TRAIN_FALL = 0.2                 # 14c: tests/test_train.py test_loss_decreases
TRAIN_MB_ATOL = 5e-5             # 14c: test_microbatch_matches_full_batch_grads
TRAIN_RTOL, TRAIN_ATOL = 1e-6, 1e-7  # 14c: test_restart_resumes_exact_trajectory


def train_bounds(model, cfg, B: int, S: int) -> dict:
    """Least times (ms) of one training step of B x S tokens, from the
    shapes.  Forward and backward: the matmul operations, six per parameter
    per token (the embedding counted once, as the tied unembedding) and
    twelve per head dimension per query/key pair the causal and window masks
    keep (QK and PV, forward and two products backward), at the bf16 peak.
    The optimizer update: parameters, gradients (in the parameters' dtype)
    and both moments read once, parameters and moments written once, at
    the memory rate."""
    n_params = sum(p.numel() for p in model.parameters())
    H, hd = cfg.num_heads, cfg.head_dim
    pairs = 0
    for kind, window, _t, _m in cfg.pattern:
        w = S if window < 0 else min(window, S)
        pairs += sum(min(i + 1, w) for i in range(S))
    flops = 6.0 * n_params * B * S + 12.0 * B * H * hd * pairs
    opt_bytes = sum(p.numel() * (3 * p.element_size() + 4 * 4)
                    for p in model.parameters())
    return {"step_ms": flops / PEAK_BF16_FLOPS * 1e3, "step_flops": flops,
            "opt_ms": opt_bytes / PEAK_BYTES_PER_S * 1e3,
            "opt_bytes": float(opt_bytes)}


def profile_call(torch, what, fn, wall_ms=None, top_n=8) -> dict:
    """One call of ``fn`` under a marker-checked profile: kernels, busy ms
    and, given the call's wall, idle share; the costliest kernels."""
    ev = fn_events(torch, fn, reps=1, warmup=0)
    busy_ms = sum(d for _, d in ev) * 1e3
    top = collections.Counter()
    for name, d in ev:
        top[name[:80]] += d * 1e3
    out = {"kernels": len(ev), "busy_ms": busy_ms,
           "top_ms": dict(top.most_common(top_n))}
    line = f"train 14a: {what}: {len(ev)} kernels and copies, {busy_ms:.3f} ms busy"
    if wall_ms is not None:
        out["idle_share"] = 1.0 - busy_ms / wall_ms
        line += f" of {wall_ms:.3f} ms (idle share {out['idle_share']:.4f})"
    log(line)
    for name, ms in top.most_common(top_n):
        log(f"train 14a: {what} device ms {ms:.4f}  {name}")
    return out


def host_memory_gb() -> tuple[float, float]:
    """(total, available) host memory in GB from /proc/meminfo."""
    info = {}
    for row in pathlib.Path("/proc/meminfo").read_text().splitlines():
        key, val = row.split(":", 1)
        info[key] = int(val.split()[0]) * 1024
    return info["MemTotal"] / 1e9, info["MemAvailable"] / 1e9


def train_full(torch, report) -> dict:
    """14a: qwen2.5-3b at full width through ``launch.train.run`` (bf16
    parameters, float32 AdamW state, remat, a loss chunk of 256), then a
    restore of its checkpoint into a fresh model and state, then one
    profiled warm step and its parts."""
    import io
    import shutil
    import statistics
    import tempfile
    from contextlib import redirect_stdout

    from repro_torch.launch import train as lm_train
    from repro_torch.models import loss_fn
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   checkpoint, make_batch, make_train_step)
    from repro_torch.train.data import to_device
    from repro_torch.train.optimizer import adamw_update

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (HERE / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="train14a_", dir=HERE / "build")
    try:
        disk = shutil.disk_usage(ckdir)
        mem_total, mem_avail = host_memory_gb()
        log(f"train 14a: host memory {mem_total:.1f} GB, {mem_avail:.1f} GB "
            f"available; {disk.free / 1e9:.1f} GB free of {disk.total / 1e9:.1f} "
            f"GB on the checkpoint's disk")
        argv = ["--arch", TRAIN_ARCH, "--preset", "full", "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
                str(TRAIN_STEPS), "--ckpt-every", str(TRAIN_STEPS),
                "--ckpt-dir", ckdir]
        out = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(out):
            model, state, hist = lm_train.run(argv)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for row in out.getvalue().splitlines():
            log(f"train 14a: | {row}")
        cfg = model.cfg
        losses, gnorms, walls = hist["loss"], hist["grad_norm"], hist["wall_s"]
        if len(losses) != TRAIN_STEPS or not all(
                math.isfinite(x) for x in losses + gnorms):
            raise AssertionError(f"14a: losses {losses}, grad norms {gnorms}")
        n_params = sum(p.numel() for p in model.parameters())
        warm_s = statistics.median(walls[1:])
        tok_s = TRAIN_BATCH * TRAIN_SEQ / warm_s
        (rec,) = hist["checkpoints"]
        log(f"train 14a: {cfg.name} {n_params} parameters, B={TRAIN_BATCH} "
            f"S={TRAIN_SEQ}: losses {[round(x, 6) for x in losses]}; grad "
            f"norms {[round(x, 6) for x in gnorms]}")
        log(f"train 14a: step s cold {walls[0]:.3f}, warm median {warm_s:.3f} "
            f"(range {min(walls[1:]):.3f}-{max(walls[1:]):.3f}); "
            f"{tok_s:.1f} tokens/s; peak memory {peak / 1e9:.3f} GB "
            f"(torch.cuda.max_memory_allocated; {base / 1e9:.3f} GB held by "
            f"earlier phases); run {run_s:.1f} s")
        log(f"train 14a: checkpoint step {rec['step']}: {rec['bytes']} bytes, "
            f"snapshot {rec['snapshot_s']:.3f} s, commit {rec['commit_s']:.3f} "
            f"s ({rec['bytes'] / rec['commit_s'] / 1e9:.3f} GB/s)")

        # restore into a fresh model and state on the card: bit-equal
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        (m2, s2), got = checkpoint.restore(ckdir, (model, state))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        live = list(checkpoint._leaves((model, state)))
        fresh = list(checkpoint._leaves((m2, s2)))
        if got != TRAIN_STEPS or [k for k, _ in live] != [k for k, _ in fresh]:
            raise AssertionError(f"14a: restored step {got}")
        unequal = [k for (k, a), (_k, b) in zip(live, fresh)
                   if a.dtype != b.dtype or not torch.equal(a, b)]
        if unequal:
            raise AssertionError(f"14a: restored leaves differ: {unequal[:5]}")
        log(f"train 14a: restored {len(fresh)} leaves into a fresh model and "
            f"state on the card in {restore_s:.3f} s, bit-equal")
        del m2, s2, fresh
        gc.collect()
        torch.cuda.empty_cache()
        restore_sharded_s = sharded_restore(torch, checkpoint, ckdir, model,
                                            state, live, restore_s)
        del live
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # one warm step under a marker-checked profile, then its parts
    tc = TrainConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=20),
                     remat=True, loss_chunk=min(256, TRAIN_SEQ))
    dc = DataConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    step_fn = make_train_step(model, tc)
    dev = model.device
    bounds = train_bounds(model, cfg, TRAIN_BATCH, TRAIN_SEQ)
    prof = {"step": profile_call(
        torch, "a warm step", lambda: step_fn(state, make_batch(
            cfg, dc, TRAIN_STEPS)), warm_s * 1e3)}
    names, plist = zip(*model.named_parameters())
    batch = to_device(make_batch(cfg, dc, TRAIN_STEPS + 1), dev)
    prof["data"] = profile_call(torch, "data (make_batch, to the card)",
                            lambda: to_device(make_batch(
                                cfg, dc, TRAIN_STEPS + 1), dev), top_n=3)
    grads = []

    def fwd_bwd():
        loss, _m = loss_fn(model, batch, remat=True, loss_chunk=tc.loss_chunk)
        grads[:] = torch.autograd.grad(loss, plist)

    prof["forward_backward"] = profile_call(torch, "forward + backward", fwd_bwd)
    g = dict(zip(names, grads))
    params = dict(zip(names, plist))
    prof["optimizer"] = profile_call(
        torch, "optimizer update",
        lambda: adamw_update(params, g, state["opt"], tc.optimizer))
    del grads, g, batch
    log(f"train 14a: bounds: forward + backward {bounds['step_ms']:.3f} ms "
        f"({bounds['step_flops']:.4g} matmul operations at the bf16 peak; "
        f"measured {prof['forward_backward']['busy_ms']:.3f} ms busy, "
        f"{prof['forward_backward']['busy_ms'] / bounds['step_ms']:.2f}x), "
        f"optimizer {bounds['opt_ms']:.3f} ms ({bounds['opt_bytes'] / 1e9:.3f} "
        f"GB at the memory rate; measured {prof['optimizer']['busy_ms']:.3f} "
        f"ms busy, {prof['optimizer']['busy_ms'] / bounds['opt_ms']:.2f}x)")
    out = {"arch": cfg.name, "params": n_params, "losses": losses,
           "grad_norms": gnorms, "step_s": walls, "warm_step_s": warm_s,
           "tokens_per_s": tok_s, "peak_bytes": peak,
           "earlier_phases_bytes": base, "run_s": run_s, "checkpoint": rec,
           "restore_s": restore_s, "restore_sharded_s": restore_sharded_s,
           "profiled": prof, "bounds": bounds,
           "card": report["card"]}
    del model, state, step_fn, params, plist
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_archs_card_vs_cpu(torch, dev) -> dict:
    """14b: every architecture's smoke config in float32, one loss and
    backward on the CPU and on the card (``tests/_torch_train_card.py``,
    which the card tests share): loss and every gradient within 1e-4, MoE
    routing equal."""
    sys.path.append(str(HERE / "tests"))
    from _torch_train_card import train_card_vs_cpu

    from repro_torch.configs import ARCHS

    from repro_torch import kernels

    out = {}
    for arch in sorted(ARCHS):
        kernels.reset_launch_counts()
        r = train_card_vs_cpu(arch, dev)
        r["launches"] = {k: v for k, v in kernels.launch_counts().items()
                         if v}
        log(f"train 14b {arch}: card vs CPU |loss diff| {r['loss']:.3e}, aux "
            f"{r['aux']:.3e}, gradients at most {r['grad_rel']:.3e} of their "
            f"max |value| ({r['grad_worst']}); MoE dispatches "
            f"{r['moe_dispatches']} (slots equal: {r['moe_equal']}); kernel "
            f"launches {r['launches']}")
        rec = REC_KERNEL.get(arch)
        if rec and not (r["launches"].get(rec, 0) > 0
                        and r["launches"].get(rec + "_backward", 0) > 0):
            raise AssertionError(f"14b {arch}: the card run did not go "
                                 f"through {rec}: {r['launches']}")
        if not (r["loss"] <= TRAIN_CARD_ATOL and r["aux"] <= TRAIN_CARD_ATOL
                and r["grad_rel"] <= TRAIN_CARD_ATOL):
            raise AssertionError(f"14b {arch}: card vs CPU {r}")
        if not r["moe_equal"]:
            raise AssertionError(f"14b {arch}: MoE routing differs")
        out[arch] = r
    return out


def train_reference_setups(torch, dev) -> dict:
    """14c: tests/test_train.py's setups on the card (qwen2.5-3b smoke, lr
    1e-3, warmup 5, B = 4, S = 32, loss chunk 64): the loss falls, plain
    and compressed; microbatch 4 matches 1; restarts resume the exact
    trajectory; the CLI crashes and resumes."""
    import io
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    from repro_torch.configs import smoke_config
    from repro_torch.launch import train as lm_train
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   init_train_state, make_batch,
                                   make_train_step)
    from repro_torch.train.fault import (FaultInjector, LoopConfig,
                                         run_with_restarts)

    cfg = smoke_config(TRAIN_ARCH)
    dc = DataConfig(batch=4, seq_len=32)

    def setup(microbatch=1, compress=False):
        tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=5),
                         remat=True, microbatch=microbatch, loss_chunk=64,
                         compress_grads=compress)
        model = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
        return model, init_train_state(model, tc), make_train_step(model, tc)

    out = {}
    for compress in (False, True):
        model, state, step = setup(compress=compress)
        losses = []
        for i in range(30):
            state, m = step(state, make_batch(cfg, dc, i))
            losses.append(float(m["loss"]))
        fall = sum(losses[:5]) / 5 - sum(losses[-5:]) / 5
        what = "compressed" if compress else "plain"
        log(f"train 14c: 30 steps {what}: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, fall {fall:.4f} (first 5 against last 5; "
            f"needs > {TRAIN_FALL})")
        if not fall > TRAIN_FALL:
            raise AssertionError(f"14c {what}: the loss fell {fall}")
        out[f"fall_{what}"] = fall

    batch = make_batch(cfg, dc, 0)
    m1, s1, step1 = setup(1)
    m4, s4, step4 = setup(4)
    step1(s1, batch)
    step4(s4, batch)
    mb = max(float((a.detach() - b.detach()).abs().max())
             for a, b in zip(m1.parameters(), m4.parameters()))
    log(f"train 14c: microbatch 4 against 1 after one step: max |diff| "
        f"{mb:.3e} (bound {TRAIN_MB_ATOL})")
    if not mb < TRAIN_MB_ATOL:
        raise AssertionError(f"14c: microbatch 4 differs by {mb}")
    out["microbatch"] = mb

    root = tempfile.mkdtemp(prefix="train14c_", dir=HERE / "build")
    try:
        def make_args():
            model, state, step = setup()
            return step, model, state, (lambda s: make_batch(cfg, dc, s))

        runs = {}
        for name, crash in (("clean", ()), ("crashy", (7, 13))):
            lc = LoopConfig(total_steps=20, ckpt_dir=f"{root}/{name}",
                            ckpt_every=5)
            runs[name] = run_with_restarts(make_args, lc,
                                           FaultInjector(crash))
        (mc, _sc, hc), (mx, _sx, hx) = runs["clean"], runs["crashy"]
        worst, bit_equal = 0.0, True
        for a, b in zip(mc.parameters(), mx.parameters()):
            a, b = a.detach(), b.detach()
            bit_equal &= torch.equal(a, b)
            if not torch.allclose(b, a, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
                raise AssertionError("14c: the restarted run left the clean "
                                     "trajectory")
            worst = max(worst, float((a - b).abs().max()))
        log(f"train 14c: restarts at steps 7 and 13 ({hx['restarts']} "
            f"restarts, resumed from step {hx['start_step']}): final "
            f"parameters within rtol {TRAIN_RTOL} / atol {TRAIN_ATOL} of the "
            f"clean run, max |diff| {worst:.3e}, bit-equal {bit_equal}")
        out["restart"] = {"max_abs_diff": worst, "bit_equal": bit_equal,
                          "restarts": hx["restarts"]}

        argv = ["--preset", "smoke", "--steps", "20", "--ckpt-every", "5",
                "--ckpt-dir", f"{root}/cli"]
        text = io.StringIO()
        try:
            with redirect_stdout(text):
                lm_train.run(argv + ["--crash-at", "12"])
        except RuntimeError as e:
            if "injected fault at step 12" not in str(e):
                raise
            log(f"train 14c: launch.train --crash-at 12 raised: {e}")
        else:
            raise AssertionError("14c: --crash-at 12 did not raise")
        text = io.StringIO()
        with redirect_stdout(text):
            _m, _s, hist = lm_train.run(argv)
        last = text.getvalue().splitlines()[-1]
        log(f"train 14c: the same command again: {last}")
        if hist["start_step"] != 10 or "resumed_from=10" not in last:
            raise AssertionError(f"14c: the rerun did not resume: {last}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


@contextlib.contextmanager
def card_world(torch):
    """An NCCL process group of one rank, this process on card 0, for the
    block's duration (a one-card ``DeviceMesh`` needs one; phase 15's fake
    group needs none to be left); destroyed on exit."""
    import shutil
    import tempfile

    import torch.distributed as dist

    (HERE / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="world_", dir=HERE / "build")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(pathlib.Path(tmp) / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def sharded_restore(torch, checkpoint, ckdir, model, state, live,
                    restore_s) -> float:
    """14a: the same checkpoint restored with ``shardings=`` onto a one-card
    ``DeviceMesh`` (every leaf ``Replicate()``), the parameters as a dict of
    the model's named parameters: every leaf a ``DTensor`` whose local
    tensor is bit-equal to the live one.  Returns its seconds."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    with card_world(torch):
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))
        like = (dict(model.named_parameters()), state)
        t0 = time.perf_counter()
        tree, got = checkpoint.restore(ckdir, like,
                                       shardings=(mesh, [Replicate()]))
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        fresh = list(checkpoint._leaves(tree))
        if got != TRAIN_STEPS or [k for k, _ in live] != [k for k, _ in fresh]:
            raise AssertionError(f"14a: sharded restore: step {got}")
        unequal = [k for (k, a), (_k, b) in zip(live, fresh)
                   if not isinstance(b, DTensor) or a.dtype != b.dtype
                   or not torch.equal(a, b.to_local())]
        if unequal:
            raise AssertionError(
                f"14a: sharded restore: leaves differ: {unequal[:5]}")
        del tree, fresh
    log(f"train 14a: restored {len(live)} leaves with shardings= onto a "
        f"one-card DeviceMesh (Replicate) in {sharded_s:.3f} s (plain "
        f"restore {restore_s:.3f} s), bit-equal")
    return sharded_s


def psum_rank(rank: int, world: int, store: str, out: str | None,
              device_type: str = "cuda", shapes=None):
    """14d: one rank of ``compressed_psum`` over an NCCL group of ``world``
    cards (rank i on card i), leaf by leaf over qwen2.5-3b's parameter
    shapes, on float32 gradients from ``torch.Generator`` seeded by rank and
    leaf, with zero residuals (a first step).  A world of one is held
    bit-equal to ``compress_decompress``; more ranks are held against a
    float32 ``all_reduce`` of the corrected gradients within the sum over
    participants of each block's max |value| / 254 (half a quantization
    step each), plus float32 rounding of both sums.  Also times a float32
    ``all_reduce`` of every leaf.  Returns rank 0's readings (and writes
    them to ``out`` as JSON when given); raises on a failed check.
    ``device_type="cpu"`` runs the same on a gloo group of CPU ranks and
    ``shapes`` replaces the parameter shapes: a rehearsal on a host without
    a card (``torch.multiprocessing.spawn(psum_rank, args=(4, store, out,
    "cpu", [(1000,), (7, 37)]), nprocs=4)``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.train import compression

    on_card = device_type == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
    dev = torch.device(device_type, rank if on_card else None)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("nccl" if on_card else "gloo",
                                store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
    try:
        mesh = DeviceMesh(device_type, list(range(world)),
                          mesh_dim_names=("pod",))
        if shapes is None:
            shapes = [tuple(p.shape) for _, p in Model(
                get_config(TRAIN_ARCH),
                torch.device("meta")).named_parameters()]
        eps = float(torch.finfo(torch.float32).eps)
        # the group's communicator is made at its first collective: not timed
        dist.all_reduce(torch.ones(1, device=dev))
        sync()
        psum_s = reduce_s = 0.0
        elems = payload = 0
        worst = 0.0
        with use_mesh(mesh):
            for i, shape in enumerate(shapes):
                g = torch.Generator(device=dev).manual_seed(
                    1000003 * rank + i)
                grad = torch.randn(shape, generator=g, device=dev)
                err = torch.zeros(shape, device=dev)
                sync()
                t0 = time.perf_counter()
                deq, new_err = compression.compressed_psum(grad, err, "pod")
                sync()
                psum_s += time.perf_counter() - t0
                full = grad + err
                t0 = time.perf_counter()
                dist.all_reduce(full)
                sync()
                reduce_s += time.perf_counter() - t0
                q, scale, n = compression.quantize_int8(grad + err)
                elems += n
                payload += q.numel() + 4 * scale.numel()
                if world == 1:
                    want, want_err = compression.compress_decompress(grad,
                                                                     err)
                    if not (torch.equal(deq, want)
                            and torch.equal(new_err, want_err)):
                        raise AssertionError(
                            f"14d: leaf {i} {shape}: compressed_psum on a "
                            f"world of one differs from compress_decompress")
                    continue
                scales = torch.empty((world * scale.shape[0], 1),
                                     device=dev)
                dist.all_gather_into_tensor(scales, scale)
                half = scales.reshape(world, -1, 1).sum(0) / 2
                mag = scales.reshape(world, -1, 1).sum(0) * 127
                bound = ((half + 4 * world * eps * mag).expand(-1, 256)
                         .reshape(-1)[:n].reshape(shape))
                over = (deq - full).abs() - bound
                if bool((over > 0).any()):
                    raise AssertionError(
                        f"14d: leaf {i} {shape}: |psum - all_reduce| over "
                        f"its bound by {float(over.max()):.3e}")
                worst = max(worst, float(((deq - full).abs()
                                          / bound.clamp_min(1e-30)).max()))
        out_d = {"world": world, "leaves": len(shapes), "elements": elems,
                 "psum_ms": psum_s * 1e3, "float32_all_reduce_ms":
                 reduce_s * 1e3, "payload_bytes": payload,
                 "float32_payload_bytes": 4 * elems,
                 "received_bytes_all_gather": (world - 1) * payload,
                 "received_bytes_ring_all_reduce":
                 2 * (world - 1) / world * 4 * elems,
                 "worst_share_of_bound": worst}
        if out is not None and rank == 0:
            pathlib.Path(out).write_text(json.dumps(out_d))
        return out_d
    finally:
        if own:
            dist.destroy_process_group()


def collective_phase(torch) -> dict:
    """14d: ``compressed_psum`` over an NCCL group of every visible card (a
    world of one, in this process, on one card; one spawned process per
    card otherwise), see ``psum_rank``."""
    import shutil
    import tempfile

    world = torch.cuda.device_count()
    (HERE / "build").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="psum_", dir=HERE / "build"))
    t0 = time.perf_counter()
    try:
        if world == 1:
            got = psum_rank(0, 1, str(tmp / "store"), None)
        else:
            import torch.multiprocessing as mp

            mp.spawn(psum_rank, args=(world, str(tmp / "store"),
                                      str(tmp / "rank0.json")),
                     nprocs=world, join=True)
            got = json.loads((tmp / "rank0.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got["phase_s"] = time.perf_counter() - t0
    held = ("bit-equal to compress_decompress" if world == 1 else
            f"within the quantization bound of a float32 all_reduce "
            f"(worst {got['worst_share_of_bound']:.4f} of it)")
    log(f"train 14d: compressed_psum over {world} card(s), {got['leaves']} "
        f"{TRAIN_ARCH} leaves, {got['elements']} float32 elements: "
        f"{got['psum_ms']:.3f} ms for the tree (float32 all_reduce "
        f"{got['float32_all_reduce_ms']:.3f} ms), {held}; payload per "
        f"participant {got['payload_bytes']} bytes int8 + scales against "
        f"{got['float32_payload_bytes']} float32 "
        f"({got['float32_payload_bytes'] / got['payload_bytes']:.3f}x); "
        f"bytes each rank receives: all-gather "
        f"{got['received_bytes_all_gather']}, ring all-reduce "
        f"{got['received_bytes_ring_all_reduce']:.0f}")
    if world == 1:
        log("train 14d: compressed_psum over more than one card not run: "
            "1 card visible")
    return got


def train_phase(torch, report) -> dict:
    """Phase 14: the LM training path (14a qwen2.5-3b at full width, 14b
    every architecture card vs CPU, 14c the reference test's setups)."""
    t_phase = time.perf_counter()
    out = {"full": train_full(torch, report)}
    t_b = time.perf_counter()
    dev = torch.device("cuda")
    out["archs"] = train_archs_card_vs_cpu(torch, dev)
    t_c = time.perf_counter()
    out["setups"] = train_reference_setups(torch, dev)
    t_d = time.perf_counter()
    out["collective"] = collective_phase(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"train: phase 14 took {out['phase_s']:.1f} s (14a "
        f"{t_b - t_phase:.1f} s, 14b {t_c - t_b:.1f} s, 14c "
        f"{t_d - t_c:.1f} s, 14d {time.perf_counter() - t_d:.1f} s)")
    report["train"] = out
    return out


# --- phase 15: the LM dry-run, feeding job demands to the rightsizer ---------

# python -m repro_torch.launch.dryrun, one subprocess per (arch, shape, mesh):
# qwen2.5-3b's six cells, and on 16x16 (the mesh fleet_problem reads) the
# other DEFAULT_SCHEDULE cells that the --all run on the card passed
# (PERF.md §6; rwkv6-7b train_4k ran out of time there); the longest
# first
DRYRUN_CELLS = [("granite-34b", "prefill_32k", "pod"),
                ("qwen2.5-3b", "prefill_32k", "pod"),
                ("qwen2.5-3b", "prefill_32k", "multipod"),
                ("whisper-small", "prefill_32k", "pod"),
                ("gemma2-9b", "train_4k", "pod"),
                ("olmoe-1b-7b", "train_4k", "pod"),
                ("qwen2.5-3b", "train_4k", "pod"),
                ("qwen2.5-3b", "train_4k", "multipod"),
                ("qwen2.5-3b", "decode_32k", "pod"),
                ("qwen2.5-3b", "decode_32k", "multipod"),
                ("gemma3-1b", "decode_32k", "pod"),
                ("qwen2-vl-2b", "decode_32k", "pod"),
                ("kimi-k2-1t-a32b", "decode_32k", "pod"),
                ("recurrentgemma-9b", "long_500k", "pod"),
                ("rwkv6-7b", "train_4k", "pod")]
DRYRUN_TIMEOUT = 900             # seconds for one cell's subprocess
DRYRUN_WIDTH = 6                 # cells at once, beside the main process
FOOT_LO, FOOT_HI = 0.9, 2.0      # 15b: counted footprint / measured peak


class DryrunCells:
    """15a: every cell of ``DRYRUN_CELLS`` through the dry-run's CLI, each
    in its own process (one fake process group each), ``DRYRUN_WIDTH`` at
    once, on a thread started right after the build: the cells are host
    work and run beside phases 3-12, which leave the host's other cores
    idle (``pause`` holds them during phases 13-14).  ``join`` waits for
    them and checks the records; ``kill`` stops whatever still runs."""

    def __init__(self, out_dir: pathlib.Path):
        import shutil
        import threading

        self.out_dir = out_dir
        shutil.rmtree(out_dir, ignore_errors=True)
        (out_dir / "logs").mkdir(parents=True)
        self.running, self.done, self.failed = [], {}, None
        self.stopped = self.paused = False
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        import os

        env = dict(os.environ, PYTHONPATH=str(HERE / "src"),
                   OMP_NUM_THREADS="1")
        todo = list(DRYRUN_CELLS)
        while (todo or self.running) and not self.stopped:
            while todo and len(self.running) < DRYRUN_WIDTH \
                    and self.failed is None and not self.paused:
                arch, shape, mesh = todo.pop(0)
                log_path = self.out_dir / "logs" / f"{arch}__{shape}__{mesh}.log"
                f = open(log_path, "w")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--out", str(self.out_dir)], stdout=f,
                    stderr=subprocess.STDOUT, env=env, cwd=HERE)
                self.running.append(((arch, shape, mesh), proc, f, log_path,
                                     time.perf_counter()))
            if self.failed is not None:
                todo = []
            time.sleep(0.5)
            for item in list(self.running):
                cell, proc, f, log_path, start = item
                if proc.poll() is None and (self.paused or time.perf_counter()
                                            - start < DRYRUN_TIMEOUT):
                    continue
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                f.close()
                self.running.remove(item)
                text = log_path.read_text()
                lines = [r for r in text.splitlines()
                         if r.startswith(("OK", "FAIL", "SKIP"))]
                self.done[cell] = {"rc": proc.returncode, "lines": lines,
                                   "wall_s": time.perf_counter() - start,
                                   "tail": text.splitlines()[-30:]}
                if proc.returncode != 0 or not lines or \
                        not all(r.startswith("OK") for r in lines):
                    self.failed = self.failed or cell
        self.wall = time.perf_counter() - self.t0

    def pause(self):
        """Stop the running cells' processes (SIGSTOP) and start no more
        until ``resume``: phases 13, 14 and 16's host-bound readings (a
        decode step's launches) are taken on a host of their own."""
        import signal

        self.paused = True
        for _cell, proc, _f, _path, _start in list(self.running):
            if proc.poll() is None:
                proc.send_signal(signal.SIGSTOP)
        log(f"dryrun 15a: paused {len(self.running)} running cells, "
            f"{len(self.done)} done")

    def resume(self):
        import signal

        for _cell, proc, _f, _path, _start in list(self.running):
            if proc.poll() is None:
                proc.send_signal(signal.SIGCONT)
        self.paused = False
        log(f"dryrun 15a: resumed {len(self.running)} cells")

    def kill(self):
        self.stopped = True
        for _cell, proc, f, _path, _start in list(self.running):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
        self.thread.join(timeout=60)

    def join(self) -> dict:
        t0 = time.perf_counter()
        self.thread.join()
        log(f"dryrun 15a: waited {time.perf_counter() - t0:.1f} s for the "
            f"cells started {t0 - self.t0:.1f} s before")
        for cell, res in self.done.items():
            for row in res["lines"]:
                log(f"dryrun 15a: {row} (process {res['wall_s']:.1f} s)")
        if self.failed is not None:
            for row in self.done[self.failed]["tail"]:
                log(f"dryrun 15a: | {row}")
            raise AssertionError(f"15a: the dry-run of {self.failed} failed "
                                 f"(exit {self.done[self.failed]['rc']})")
        records = {}
        for path in sorted(self.out_dir.glob("*.json")):
            rec = json.loads(path.read_text())
            records[path.stem] = rec
            sizes = [rec[k] for k in ("argument_size_in_bytes",
                                      "temp_size_in_bytes",
                                      "output_size_in_bytes")]
            if not (rec["devices"] == (256 if path.stem.endswith("__16x16")
                                       else 512)
                    and all(math.isfinite(v) and v > 0
                            for v in sizes + [rec["flops"]])):
                raise AssertionError(f"15a: record {path.stem}: {rec}")
            coll = ", ".join(f"{k} {v:.4g}" for k, v in
                             rec["collective_bytes"].items())
            log(f"dryrun 15a: {path.stem}: per device argument "
                f"{rec['argument_size_in_bytes'] / 1e9:.4f} GB, temp "
                f"{rec['temp_size_in_bytes'] / 1e9:.4f} GB, output "
                f"{rec['output_size_in_bytes'] / 1e9:.4f} GB; flops "
                f"{rec['flops']:.4g}; collective bytes {coll} "
                f"({rec['collective_count']} collectives); trace "
                f"{rec['lower_s']} s")
        want = {f"{a}__{s}__{'16x16' if m == 'pod' else '2x16x16'}"
                for a, s, m in DRYRUN_CELLS}
        if set(records) != want:
            raise AssertionError(f"15a: records {sorted(records)} != "
                                 f"{sorted(want)}")
        log(f"dryrun 15a: {len(records)} records in {self.wall:.1f} s "
            f"({DRYRUN_WIDTH} at once)")
        return {"records": records, "wall_s": self.wall,
                "cells": {"__".join(k): {key: v for key, v in res.items()
                                         if key != "tail"}
                          for k, res in self.done.items()}}


def dryrun_against_card(torch) -> dict:
    """15b: the dry-run's accounting of phase 14's training step on the 1x1
    host mesh over the card, against the same step run on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_step
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   init_train_state, make_batch,
                                   make_train_step)

    cfg = get_config(TRAIN_ARCH)
    tc = TrainConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=20),
                     remat=True, loss_chunk=min(256, TRAIN_SEQ))
    with fake_world(1):
        acc = run_step(cfg, "train", TRAIN_SEQ, TRAIN_BATCH, make_host_mesh(),
                       train_cfg=tc)
    est = (acc["argument_size_in_bytes"] + acc["temp_size_in_bytes"]
           + acc["output_size_in_bytes"])
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    model = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    state = init_train_state(model, tc)
    step = make_train_step(model, tc)
    _state, metrics = step(state, make_batch(
        cfg, DataConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ), 0))
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del model, state, step, _state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    bound = train_bounds_of(cfg, TRAIN_BATCH, TRAIN_SEQ)
    ratio = est / peak
    log(f"dryrun 15b: {cfg.name} B={TRAIN_BATCH} S={TRAIN_SEQ} on the 1x1 "
        f"host mesh: argument {acc['argument_size_in_bytes'] / 1e9:.4f} GB + "
        f"temp {acc['temp_size_in_bytes'] / 1e9:.4f} GB + output "
        f"{acc['output_size_in_bytes'] / 1e9:.4f} GB = {est / 1e9:.4f} GB "
        f"counted (trace {acc['lower_s']} s); one step on the card: peak "
        f"{peak / 1e9:.4f} GB (torch.cuda.max_memory_allocated less the "
        f"{base / 1e9:.3f} GB held before), loss {loss:.4f}; counted / "
        f"measured {ratio:.4f} (must lie in [{FOOT_LO}, {FOOT_HI}])")
    log(f"dryrun 15b: counted flops {acc['flops']:.6g} beside phase 14's "
        f"train_bounds {bound:.6g} ({acc['flops'] / bound:.4f}x); "
        f"{acc['collective_count']} collectives on the 1x1 mesh")
    if not FOOT_LO <= ratio <= FOOT_HI:
        raise AssertionError(f"15b: counted footprint {est} vs measured peak "
                             f"{peak}: ratio {ratio}")
    if acc["collective_count"]:
        raise AssertionError("15b: the 1x1 mesh issued collectives")
    return {"counted": {k: acc[k] for k in (
        "argument_size_in_bytes", "temp_size_in_bytes",
        "output_size_in_bytes", "flops", "lower_s")},
        "counted_bytes": est, "peak_bytes": peak, "ratio": ratio,
        "train_bounds_flops": bound, "loss": loss}


def train_bounds_of(cfg, B: int, S: int) -> float:
    """``train_bounds``' matmul operations of one step, from the config
    (its parameter count, on the meta device)."""
    from repro_torch.models import Model

    return train_bounds(Model(cfg, device="meta"), cfg, B, S)["step_flops"]


def dryrun_fleet(torch, np, kernels, cong, records_dir) -> dict:
    """15c: the schedule's problem from the records, evaluated in the
    card configuration (tol, pallas, compiled stepper), checked by the
    oracle and against the numpy lockstep engine."""
    from repro_torch.core import (ALGORITHMS, FleetEngine, PlacementConfig,
                                  SolverConfig, check_plan, rightsize)
    from repro_torch.kernels import place_step as kstep
    from repro_torch.workload import DEFAULT_SCHEDULE, fleet_problem

    problem, tasks = fleet_problem(DEFAULT_SCHEDULE,
                                   dryrun_dir=str(records_dir))
    sources = collections.Counter(t["source"] for t in tasks)
    by_job = {t["name"].split("/")[0]: t["source"] for t in tasks}
    log(f"dryrun 15c: {len(tasks)} tasks, {dict(sources)}; demands "
        + "; ".join(f"{t['name']} {t['dem'].tolist()}" for t in tasks))
    for job in DEFAULT_SCHEDULE:
        log(f"dryrun 15c: job {job.name} ({job.arch} {job.shape}): demand "
            f"from {by_job.get(job.name)}")
    builtin = sorted(n for n, s in by_job.items() if s != "dryrun")
    if builtin or len(by_job) != len(DEFAULT_SCHEDULE):
        raise AssertionError(f"15c: jobs {builtin} did not come from a "
                             f"record")
    engine = FleetEngine(solver=SolverConfig(tol=TOL, iters=4000,
                                             operator="pallas"),
                         placement=PlacementConfig(engine="compiled"))
    res, wall, launches, _last = tol_evaluate(torch, kernels, cong, engine,
                                              [problem])
    check_tol_launches(res, launches, "dryrun fleet")
    entry = res.entries[0]
    log(f"dryrun 15c: evaluate {wall:.3f} s: congestion_lp launches "
        f"{launches['congestion_many']}, place_step launches "
        f"{launches['place_step']}; lb {entry['lb']:.6f}, costs "
        + " ".join(f"{a}={c:.6f}" for a, c in entry["costs"].items()))
    prot = protocol_against_numpy(torch, np, kernels, kstep, res,
                                  "dryrun fleet")
    violations = []
    for algo in ALGORITHMS:
        sol = rightsize(problem, algo, check=False,
                        lp_result=res.lp_results[0])
        violations += [f"{algo}: {v}" for v in check_plan(problem, sol)]
    log(f"dryrun 15c: {prot['calls']} protocol calls, compiled and numpy "
        f"lockstep placements equal, costs equal the evaluate's; check_plan "
        f"on {len(ALGORITHMS)} plans: {len(violations)} violations")
    if violations:
        raise AssertionError("15c: " + "; ".join(violations[:10]))
    return {"tasks": len(tasks), "sources": dict(sources), "launches": launches,
            "wall_s": wall, "entry": entry, "violations": 0}


def dryrun_phase(torch, np, kernels, cong, report, cells) -> dict:
    """Phase 15: the dry-run's records (15a, from ``cells``, started after
    the build), its estimate against the card (15b), the rightsizing from
    the records (15c)."""
    t_phase = time.perf_counter()
    out = {"records": cells.join()}
    t_b = time.perf_counter()
    out["estimate"] = dryrun_against_card(torch)
    t_c = time.perf_counter()
    out["fleet"] = dryrun_fleet(torch, np, kernels, cong, cells.out_dir)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"dryrun: phase 15 took {out['phase_s']:.1f} s (15a "
        f"{t_b - t_phase:.1f} s, 15b {t_c - t_b:.1f} s, 15c "
        f"{time.perf_counter() - t_c:.1f} s)")
    report["dryrun"] = out
    return out


# --- phase 16: the recurrent families ----------------------------------------

REC_ARCHS = ("rwkv6-7b", "recurrentgemma-9b")
REC_KERNEL = {"rwkv6-7b": "wkv", "recurrentgemma-9b": "linear_scan"}
REC_MIXER = {"rwkv6-7b": "rwkv", "recurrentgemma-9b": "rglru"}
# 16c: the depth cuts (num_layers only); float32 AdamW state of all 32 or 38
# layers does not fit one card
REC_TRAIN_LAYERS = {"rwkv6-7b": 8, "recurrentgemma-9b": 6}
REC_TRAIN_STEPS = {"rwkv6-7b": 10, "recurrentgemma-9b": 3}
REC_FWD_SEQ = LM_PROMPT          # 16a's prefill: the forwards' checks
REC_BWD_SEQ = TRAIN_SEQ          # 16c's step: the backwards' checks
WKV_SHAPE = (4, 64, 64)          # B, H, N of rwkv6-7b's layer at batch 4
SCAN_SHAPE = (4, 4096)           # B, W of recurrentgemma-9b's layer
# (B, S, W) the scan pair is also held bit-equal at: W not a multiple of 4
# or 32, S not a multiple of a time tile, B * W below one block
SCAN_RAGGED = ((1, 1, 1), (2, 7, 300), (1, 65, 33), (3, 300, 4098),
               (4, 4100, 4096))
# float32 outputs against the plain loop: sums in another order and fused
# multiply-adds, relative to the output's max |value| (13c/14b's bound);
# bfloat16 outputs: the same, plus two bfloat16 roundings of the value
REC_F32_RTOL = 1e-4
REC_BF16_RTOL = 2.0 ** -7


def close_rel(a, b, rtol: float, what: str) -> tuple[float, float]:
    """Hold ``a`` against the plain ``b``: |a - b| <= rtol |b| + REC_F32_RTOL
    max |b| elementwise; returns max |a - b| and that over max |b|."""
    a64, b64 = a.double(), b.double()
    top = max(float(b64.abs().max()), 1e-300)
    diff = (a64 - b64).abs()
    bad = int((diff > rtol * b64.abs() + REC_F32_RTOL * top).sum())
    err = float(diff.max())
    if bad or not bool(a64.isfinite().all()):
        raise AssertionError(f"{what}: {bad} elements off (max |diff| "
                             f"{err:.3e}, {err / top:.3e} of max |value|)")
    return err, err / top


def wkv_inputs(torch, dev, B, S, H, N, dtype, seed: int, zeros=0.01):
    """r, k, v (dtype), the log-decays lw, u (float32) and the gradients gy,
    gs from a seeded generator: lw = -exp(x) with x ~ N(-3, 1.5); a share
    ``zeros`` of the decays exactly 0, at lw = -exp(5) (w = exp(lw)
    underflows) and, past a share of 1%, half of them at lw = -inf."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    r, k, v = (randn(B, S, H, N, scale=0.5).to(dtype) for _ in range(3))
    x = randn(B, S, H, N, scale=1.5) - 3.0
    pick = torch.rand(x.shape, generator=g, device=dev)
    x = torch.where(pick < zeros, torch.full_like(x, 5.0), x)
    lw = -torch.exp(x)
    if zeros > 0.01:
        lw = torch.where(pick < zeros / 2, torch.full_like(lw, -math.inf), lw)
    u = randn(H, N, scale=0.5)
    gy = randn(B, S, H, N)
    gs = randn(B, H, N, N, scale=0.1)
    return (r, k, v, lw, u), gy, gs


def wkv_chunked_ops(B, S, H, N, backward: bool) -> float:
    """The chunked form's own operations (a multiply-add 2), counted from
    the kernels' loops (not measured), before the 3-pass TF32 split: per chunk of L = 64 steps the
    products (state increments, A's blocks against earlier sub-chunks (16 x
    16a, a = 1..3) and its halves (four 8 x 8), y = A v and (r 2^C) S_in;
    backward dA, A again, gv, gr and gk's products against A, dA, S_in and
    dS_out), the elementwise pairs (224, 3 operations a channel; the
    backward's 480 more at 4) and the bonus (64 at 3), and the chunk
    recurrences (2 N^2 a chunk, each direction)."""
    L = 64
    nc = -(-S // L)
    a_blocks = 2 * N * (16 * 16 * (1 + 2 + 3) + 4 * 8 * 8)
    elem = 3 * N * (224 + 64)
    if not backward:
        per = 2 * (2 * L * N * N) + a_blocks + elem + 2 * 16 * 16 * 10 * N \
            + 2 * N * N
    else:
        per = (2 * (2 * L * N * N) + 2 * (2 * N * N)      # chunk_state, scan
               + 2 * N * 16 * (32 + 32 + 64 + 64)         # dA
               + a_blocks + elem                          # A again
               + 2 * N * 16 * (64 + 48 + 32 + 16)         # A^T gy
               + 2 * N * 16 * 16 * (1 + 2 + 3) * 2        # dA k, dA^T r
               + 3 * (2 * L * N * N)                      # S_in, dS_out
               + 4 * N * 4 * 120 + 6 * L * N)             # pairs, glw
    return float(B * H * nc * per)


def checked_scan_plan(torch, kscan, B, S, W, backward) -> dict:
    """The launch plan the built scan kernel picks, held to the plan rule's
    transcription (``tests/_torch_scan_tiles.py``) on this card's SMs."""
    if str(HERE / "tests") not in sys.path:
        sys.path.append(str(HERE / "tests"))
    from _torch_scan_tiles import plan as scan_plan

    plan = kscan.launch_plan(B, W, backward=backward)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = scan_plan(B, W, backward, sms)
    if {k: plan[k] for k in want} != want or plan["resident"] < 1:
        raise AssertionError(f"scan launch plan at B={B} S={S} W={W} "
                             f"backward={backward}: {plan}, the rule gives "
                             f"{want}")
    return plan


def recurrent_kernel_checks(torch, dev) -> dict:
    """The recurrence kernels against their plain versions on the card, at
    the shapes phase 16's path gives them: the forwards at 16a's prefill
    (S = REC_FWD_SEQ), the backwards at 16c's step (S = REC_BWD_SEQ), at
    full-width layer shapes. ``wkv`` in float32 (16b) and bfloat16 (16a,
    16c) within REC_F32_RTOL / REC_BF16_RTOL, the linear scan bit-equal (both
    round the multiply and the add apart); then each timed in bfloat16 or
    float32 as the model runs it (kernel, plain version, bound)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import scan as kscan
    from repro_torch.kernels import wkv as kwkv

    B, H, N = WKV_SHAPE
    Sf, Sb = REC_FWD_SEQ, REC_BWD_SEQ
    errs = {name: [0.0, 0.0] for name in ("wkv", "wkv_backward")}

    def hold(name, a, b, rtol, what):
        got = close_rel(a, b, rtol, what)
        errs[name] = [max(x, y) for x, y in zip(errs[name], got)]
        return got[1]

    def check(dtype, Sf, Sb, zeros, seed):
        ins, _, _ = wkv_inputs(torch, dev, B, Sf, H, N, dtype, seed, zeros)
        n0 = int((torch.exp(ins[3]) == 0).sum())
        y, st = kwkv.wkv_forward(*ins)
        y0, st0 = ref.wkv_ref(*ins)
        torch.cuda.synchronize()
        e = max(hold("wkv", y, y0, 0.0, f"wkv y {dtype} S={Sf}"),
                hold("wkv", st, st0, 0.0, f"wkv state {dtype} S={Sf}"))
        del ins, y, st, y0, st0
        ins, gy, gs = wkv_inputs(torch, dev, B, Sb, H, N, dtype, seed, zeros)
        grads = kwkv.wkv_backward_launch(*ins, gy, gs)
        plain = ref.wkv_backward_ref(*ins, gy, gs)
        eb = 0.0
        for name, a, b in zip(("gr", "gk", "gv", "glw", "gu"), grads, plain):
            rtol = REC_BF16_RTOL if a.dtype == torch.bfloat16 else 0.0
            eb = max(eb, hold("wkv_backward", a, b, rtol,
                              f"wkv {name} {dtype} S={Sb}"))
        log(f"recurrent: wkv {dtype} B={B} H={H} N={N}, {zeros:.0%} of the "
            f"decays exactly 0: forward at S={Sf} ({n0} zeros) max rel "
            f"{e:.3e}, backward at S={Sb} max rel {eb:.3e} against the plain "
            f"loops")
        del ins, gy, gs, grads, plain

    # the path's lengths, then ragged ones around the chunk (L = 64), then
    # a tenth of the decays exactly 0
    for dtype in (torch.float32, torch.bfloat16):
        check(dtype, Sf, Sb, 0.01, seed=3)
    for S in (1, 63, 65):
        for dtype in (torch.float32, torch.bfloat16):
            check(dtype, S, S, 0.01, seed=10 + S)
    for dtype in (torch.float32, torch.bfloat16):
        check(dtype, 300, 300, 0.1, seed=7)
    # the backward's scratch at 16c's length: the call's peak over what was
    # held, less its outputs
    ins, gy, gs = wkv_inputs(torch, dev, B, Sb, H, N, torch.bfloat16, 4)
    torch.cuda.synchronize()
    gc.collect()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = kwkv.wkv_backward_launch(*ins, gy, gs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    outs = sum(t.numel() * t.element_size() for t in grads)
    scratch = {"peak_over_held_bytes": peak, "outputs_bytes": outs,
               "scratch_bytes": peak - outs}
    log(f"recurrent: wkv_backward B={B} S={Sb} H={H} N={N} bf16: peak "
        f"{peak} bytes over what was held, outputs {outs}, scratch "
        f"{peak - outs} bytes (torch.cuda.max_memory_allocated)")
    del ins, gy, gs, grads
    # timing in the model's bfloat16
    elt = 2
    out, chunked = {}, {}
    for name, S, seed in (("wkv", Sf, 4), ("wkv_backward", Sb, 4)):
        ins, gy, gs = wkv_inputs(torch, dev, B, S, H, N, torch.bfloat16,
                                 seed)
        if name == "wkv":
            fn, plain = (lambda: kwkv.wkv_forward(*ins),
                         lambda: ref.wkv_ref(*ins))
            nbytes = (B * S * H * N * (3 * elt + 4 + 4) + H * N * 4
                      + B * H * N * N * 4)
            ops = 5.0 * B * S * H * N * N
        else:
            fn, plain = (lambda: kwkv.wkv_backward_launch(*ins, gy, gs),
                         lambda: ref.wkv_backward_ref(*ins, gy, gs))
            nbytes = (B * S * H * N * (6 * elt + 12) + 2 * B * H * N * N * 4
                      + 2 * H * N * 4)
            ops = 11.0 * B * S * H * N * N
        # the kernels run every product on the tensor cores in TF32 with a
        # 3-pass split; the float32-rate bound of the earlier serial
        # kernels, which ran them on the CUDA cores, stays beside it
        b_ms, b_by = bound(nbytes, ops, PEAK_TF32_FLOPS / TF32_PASSES)
        out[name] = {
            "shape": {"B": B, "S": S, "H": H, "N": N, "dtype": "bfloat16"},
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": device_ms(torch, fn, reps=20, warmup=3),
            "plain_ms": device_ms(torch, plain, reps=2, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "bound_ms_f32_rate": bound(nbytes, ops)[0],
            "call_ms": cuda_ms(torch, fn, reps=20, warmup=2)}
        chunked[name] = wkv_chunked_ops(B, S, H, N, name != "wkv")
        if name == "wkv_backward":
            out[name].update(scratch)
        del ins, gy, gs, fn, plain
    # the linear scan (float32 gates): bit-equal to the plain loops at the
    # ragged shapes, then at the path's (timed below); each launch plan
    # printed and held to the plan rule's transcription
    for B_, S_, W_ in SCAN_RAGGED:
        g = torch.Generator(device=dev).manual_seed(S_ + W_)
        a = torch.rand((B_, S_, W_), generator=g, device=dev)
        b = torch.randn((B_, S_, W_), generator=g, device=dev)
        gh = torch.randn((B_, S_, W_), generator=g, device=dev)
        h = kscan.scan_forward(a, b)
        hp = ref.linear_scan_ref(a, b)
        ga, gb = kscan.scan_backward(a, hp, gh)
        pa, pb = ref.linear_scan_backward_ref(a, hp, gh)
        if not (torch.equal(h, hp) and torch.equal(ga, pa)
                and torch.equal(gb, pb)):
            raise AssertionError(f"linear scan at B={B_} S={S_} W={W_}: "
                                 f"kernel and plain loop differ")
        log(f"recurrent: linear_scan and linear_scan_backward B={B_} S={S_} "
            f"W={W_}: bit-equal to the plain loops; plans "
            f"{checked_scan_plan(torch, kscan, B_, S_, W_, False)}, "
            f"{checked_scan_plan(torch, kscan, B_, S_, W_, True)}")
        del a, b, gh, h, hp, ga, gb, pa, pb
    Bs, W = SCAN_SHAPE
    g = torch.Generator(device=dev).manual_seed(5)
    for name, S in (("linear_scan", Sf), ("linear_scan_backward", Sb)):
        backward = name == "linear_scan_backward"
        plan = checked_scan_plan(torch, kscan, Bs, S, W, backward)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        if plan["blocks"] > plan["resident"] * sms:
            raise AssertionError(f"{name}: {plan['blocks']} blocks do not fit "
                                 f"{sms} SMs in one wave: {plan}")
        a = torch.rand((Bs, S, W), generator=g, device=dev)
        b = torch.randn((Bs, S, W), generator=g, device=dev)
        h = kscan.scan_forward(a, b)
        n = Bs * S * W
        if not backward:
            if not torch.equal(h, ref.linear_scan_ref(a, b)):
                raise AssertionError("linear scan: kernel and plain loop "
                                     "differ")
            fn, plain = (lambda: kscan.scan_forward(a, b),
                         lambda: ref.linear_scan_ref(a, b))
            nbytes, ops = 3 * n * 4, 2.0 * n
        else:
            gh = torch.randn((Bs, S, W), generator=g, device=dev)
            ga, gb = kscan.scan_backward(a, h, gh)
            pa, pb = ref.linear_scan_backward_ref(a, h, gh)
            if not (torch.equal(ga, pa) and torch.equal(gb, pb)):
                raise AssertionError("linear scan backward: kernel and "
                                     "plain loop differ")
            del ga, gb, pa, pb
            fn, plain = (lambda: kscan.scan_backward(a, h, gh),
                         lambda: ref.linear_scan_backward_ref(a, h, gh))
            nbytes, ops = 5 * n * 4, 3.0 * n
        log(f"recurrent: {name} B={Bs} S={S} W={W}: bit-equal to the plain "
            f"loop")
        b_ms, b_by = bound(nbytes, ops)
        out[name] = {
            "shape": {"B": Bs, "S": S, "W": W, "dtype": "float32"},
            "max_abs_err": 0.0, "max_rel_err": 0.0,
            "ms": device_ms(torch, fn, reps=20, warmup=3),
            "plain_ms": device_ms(torch, plain, reps=2, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "call_ms": cuda_ms(torch, fn, reps=20, warmup=2), "plan": plan}
        del a, b, h, fn, plain
    for name, info in out.items():
        log(timing_line(name, info))
        log(f"timing: {name} shape {info['shape']} max_rel_err "
            f"{info['max_rel_err']:.3g}" + (
                f" bound_ms_f32_rate {info['bound_ms_f32_rate']:.6f} "
                f"(float32 rate); chunked form's operations "
                f"{chunked[name]:.6e}, counted from the kernels' loops (the "
                f"bound counts {'5' if name == 'wkv' else '11'} B S H N^2), "
                f"{-(-info['shape']['S'] // 64)} serial chunks"
                if name in chunked else "")
            + (f" scratch_bytes {info['scratch_bytes']}"
               if "scratch_bytes" in info else ""))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rec_mixers(cfg, arch) -> int:
    """The layers of ``cfg`` that run ``arch``'s recurrence (one kernel
    launch each a call)."""
    return sum(1 for kind, *_ in cfg.pattern if kind == REC_MIXER[arch])


def rec_serve(torch, dev) -> dict:
    """16a: rwkv6-7b, then recurrentgemma-9b, at full width in bf16 through
    ``launch.serve``'s ``make_batch``/``generate`` (B = 4, a 4100-token
    prompt, 16 greedy tokens; cold, then warm), launch counts set to 0 just
    before the cold call and read just after."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import init_params

    out = {}
    for arch in REC_ARCHS:
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        model = init_params(gen, cfg, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        batch = lm_serve.make_batch(cfg, LM_BATCH, LM_PROMPT, gen)
        mixers = rec_mixers(cfg, arch)
        runs = []
        for call in ("cold", "warm"):
            kernels.reset_launch_counts()
            ids, info = lm_serve.generate(model, batch, LM_GEN)
            counts = kernels.launch_counts()
            if not info["finite"]:
                raise AssertionError(f"16a {arch} {call}: non-finite logits")
            if tuple(ids.shape) != (LM_BATCH, LM_GEN) or not bool(
                    ((ids >= 0) & (ids < cfg.vocab_size)).all()):
                raise AssertionError(f"16a {arch} {call}: ids out of range")
            if counts[REC_KERNEL[arch]] != mixers:
                raise AssertionError(
                    f"16a {arch}: {counts[REC_KERNEL[arch]]} launches of "
                    f"{REC_KERNEL[arch]} for {mixers} {REC_MIXER[arch]} "
                    f"layers")
            run = {"call": call, "prefill_s": info["prefill_s"],
                   "decode_s": info["decode_s"], "steps": info["steps"],
                   "prefill_tok_s": LM_BATCH * LM_PROMPT / info["prefill_s"],
                   "decode_ms_step": info["decode_s"] / info["steps"] * 1e3,
                   "launches": {k: v for k, v in counts.items() if v},
                   "ids_row0": ids[0].tolist()}
            runs.append(run)
            log(f"rec 16a {arch} {call}: prefill batch={LM_BATCH} "
                f"len={LM_PROMPT} {run['prefill_s']:.3f} s "
                f"({run['prefill_tok_s']:.1f} tok/s); decode {run['steps']} "
                f"steps {run['decode_s']:.3f} s ({run['decode_ms_step']:.3f} "
                f"ms/step); launches {run['launches']}; ids (row 0) "
                f"{run['ids_row0']}")
        if runs[0]["ids_row0"] != runs[1]["ids_row0"]:
            raise AssertionError(f"16a {arch}: two greedy calls differ")
        peak = torch.cuda.max_memory_allocated()
        log(f"rec 16a {arch}: {n_params} bf16 parameters initialized in "
            f"{init_s:.2f} s; peak memory {peak / 1e9:.3f} GB "
            f"(torch.cuda.max_memory_allocated; {base / 1e9:.3f} GB held "
            f"before)")
        out[arch] = {"params": n_params, "init_s": init_s,
                     "peak_bytes": peak, "base_bytes": base, "runs": runs,
                     "launches": runs[0]["launches"]}
        del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rec_consistency_f32(torch, dev) -> dict:
    """16b: both models in float32 at B = 1: prefill 4100 tokens, then 8
    greedy decode steps (the O(1) step path), each at LM_PARITY_AT held
    within 5e-3 of a fresh prefill (the kernels) of the same tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    out = {}
    for arch in REC_ARCHS:
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(1)
        model = init_params(gen, cfg, dev)
        seq = torch.randint(0, cfg.vocab_size, (1, LM_PROMPT), generator=gen,
                            device=dev)
        steps = max(LM_PARITY_AT) + 1
        logits, state = prefill(model, {"tokens": seq},
                                max_len=LM_PROMPT + steps)
        tok = torch.argmax(logits, dim=-1)
        errs = {}
        for j in range(steps):
            logits, state = decode_step(model, state, tok)
            seq = torch.cat([seq, tok[:, None]], dim=1)
            if j in LM_PARITY_AT:
                fresh, _ = prefill(model, {"tokens": seq},
                                   max_len=seq.shape[1])
                errs[j] = float((logits - fresh).abs().max())
                log(f"rec 16b {arch}: decode step {j} (position "
                    f"{LM_PROMPT + j}) against a fresh prefill of "
                    f"{seq.shape[1]} tokens: max |diff| {errs[j]:.3e}")
                if not errs[j] <= LM_PARITY_ATOL:
                    raise AssertionError(f"16b {arch}: decode step {j} "
                                         f"differs by {errs[j]}")
                del fresh
            tok = torch.argmax(logits, dim=-1)
        out[arch] = errs
        del model, state, logits
        gc.collect()
        torch.cuda.empty_cache()
    return {"max_abs_err": out, "atol": LM_PARITY_ATOL}


def rec_train(torch, dev) -> dict:
    """16c: rwkv6-7b cut to 8 layers, then recurrentgemma-9b cut to 6 (for
    the scan's backward), at full width through ``launch.train.run`` (B = 4,
    S = 2048, remat; its one checkpoint at the last step): finite, falling
    losses, the backward kernels launched once a recurrent layer a step."""
    import io
    import shutil
    import statistics
    import tempfile
    from contextlib import redirect_stdout

    from repro_torch import kernels
    from repro_torch.launch import train as lm_train

    out = {}
    (HERE / "build").mkdir(exist_ok=True)
    for arch in REC_ARCHS:
        layers, steps = REC_TRAIN_LAYERS[arch], REC_TRAIN_STEPS[arch]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ckdir = tempfile.mkdtemp(prefix="train16c_", dir=HERE / "build")
        try:
            argv = ["--arch", arch, "--preset", "full", "--layers",
                    str(layers), "--batch", str(TRAIN_BATCH), "--seq",
                    str(TRAIN_SEQ), "--steps", str(steps), "--ckpt-every",
                    str(steps), "--ckpt-dir", ckdir, "--device", str(dev)]
            buf = io.StringIO()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with redirect_stdout(buf):
                model, state, hist = lm_train.run(argv)
            run_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        for row in buf.getvalue().splitlines():
            log(f"rec 16c: | {row}")
        losses, walls = hist["loss"], hist["wall_s"]
        peak = torch.cuda.max_memory_allocated()
        fwd, bwd = REC_KERNEL[arch], REC_KERNEL[arch] + "_backward"
        log(f"rec 16c {arch} ({model.cfg.num_layers} layers, B={TRAIN_BATCH} "
            f"S={TRAIN_SEQ}): losses {[round(x, 6) for x in losses]}; step s "
            f"{[round(x, 3) for x in walls]} (warm median "
            f"{statistics.median(walls[1:]):.3f}); peak memory "
            f"{peak / 1e9:.3f} GB; launches {fwd} {counts[fwd]}, {bwd} "
            f"{counts[bwd]}; run {run_s:.1f} s")
        if not all(math.isfinite(x) for x in losses) or not (
                losses[-1] < losses[0]):
            raise AssertionError(f"16c {arch}: losses {losses}")
        if (counts[bwd] != rec_mixers(model.cfg, arch) * len(losses)
                or counts[fwd] <= 0):
            raise AssertionError(f"16c {arch}: launches {counts}")
        out[arch] = {"layers": model.cfg.num_layers, "losses": losses,
                     "step_s": walls, "peak_bytes": peak, "run_s": run_s,
                     "launches": {k: v for k, v in counts.items() if v}}
        del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recurrent_phase(torch, report, dev) -> dict:
    """Phase 16: the recurrent families (16a serving, 16b f32 prefill and
    decode consistency, 16c training; each kernel against its plain
    version)."""
    t_phase = time.perf_counter()
    out = {"kernels": recurrent_kernel_checks(torch, dev)}
    t_a = time.perf_counter()
    out["serve"] = rec_serve(torch, dev)
    t_b = time.perf_counter()
    out["consistency"] = rec_consistency_f32(torch, dev)
    t_c = time.perf_counter()
    out["train"] = rec_train(torch, dev)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"rec: phase 16 took {out['phase_s']:.1f} s (kernels "
        f"{t_a - t_phase:.1f} s, 16a {t_b - t_a:.1f} s, 16b {t_c - t_b:.1f} s, 16c "
        f"{time.perf_counter() - t_c:.1f} s)")
    report["recurrent"] = out
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--phase", type=int, choices=[9, 10, 15, 16],
                    default=None,
                    help="run phases 1, 2 and this one only (9: 9.3's "
                         "pipelined and sharded sweeps and 14d; 10: phases "
                         "3, 10c and 10d too; no kernels line)")
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

    if args.phase == 16:
        recurrent_phase(torch, report, dev)
        return finish(torch, args, report, card, None)
    if args.phase == 9:
        multicard_phase(torch, np, kernels, cong, report)
        return finish(torch, args, report, card, None)
    # 15a starts here and runs beside phases 3-12 (see DryrunCells)
    if args.phase != 10:
        cells = DryrunCells(HERE / "build" / "dryrun")
        RUNNING.append(cells)
    if args.phase == 15:
        dryrun_phase(torch, np, kernels, cong, report, cells)
        return finish(torch, args, report, card, None)

    # 3. edges, then past the kernels' old width limits
    from repro_torch.kernels import place_step as kstep

    err = edge_checks(torch, ref, cong, fit, dev)
    for name, e in wide_edge_checks(torch, ref, cong, kstep, dev).items():
        err[name] = max(err.get(name, 0.0), e)
    log(f"edges: max |kernel - plain| {err}")
    if args.phase == 10:
        wide_phase(torch, np, ref, kernels, cong, report)
        quickstart_phase(torch, np, report)
        return finish(torch, args, report, card, None)

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
        "plan": checked_plan(torch, cong, G, n, 1, K, Tp, lp=False),
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
        "plan": checked_plan(torch, cong, 1, n1c, 1, K1c, T1c, lp=False),
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
    kinfo["lane_sum"] = dict(tol["lane_sum"],
                             tol_launches=tol["launches"]["lane_sum"])

    # 10. the constrained Table-I fleet and the GCT-like fleet
    con = constrained_phase(torch, np, ref, kernels, cong, fleet, report)
    gct = gct_phase(torch, np, ref, kernels, cong, report)
    # 10c. a wide constrained fleet (D = 276, m * D = 8280); 10d. the
    # quickstart through the evaluate_many shim, card against CPU
    wide = wide_phase(torch, np, ref, kernels, cong, report)
    quick = quickstart_phase(torch, np, report)
    counter = {"congestion_many": "congestion_many",
               "congestion_lp": "congestion_many",
               "fit_scores_many": "fit_scores_many",
               "fit_scores": "fit_scores", "place_step": "place_step",
               "two_phase": "two_phase"}
    for name, key in counter.items():
        kinfo[name]["phase10_launches"] = {
            "constrained": con["launches"][key], "gct": gct["launches"][key],
            "wide": wide["launches"][key],
            "quickstart": quick["launches"][key]}
    kinfo["congestion_lp"]["max_abs_err"] = max(
        kinfo["congestion_lp"]["max_abs_err"], con["max_abs_err"],
        gct["max_abs_err"], wide["max_abs_err"])
    kinfo["congestion_lp"]["phase10_ms"] = {
        "constrained": con["apply"]["ms"], "gct": gct["apply"]["ms"],
        "wide": wide["apply"]["ms"]}
    kinfo["place_step"]["phase10_ms"] = {
        "constrained": con["place_step"]["ms"],
        "gct type-parallel": gct["place_step"]["type-parallel"]["ms"],
        "gct wave": gct["place_step"]["wave-sequential"]["ms"],
        "wide type-parallel": wide["place_step"]["ms"]}
    # each widened kernel at phase 10c's shapes, with its own bound
    for name in ("congestion_lp", "place_step", "two_phase"):
        info = wide["apply" if name == "congestion_lp" else name]
        kinfo[name]["wide"] = {
            key: info.get(key) for key in ("shape", "plan", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "smem_rows",
                                           "latency_bound_ms")}

    # 11. the serving loop on a GCT-like trace
    serve = serve_phase(torch, np, ref, kernels, cong, report)
    for name, key in (("congestion_many", "congestion_many"),
                      ("congestion_lp", "congestion_many"),
                      ("place_step", "place_step")):
        kinfo[name]["phase11_launches"] = serve["launches"][key]
    kinfo["congestion_lp"]["max_abs_err"] = max(
        kinfo["congestion_lp"]["max_abs_err"], serve["max_abs_err"])

    # 12. stochastic planning, then preprovision on phase 11's service
    stoch = stochastic_phase(torch, np, ref, kernels, cong, fleet,
                             serve.pop("service"), report)
    for name, key in (("congestion_many", "congestion_many"),
                      ("congestion_lp", "congestion_many"),
                      ("place_step", "place_step")):
        kinfo[name]["phase12_launches"] = {
            run: got[key] for run, got in stoch["launches"].items()}
    kinfo["congestion_lp"]["max_abs_err"] = max(
        kinfo["congestion_lp"]["max_abs_err"], stoch["max_abs_err"])
    kinfo["congestion_lp"]["phase12_ms"] = stoch["apply"]["ms"]
    kinfo["place_step"]["phase12_ms"] = stoch["place_step"]["ms"]

    # 13. the LM serving path (no kernel of its own), 14. the LM training
    # path (no kernel of its own); 15a's processes wait meanwhile
    cells.pause()
    lm_phase(torch, report)
    train_phase(torch, report)
    # 16. the recurrent families through the WKV and linear-scan kernels
    rec = recurrent_phase(torch, report, dev)
    kinfo.update(rec["kernels"])
    cells.resume()

    # 15. the LM dry-run, and the schedule rightsized from its records
    dr = dryrun_phase(torch, np, kernels, cong, report, cells)
    for name, key in (("congestion_many", "congestion_many"),
                      ("congestion_lp", "congestion_many"),
                      ("place_step", "place_step")):
        kinfo[name]["phase15_launches"] = dr["fleet"]["launches"][key]

    # the congestion kernel's one counter counts both of its entries; the
    # main path launches it only through congestion_lp
    runs = {"congestion_many": launches["congestion_many"],
            "congestion_lp": calls_c,
            "fit_scores_many": launches["fit_scores_many"],
            "fit_scores": launches_1["fit_scores"],
            "place_step": stepper["launches"]["place_step"],
            "two_phase": launches_1["two_phase"],
            # phase 16's path: 16a serving (forward), 16c training
            "wkv": rec["serve"]["rwkv6-7b"]["launches"]["wkv"],
            "linear_scan":
                rec["serve"]["recurrentgemma-9b"]["launches"]["linear_scan"],
            "wkv_backward":
                rec["train"]["rwkv6-7b"]["launches"]["wkv_backward"],
            "linear_scan_backward": rec["train"]["recurrentgemma-9b"][
                "launches"]["linear_scan_backward"],
            # phase 9.3's sweep sharded over the most cards (tol mode)
            "lane_sum": kinfo["lane_sum"]["launches"]}
    for name in ("wkv", "linear_scan"):
        kinfo[name]["train_launches"] = {
            arch: got["launches"].get(name, 0)
            for arch, got in rec["train"].items()}
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
                                              "bound_ms_f32_rate",
                                              "scratch_bytes",
                                              "tol_launches",
                                              "phase10_launches",
                                              "phase10_ms", "wide",
                                              "phase11_launches",
                                              "phase12_launches",
                                              "phase12_ms",
                                              "phase15_launches",
                                              "train_launches",
                                              "sharded_launches",
                                              "max_rel_err", "shape",
                                              "plan")
            if key in kinfo[name]}}
        for name in SOURCES]}
    report["kernels"] = kinfo
    return finish(torch, args, report, card, line)


def finish(torch, args, report, card, line) -> int:
    """Write the report, then the result lines: the card, the kernels line
    (none when one phase ran alone) and the last line."""
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1, default=float))
    # the result lines carry no time stamp: they are read as they are
    print(card)
    if line is not None:
        print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


RUNNING: list = []               # DryrunCells to stop when main ends


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for c in RUNNING:
            c.kill()
