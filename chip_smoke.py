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
   and read just after; then the same evaluate once more under
   ``torch.profiler`` for the card's busy time and idle share;
5. kernels on the main path's own inputs: every distinct shape the main path
   gave each kernel, held against the plain version, then timed: device
   time per call of the kernel, its plain version and one PyTorch library
   call (from the profiler), the least time the card could take, and the
   wall time per wrapper call (CUDA events).  The library call is
   ``torch.bmm`` of a prebuilt mask for congestion and, for fit, which no
   single PyTorch call computes, the plain version fused by
   ``torch.compile``: a yardstick only, which the port never calls;
6. the same fleet with no kernels (``operator="dense"``, ``backend="numpy"``):
   lower bounds and costs must agree;
7. the single-instance path: ``rightsize(instance 0, "lp-map-f",
   backend="kernel")`` with the fleet's LP result, which launches the B=1 fit
   kernel through ``TypePool.find_fit``; its cost must equal the fleet's.

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

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and non-tensor-core f32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

CONG_RTOL = CONG_ATOL = 1e-5   # float32 sums in another order
FIT_RTOL = FIT_ATOL = 1e-5     # dot / norm: float32 sums in another order
LB_RTOL = 1e-4                 # two float32 PDHG trajectories
COST_RTOL = 1e-5               # a flipped placement moves a whole node price
FLEET = 16                     # Table-I instances in the main path's fleet

SOURCES = {
    "congestion_many": ("src/repro_torch/kernels/csrc/congestion.cu",
                        "src/repro/kernels/congestion.py:110"),
    "fit_scores_many": ("src/repro_torch/kernels/csrc/fit.cu",
                        "src/repro/kernels/fit.py:184"),
    "fit_scores": ("src/repro_torch/kernels/csrc/fit.cu",
                   "src/repro/kernels/fit.py:104"),
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


def device_ms(torch, fn, reps: int = 100, warmup: int = 10) -> float:
    """Mean milliseconds of device time per call (every kernel and copy the
    call puts on the card), from a CUDA-activity profile of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(device_intervals(prof)[1].values()) * 1e3 / reps


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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    inputs (cloned) and the number of calls per shape; the wrapped
    function still counts its own launches."""

    def __init__(self, torch, module, name):
        self.torch, self.module, self.name = torch, module, name
        self.orig = getattr(module, name)
        self.calls = collections.Counter()
        self.inputs = {}

    def __call__(self, *args):
        key = tuple(tuple(a.shape) if hasattr(a, "shape") else a
                    for a in args)
        self.calls[key] += 1
        if key not in self.inputs:
            self.inputs[key] = tuple(
                a.clone() if isinstance(a, self.torch.Tensor) else a
                for a in args)
        return self.orig(*args)

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
                       (2, 256, 32, 8), (4, 1000, 24, 5)]:
        s, e = spans(G, n, T)
        w = torch.rand((G, n, K), generator=g)
        if n > 2:  # point tasks and never-active padding tasks
            e[:, 0] = s[:, 0]
            s[:, 1], e[:, 1] = 1, 0
        err["congestion_many"] = max(err["congestion_many"], check_congestion(
            torch, ref, cong, s.to(dev), e.to(dev), w.to(dev), T,
            f"G={G} n={n} T={T} K={K}"))

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
    from repro_torch.core import (FleetEngine, PlacementConfig,
                                  SolverConfig, rightsize, verify)
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
    with Recorder(torch, cong, "congestion_many") as rec_c, \
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
    kinfo = {}
    calls_c = sum(rec_c.calls.values())
    e_c = max(check_congestion(torch, ref, cong, *a, "main-path input")
              for a in rec_c.inputs.values())
    key_c, n_c = rec_c.calls.most_common(1)[0]
    start, end, w, T = rec_c.inputs[key_c]
    G, n, K = w.shape
    t_ids = torch.arange(T, device=dev, dtype=torch.int32)
    mask = ((start[:, None, :] <= t_ids[None, :, None])
            & (t_ids[None, :, None] <= end[:, None, :])).float()
    b_ms, b_by = bound(G * n * (8 + 4 * K) + G * T * K * 4,
                       2.0 * G * T * n * K)
    kinfo["congestion_many"] = {
        "shape": {"G": G, "n": n, "T": T, "K": K}, "calls": calls_c,
        "max_abs_err": max(e_c, err["congestion_many"]),
        "ms": device_ms(torch, lambda: cong.congestion_many(start, end, w, T)),
        "plain_ms": device_ms(
            torch, lambda: ref.congestion_many_ref(start, end, w, T)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(torch, lambda: torch.bmm(mask, w)),
        "call_ms": cuda_ms(
            torch, lambda: cong.congestion_many(start, end, w, T)),
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

    # 7. the single-instance path (B=1 fit kernel through TypePool.find_fit)
    with Recorder(torch, fit, "fit_scores") as rec_1:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        sol = rightsize(fleet[0], "lp-map-f", backend="kernel",
                        lp_result=res.lp_results[0])
        single_s = time.perf_counter() - t0
        launches_1 = kernels.launch_counts()
    verify(res.plan.buckets[0].batch.problems[0], sol)
    cost1 = sol.cost(fleet[0])
    want1 = res.entries[0]["costs"]["lp-map-f"]
    log(f"single: rightsize(lp-map-f, kernel) cost {cost1} vs fleet {want1}, "
        f"{single_s:.3f} s, launches {launches_1}")
    if cost1 != want1:
        raise AssertionError(f"single-instance cost {cost1} != fleet {want1}")
    if launches_1["fit_scores"] <= 0:
        raise AssertionError("the single-instance fit kernel never launched")
    e_1 = max(check_fit1(torch, ref, fit, *a, "single-path input")
              for a in rec_1.inputs.values())
    key_1, n_1 = rec_1.calls.most_common(1)[0]
    rem1, dem1, s1, e1, inv1 = rec_1.inputs[key_1]
    N1, T1, D1 = rem1.shape
    sp1 = int(e1 - s1 + 1)
    b_ms, b_by = bound(N1 * sp1 * D1 * 4 + (2 * D1) * 4 + 3 * N1 * 4,
                       8.0 * N1 * sp1 * D1)
    mask1 = ref.span_mask(torch.tensor([s1]), torch.tensor([e1]),
                          T1)[0].to(dev)
    fused1 = torch.compile(ref.fit_scores_ref, fullgraph=True, dynamic=False)
    check_fused(torch, fused1, ref.fit_scores_ref, (rem1, dem1, mask1, inv1),
                "fit_scores")
    kinfo["fit_scores"] = {
        "shape": {"N": N1, "T": T1, "D": D1, "span": sp1},
        "calls": sum(rec_1.calls.values()),
        "max_abs_err": max(e_1, err["fit_scores"]),
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
    log(timing_line("fit_scores", kinfo["fit_scores"]))
    report["single"] = {"cost": cost1, "wall_s": single_s,
                        "launches": launches_1}

    runs = {"congestion_many": launches, "fit_scores_many": launches,
            "fit_scores": launches_1}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": runs[name][name],
         "max_abs_err": kinfo[name]["max_abs_err"], "ms": kinfo[name]["ms"],
         "plain_ms": kinfo[name]["plain_ms"],
         "bound_ms": kinfo[name]["bound_ms"],
         "bound_by": kinfo[name]["bound_by"],
         "library_ms": kinfo[name]["library_ms"]}
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
