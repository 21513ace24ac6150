"""Where the WKV kernels' time goes on the card: the forward's phase timers
and the backward's four launches, at the shapes ``chip_smoke.py`` phase 16
times them (B = 4, H = 64, N = 64; the forward at S = 4100, the backward
at S = 2048; bfloat16 r, k, v as the model runs them, then float32).

    python3 scripts/wkv_phase_trace.py [--out FILE]

The forward: ``kernels/csrc/wkv.cu`` is compiled a second time with
``-DWKV_TRACE`` (into ``build/trace/``), which makes one thread of each
block read ``%globaltimer`` at every phase boundary of
``wkv_forward_kernel`` into a row a block (the row its ticket, so chunk
c of (b, h) is row c B H + b H + h).  Per phase the p10 / p50 / p90 over
blocks, in microseconds:

  * ``load``: the log-decays staged (``cp.async``);
  * ``prefix``: the float64 prefix sums, then r, k, v staged;
  * ``increment``: the state increment on the tensor cores (warps 0-3);
  * ``wait``: the predecessor chunk's state becoming ready (the serial
    chain; 0 for chunk 0);
  * ``publish``: the state entering the chunk read and the state leaving it
    written to the ring, fenced and flagged;
  * ``scores``: from there until A is whole (y's inter-chunk product, A's
    elementwise pairs, the barrier);
  * ``y``: y = A v written.
  * ``scores_mma`` (warp 4, beside the above): from the prefix sums to the
    end of its tensor-core score blocks.

Beside them: each block's duration, the kernel's span (first start to last
end), the most blocks resident at once, the span if the blocks had run back
to back at that residency (sum of durations / residency: the work's floor
at this design's occupancy; again without the waits), the spacing of a
(b, h)'s chunk starts, and the chain's floor: the blocks of chunk c + 1
that were already waiting when chunk c published give the flag's latency
(state ready less the predecessor's publish), and the floor is the median
publish times the chunks plus the median latency times the handoffs.  The kernel's time by CUDA events for the package's build
and for the traced build (timers off and on) shows what the timers cost.

The backward: one call's four launches under ``torch.profiler``, device
microseconds each (``chunk_state``, ``state_scan``, ``chunk_grad``,
``bonus_sum``).  Needs a CUDA card and ``nvcc``; torch and the port only.
Prints one JSON object, also written to ``--out``.
"""

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

B, H, N = 4, 64, 64
S_FWD, S_BWD = 4100, 2048
PHASES = ("load", "prefix", "increment", "wait", "publish", "scores", "y")


def traced_library(torch):
    """The -DWKV_TRACE build of wkv.cu, argtypes set as the package's."""
    from repro_torch.kernels import build

    out = ROOT / "build" / "trace" / "libwkv_trace.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), *build.FLAGS, "-DWKV_TRACE", "-o", str(out),
           str(build.CSRC / "wkv.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in build.SIGNATURES["wkv"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.wkv_set_trace.argtypes = [ctypes.c_void_p]
    lib.wkv_set_trace.restype = ctypes.c_int
    lib.wkv_trace_slots.restype = ctypes.c_int
    return lib


def event_ms(torch, fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def quantiles(torch, x) -> list:
    q = torch.quantile(x, torch.tensor([0.1, 0.5, 0.9], dtype=x.dtype))
    return [round(float(a), 3) for a in q]


def forward_trace(torch, dtype, traced) -> dict:
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import wkv as kwkv

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    dev = torch.device("cuda")
    ins, _, _ = chip_smoke.wkv_inputs(torch, dev, B, S_FWD, H, N, dtype, 4)
    nc = -(-S_FWD // ref.WKV_CHUNK)
    rows = torch.zeros((nc * B * H, traced.wkv_trace_slots()),
                       dtype=torch.int64, device=dev)
    package = build.load("wkv")
    out = {"ms_package_build": event_ms(torch, lambda: kwkv.wkv_forward(*ins))}
    build._LIBS["wkv"] = traced
    try:
        out["ms_traced_build_timers_off"] = event_ms(
            torch, lambda: kwkv.wkv_forward(*ins))
        if traced.wkv_set_trace(rows.data_ptr()) != 0:
            raise RuntimeError("wkv_set_trace failed")
        out["ms_traced_build_timers_on"] = event_ms(
            torch, lambda: kwkv.wkv_forward(*ins))
        rows.zero_()
        kwkv.wkv_forward(*ins)  # the call the rows come from
        torch.cuda.synchronize()
        traced.wkv_set_trace(None)
    finally:
        build._LIBS["wkv"] = package
    out.update(analyse(torch, rows.cpu(), nc))
    return out


def analyse(torch, rows, nc: int) -> dict:
    """The readings of one traced call's rows (nc B H, slots) of
    %globaltimer ns."""
    t = rows.double()
    if bool((t == 0).any()):
        raise RuntimeError("a phase timer was not written")
    t = (t - t[:, 0].min()) / 1e3  # microseconds from the first start
    out = {}
    out["phases_us_p10_p50_p90"] = {
        name: quantiles(torch, t[:, i + 1] - t[:, i])
        for i, name in enumerate(PHASES)}
    out["phases_us_p10_p50_p90"]["scores_mma"] = quantiles(
        torch, t[:, 8] - t[:, 2])
    dur = t[:, 7] - t[:, 0]
    out["block_us_p10_p50_p90"] = quantiles(torch, dur)
    span = float(t[:, 7].max())
    out["span_us"] = round(span, 3)
    # the most blocks resident at once, from the starts and ends
    ev = sorted([(float(a), 1) for a in t[:, 0]]
                + [(float(a), -1) for a in t[:, 7]])
    live = most = 0
    for _, d in ev:
        live += d
        most = max(most, live)
    out["resident_blocks_max"] = most
    out["work_floor_us"] = round(float(dur.sum()) / most, 3)
    wait = t[:, 4] - t[:, 3]
    out["work_floor_without_waits_us"] = round(
        float((dur - wait).sum()) / most, 3)
    # the chain, per (b, h): the spacing of its chunks' starts, and where
    # chunk c + 1 was already waiting when chunk c published, how long the
    # flag took to reach it; the chain's floor is the chunks' median
    # publish plus that latency, summed over the chunks
    bh = B * H
    start = t[:, 0].reshape(nc, bh)
    out["chunk_start_spacing_us_p10_p50_p90"] = quantiles(
        torch, (start[1:] - start[:-1]).flatten())
    ready = t[bh:, 4].reshape(nc - 1, bh)
    publish = t[:-bh, 5].reshape(nc - 1, bh)
    waiting = t[bh:, 3].reshape(nc - 1, bh) < publish
    out["blocks_waiting_at_publish"] = int(waiting.sum())
    if bool(waiting.any()):
        flag = (ready - publish)[waiting]
        out["flag_latency_us_p10_p50_p90"] = quantiles(torch, flag)
        pub = float((t[:, 5] - t[:, 4]).median())
        out["chain_floor_us"] = round(nc * pub + (nc - 1) * float(
            flag.median()), 3)
    else:
        out["flag_latency_us_p10_p50_p90"] = None
        out["chain_floor_us"] = None
    out["blocks_waiting_over_1us"] = int((wait > 1.0).sum())
    out["blocks"] = int(t.shape[0])
    return out


def backward_profile(torch, dtype) -> dict:
    from repro_torch.kernels import wkv as kwkv

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    dev = torch.device("cuda")
    ins, gy, gs = chip_smoke.wkv_inputs(torch, dev, B, S_BWD, H, N, dtype, 4)
    ms = event_ms(torch, lambda: kwkv.wkv_backward_launch(*ins, gy, gs))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            kwkv.wkv_backward_launch(*ins, gy, gs)
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        name = ev.key
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if "wkv" in name and "launch" not in name and dev_us > 0:
            short = next((s for s in ("chunk_state", "state_scan",
                                      "chunk_grad", "bonus_sum")
                          if s in name), name[:60])
            per[short] = round(dev_us / 5, 3)
    return {"ms_events": ms, "launches_us_per_call": per or
            "not measured (the profile showed no device time)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("wkv_phase_trace: no CUDA card is visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    traced = traced_library(torch)
    res = {"card": smi[0] if smi else torch.cuda.get_device_name(0),
           "shape": {"B": B, "H": H, "N": N, "S_forward": S_FWD,
                     "S_backward": S_BWD}}
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).replace("torch.", "")
        res[key] = {"forward": forward_trace(torch, dtype, traced),
                    "backward": backward_profile(torch, dtype)}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
