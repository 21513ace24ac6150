"""The linear-scan kernels (``kernels/csrc/scan.cu``) against PyTorch's own
streaming passes of the same bytes, in one process on one CUDA card, at
phase 16's shapes (B = 4, W = 4096; the forward at S = 4100, the backward
at S = 2048).

The yardsticks give the rate this card reaches on a plain stream:
``torch.add(a, b, out=h)`` (the forward's 3 n * 4 bytes), ``h.copy_(a)``
(2 n * 4) and, at the backward's shape, ``torch.addcmul(a, b, gh, out=h)``
(4 n * 4).  The kernels' outputs must be bit-equal to the plain loops.
Each function is timed by CUDA events over 50 calls, in rounds whose order
alternates; the medians, their share of the byte bound of the scan (3 n * 4
or 5 n * 4 bytes at 3.35 TB/s) and of their own bytes, and the card's name
and power limit are printed.  The last line is one JSON object.  Run from
the repository root:

    python3 scripts/scan_yardstick.py [--rounds 3] [--out FILE]
"""

import argparse
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels import scan as kscan

    if not torch.cuda.is_available():
        print("scan_yardstick: no CUDA card is visible", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    B, W = 4, 4096
    results = {}
    for S, backward in ((4100, False), (2048, True)):
        n = B * S * W
        a = torch.rand((B, S, W), generator=g, device=dev)
        b = torch.randn((B, S, W), generator=g, device=dev)
        gh = torch.randn((B, S, W), generator=g, device=dev)
        h = torch.empty_like(b)
        hp = ref.linear_scan_ref(a, b)
        if backward:
            want = ref.linear_scan_backward_ref(a, hp, gh)
            got = kscan.scan_backward(a, hp, gh)
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            kernel = ("linear_scan_backward",
                      lambda: kscan.scan_backward(a, hp, gh), 5)
        else:
            same = torch.equal(kscan.scan_forward(a, b), hp)
            kernel = ("linear_scan", lambda: kscan.scan_forward(a, b), 3)
        if not same:
            raise AssertionError(f"{kernel[0]} differs from the plain loop")
        # name: (function, floats moved a call, in units of n)
        fns = {kernel[0]: kernel[1:],
               "torch.add(a, b, out=h)": (lambda: torch.add(a, b, out=h), 3),
               "h.copy_(a)": (lambda: h.copy_(a), 2)}
        if backward:
            fns["torch.addcmul(a, b, gh, out=h)"] = (
                lambda: torch.addcmul(a, b, gh, out=h), 4)
        times = {name: [] for name in fns}
        for r in range(args.rounds):
            for name in (list(fns) if r % 2 == 0 else list(reversed(fns))):
                times[name].append(cs.cuda_ms(torch, fns[name][0], reps=50,
                                              warmup=5))
        bound_ms = kernel[2] * n * 4 / cs.PEAK_BYTES_PER_S * 1e3
        what = f"{kernel[0]} B={B} S={S} W={W}"
        results[what] = {"bound_ms": bound_ms, "ms": times, "median_ms": {},
                         "share_of_scan_bound": {}, "share_of_own_bound": {}}
        for name, ms in times.items():
            med = statistics.median(ms)
            own = fns[name][1] * n * 4 / cs.PEAK_BYTES_PER_S * 1e3
            results[what]["median_ms"][name] = med
            results[what]["share_of_scan_bound"][name] = bound_ms / med
            results[what]["share_of_own_bound"][name] = own / med
            print(f"{what} {name}: median {med:.6f} ms, {own / med:.3f} of "
                  f"its own {own:.6f} ms byte bound, {bound_ms / med:.3f} of "
                  f"the scan's {bound_ms:.6f}; {ms} ({card})", flush=True)
        del a, b, gh, h, hp
    line = {"card": card, "results": results}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
