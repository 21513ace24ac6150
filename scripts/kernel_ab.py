"""The hand-written kernels of the rightsizer and of the RG-LRU scan
against another tree's, in one process on one CUDA card, at the shapes
``chip_smoke.py`` times on the main path (phases 5 and 16).

Builds ``congestion.cu``, ``place_step.cu`` and ``scan.cu`` of this tree and
of the tree
given by ``--parent`` (an unpacked checkout, for example of the parent
commit) with the flags of ``kernels/build.py``, one ``nvcc`` per source, all
at once, into ``build/ab/``, and calls both libraries' C entries on the same
inputs:

- ``congestion_lp`` (the LP's apply) at B = 16, n = 1000, m = 10, D = 5,
  T' = 24, ``congestion_many`` at G = 160 and its G = 1 launch, on random
  spans and weights from a seeded generator;
- ``place_step``: the type-parallel dispatch of lp-map (similarity fit) of
  the 16 Table-I instances after the tolerance-mode ``pallas`` solve, and
  ``two_phase``: lp-map-f's similarity launch of ``rightsize`` on instance
  0, both recorded from this tree's wrappers;
- ``linear_scan`` at B = 4, S = 4100, W = 4096 and ``linear_scan_backward``
  at S = 2048 (phase 16's prefill and training step), on float32 inputs
  from a seeded generator.

Every output (and every stepper pool) of the two libraries must be
bit-equal.  Each kernel is timed in the order parent, this tree, this tree,
parent, ``--rounds`` times, with ``chip_smoke.device_ms`` (marker-checked
profiles; a fresh stepper pool per call), and the card's name and power
limit are printed beside the per-order times, their medians and the ratio.
The last line is one JSON object.  Run from the repository root:

    python3 scripts/kernel_ab.py --parent build/parent [--rounds 2] \
        [--kernels congestion place_step scan] [--out FILE]

``--kernels`` picks the sources whose kernels are compared (all three by
default).  ``--prefill`` (with ``scan``) also times recurrentgemma-9b's
whole prefill at full width in bfloat16 (B = 4, a 4100-token prompt, random
weights from a seed: ``chip_smoke.py`` phase 16a's) with either tree's scan
library loaded, in the same order, on the host clock around a synchronized
call, the two trees' logits bit-equal.
"""

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

NAMES = ("congestion", "place_step", "scan")


def build_pair(parent: pathlib.Path, names=NAMES) -> dict:
    """{(tree, source): loaded library} for both trees' sources."""
    from repro_torch.kernels import build

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"parent": parent / "src" / "repro_torch" / "kernels" / "csrc",
             "change": build.CSRC}
    jobs = {}
    for tree, csrc in trees.items():
        for name in names:
            lib = out_dir / f"lib{name}_{tree}.so"
            cmd = [build.nvcc_path(), *build.FLAGS,
                   *build.EXTRA_FLAGS.get(name, ()), "-o", str(lib),
                   str(csrc / f"{name}.cu")]
            jobs[tree, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for key, (proc, path) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in build.SIGNATURES[key[1]].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def recorded_dispatches(torch):
    """(sub_phase args and kwargs, two_phase_walk args and kwargs) of the
    main path: lp-map's similarity type-parallel dispatch on the Table-I
    fleet and lp-map-f's similarity launch on instance 0."""
    import chip_smoke as cs
    from repro_torch.core import (FleetEngine, PlacementConfig, SolverConfig,
                                  place_many, rightsize)
    from repro_torch.kernels import place_step as kstep
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    fleet = [synthetic_instance(SyntheticSpec(seed=s))
             for s in range(cs.FLEET)]
    res = FleetEngine(solver=SolverConfig(tol=cs.TOL, iters=4000,
                                          operator="pallas"),
                      placement=PlacementConfig(engine="compiled"),
                      algos=("lp-map",)).evaluate(fleet)
    batch = res.plan.buckets[0].batch
    maps = [res.lp_results[i].mapping for i in res.plan.buckets[0].indices]
    rec = cs.Recorder(torch, kstep, "sub_phase", every=True)
    with rec:
        place_many(batch, maps, fit="similarity", placement="compiled")
    walk = cs.Recorder(torch, kstep, "two_phase_walk", every=True)
    with walk:
        rightsize(fleet[0], "lp-map-f", backend="kernel",
                  lp_result=res.lp_results[0])
    return rec.log[0], next(e for e in walk.log if e[1]["similarity"])


def scan_cases(torch, dev, libs, stream) -> dict:
    """``linear_scan`` at phase 16's prefill and ``linear_scan_backward`` at
    its training step, B = 4, W = 4096: {name: (run, result)}."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, W = 4, 4096
    cases = {}
    for S, backward in ((4100, False), (2048, True)):
        a = torch.rand((B, S, W), generator=g, device=dev)
        b = torch.randn((B, S, W), generator=g, device=dev)
        ga, gb = torch.empty_like(b), torch.empty_like(b)
        if not backward:
            h = torch.empty_like(b)

            def run(tree, a=a, b=b, h=h, S=S):
                err = libs[tree, "scan"].linear_scan_launch(
                    a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W,
                    stream())
                assert err == 0, err
            cases[f"linear_scan B={B} S={S} W={W}"] = (
                run, lambda tree, run=run, h=h: (run(tree), h.clone())[1])
        else:
            # b stands for h, a fresh draw for gh
            gh = torch.randn((B, S, W), generator=g, device=dev)

            def run(tree, a=a, b=b, gh=gh, ga=ga, gb=gb, S=S):
                err = libs[tree, "scan"].linear_scan_backward_launch(
                    a.data_ptr(), b.data_ptr(), gh.data_ptr(), ga.data_ptr(),
                    gb.data_ptr(), B, S, W, stream())
                assert err == 0, err
            cases[f"linear_scan_backward B={B} S={S} W={W}"] = (
                run, lambda tree, run=run, ga=ga, gb=gb: (
                    run(tree), torch.cat([ga.clone(), gb.clone()]))[1])
    return cases


def prefill_ab(torch, dev, libs, rounds: int, card: str) -> dict:
    """recurrentgemma-9b's prefill (phase 16a's) with the parent's scan
    library and this tree's, in the order parent, change, change, parent,
    ``rounds`` times after one warm call each: host seconds per call."""
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import init_params, prefill

    cfg = get_config("recurrentgemma-9b")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_params(gen, cfg, dev)
    batch = lm_serve.make_batch(cfg, cs.LM_BATCH, cs.LM_PROMPT, gen)
    loaded = build.load("scan")

    def run(tree):
        build._LIBS["scan"] = libs[tree, "scan"]
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _state = prefill(model, batch,
                                     max_len=cs.LM_PROMPT + cs.LM_GEN)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, logits
        finally:
            build._LIBS["scan"] = loaded

    with torch.no_grad():
        first = {tree: run(tree)[1] for tree in ("parent", "change")}
        if not torch.equal(first["parent"], first["change"]):
            raise AssertionError("prefill: the two trees' logits differ")
        del first
        times = {"parent": [], "change": []}
        for _ in range(rounds):
            for tree in ("parent", "change", "change", "parent"):
                times[tree].append(run(tree)[0])
    med = {t: statistics.median(v) for t, v in times.items()}
    print(f"recurrentgemma-9b prefill B={cs.LM_BATCH} S={cs.LM_PROMPT} "
          f"bf16: host s per call, parent {times['parent']}, change "
          f"{times['change']}; medians {med['parent']:.6f} / "
          f"{med['change']:.6f}, change - parent "
          f"{(med['change'] - med['parent']) * 1e3:.3f} ms ({card})",
          flush=True)
    return {"s": times, "median_s": med,
            "change_minus_parent_ms": (med["change"] - med["parent"]) * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", nargs="+", choices=NAMES, default=NAMES)
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card is visible", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    libs = build_pair(args.parent, args.kernels)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    g = torch.Generator().manual_seed(5)

    def spans(G, n, T):
        s = torch.randint(0, T, (G, n), generator=g, dtype=torch.int32)
        ln = torch.randint(0, T // 2, (G, n), generator=g, dtype=torch.int32)
        return s.to(dev), torch.clamp(s + ln, max=T - 1).to(dev)

    cases = {}
    pools, step = [], None
    if "congestion" in args.kernels:
        B, n, m, D, T = 16, 1000, 10, 5, 24
        s, e = spans(B, n, T)
        w = torch.rand((B, n, m, D), generator=g).to(dev)
        x = torch.rand((B, n, m), generator=g).to(dev)
        out_lp = torch.empty((B, T, m, D), device=dev)

        def lp(tree):
            err = libs[tree, "congestion"].congestion_lp_launch(
                s.data_ptr(), e.data_ptr(), x.data_ptr(), w.data_ptr(),
                out_lp.data_ptr(), B, n, m, D, T, stream())
            assert err == 0, err
        cases["congestion_lp B=16 n=1000 m=10 D=5 T'=24"] = (
            lp, lambda tree: (lp(tree), out_lp.clone())[1])

        for G in (160, 1):
            sg, eg = spans(G, n, T)
            wg = torch.rand((G, n, D), generator=g).to(dev)
            og = torch.empty((G, T, D), device=dev)

            def many(tree, sg=sg, eg=eg, wg=wg, og=og, G=G):
                err = libs[tree, "congestion"].congestion_many_launch(
                    sg.data_ptr(), eg.data_ptr(), wg.data_ptr(),
                    og.data_ptr(), G, n, T, D, stream())
                assert err == 0, err
            cases[f"congestion_many G={G} n=1000 T'=24 K=5"] = (
                many,
                lambda tree, many=many, og=og: (many(tree), og.clone())[1])

    if "place_step" in args.kernels:
        (sp_args, sp_kw), (tw_args, tw_kw) = recorded_dispatches(torch)
        pool0, rest, quantum = sp_args[0], sp_args[1:9], float(sp_args[9])
        A, n_cap, K = pool0.shape
        L, _, Ds = rest[2].shape

        res_step = torch.empty(2 * A + L * A, dtype=torch.int32, device=dev)

        def step(tree, pool=None):
            pool = pool if pool is not None else pools.pop()
            smem = ctypes.c_int(0)
            err = libs[tree, "place_step"].place_step_launch(
                pool.data_ptr(), *(t.data_ptr() for t in rest), quantum,
                res_step.data_ptr(), res_step[A:].data_ptr(),
                res_step[2 * A:].data_ptr(), A, L, n_cap, K, Ds,
                sp_kw["rows"], int(sp_kw["purchase"]),
                int(sp_kw["similarity"]),
                ctypes.addressof(smem), stream())
            assert err == 0, err

        def step_result(tree):
            pool = pool0.clone()
            step(tree, pool)
            return torch.cat([res_step, pool.flatten().view(torch.int32)])
        cases[f"place_step type-parallel A={A} L={L} K={K}"] = (step,
                                                                step_result)

        walk_t = tw_args[:7]
        Tw = tw_args[7]
        P, Dw = walk_t[2].shape
        nw = walk_t[3].shape[0]
        wpool = torch.empty((1 if tw_kw["sequential"] else P,
                             max(tw_kw["rows"], 1), Tw * Dw),
                            dtype=torch.float64, device=dev)

        res_walk = torch.empty(3 * P + 2 * nw, dtype=torch.int32,
                               device=dev)

        def walk(tree):
            smem = ctypes.c_int(0)
            err = libs[tree, "place_step"].two_phase_launch(
                *(t.data_ptr() for t in walk_t), wpool.data_ptr(), float(
                    tw_args[8]), res_walk.data_ptr(), P, nw, Tw * Dw, Dw,
                tw_kw["rows"], int(tw_kw["similarity"]),
                int(tw_kw["sequential"]), ctypes.addressof(smem), stream())
            assert err == 0, err
        cases[f"two_phase lp-map-f similarity n={nw} P={P} T'={Tw} D={Dw}"] = (
            walk, lambda tree: (walk(tree), res_walk.clone())[1])

    if "scan" in args.kernels:
        cases.update(scan_cases(torch, dev, libs, stream))
    results = {}
    for name, (fn, result) in cases.items():
        if not torch.equal(result("parent"), result("change")):
            raise AssertionError(f"{name}: the two trees' outputs differ")
        times = {"parent": [], "change": []}
        for _ in range(args.rounds):
            for tree in ("parent", "change", "change", "parent"):
                if fn is step:  # a fresh pool per timed call
                    pools[:] = [pool0.clone() for _ in range(
                        10 + 20 * cs.PROFILE_TRIES)]
                times[tree].append(cs.device_ms(
                    torch, lambda tree=tree: fn(tree), reps=20, warmup=5))
                pools.clear()
        med = {t: statistics.median(v) for t, v in times.items()}
        results[name] = {"ms": times, "median_ms": med,
                         "change_over_parent": med["change"] / med["parent"]}
        print(f"{name}: device ms per call, parent {times['parent']}, "
              f"change {times['change']}; medians {med['parent']:.6f} / "
              f"{med['change']:.6f} ({card})", flush=True)
    line = {"card": card, "kernels": results}
    if args.prefill and "scan" in args.kernels:
        line["prefill"] = prefill_ab(torch, dev, libs, args.rounds, card)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
