"""The rightsizer's hand-written kernels against another tree's, in one
process on one CUDA card, at the shapes ``chip_smoke.py`` phase 5 times on
the main path.

Builds ``congestion.cu`` and ``place_step.cu`` of this tree and of the tree
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
  0, both recorded from this tree's wrappers.

Every output (and every stepper pool) of the two libraries must be
bit-equal.  Each kernel is timed in the order parent, this tree, this tree,
parent, ``--rounds`` times, with ``chip_smoke.device_ms`` (marker-checked
profiles; a fresh stepper pool per call), and the card's name and power
limit are printed beside the per-order times, their medians and the ratio.
The last line is one JSON object.  Run from the repository root:

    python3 scripts/kernel_ab.py --parent build/parent [--rounds 2] [--out FILE]
"""

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

NAMES = ("congestion", "place_step")


def build_pair(parent: pathlib.Path) -> dict:
    """{(tree, source): loaded library} for both trees' sources."""
    from repro_torch.kernels import build

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"parent": parent / "src" / "repro_torch" / "kernels" / "csrc",
             "change": build.CSRC}
    jobs = {}
    for tree, csrc in trees.items():
        for name in NAMES:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--rounds", type=int, default=2)
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
    libs = build_pair(args.parent)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    g = torch.Generator().manual_seed(5)

    def spans(G, n, T):
        s = torch.randint(0, T, (G, n), generator=g, dtype=torch.int32)
        ln = torch.randint(0, T // 2, (G, n), generator=g, dtype=torch.int32)
        return s.to(dev), torch.clamp(s + ln, max=T - 1).to(dev)

    cases = {}
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
                sg.data_ptr(), eg.data_ptr(), wg.data_ptr(), og.data_ptr(),
                G, n, T, D, stream())
            assert err == 0, err
        cases[f"congestion_many G={G} n=1000 T'=24 K=5"] = (
            many, lambda tree, many=many, og=og: (many(tree), og.clone())[1])

    (sp_args, sp_kw), (tw_args, tw_kw) = recorded_dispatches(torch)
    pool0, rest, quantum = sp_args[0], sp_args[1:9], float(sp_args[9])
    A, n_cap, K = pool0.shape
    L, _, Ds = rest[2].shape
    pools = []

    res_step = torch.empty(2 * A + L * A, dtype=torch.int32, device=dev)

    def step(tree, pool=None):
        pool = pool if pool is not None else pools.pop()
        smem = ctypes.c_int(0)
        err = libs[tree, "place_step"].place_step_launch(
            pool.data_ptr(), *(t.data_ptr() for t in rest), quantum,
            res_step.data_ptr(), res_step[A:].data_ptr(),
            res_step[2 * A:].data_ptr(), A, L, n_cap, K, Ds, sp_kw["rows"],
            int(sp_kw["purchase"]), int(sp_kw["similarity"]),
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

    res_walk = torch.empty(3 * P + 2 * nw, dtype=torch.int32, device=dev)

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
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
