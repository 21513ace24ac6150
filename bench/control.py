"""Readings for the limits of ``correct``: runs a cell on several seeds in
one process and prints, for each seed, the numbers the program's answers
read against the plain reference (the lower readings) and those of the
controls on the same window (the upper readings): the reference's float32
placements put in the program's place (``float32``), and the program's
primal objective put in the place of its certified lower bound
(``primal_bound``).  With ``--solver-tol`` the program itself runs with its
LP tolerance loosened to that value, a control of the LP's guarantee.  The
benchmark's own runs do not run the controls.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 10 [--controls float32,primal_bound] [--solver-tol 0.05] [--out FILE]
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONTROLS = ("float32", "primal_bound")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--controls", default=",".join(CONTROLS),
                    help="comma-separated controls to read on each window "
                         "(empty: none, the program's readings alone)")
    ap.add_argument("--solver-tol", type=float,
                    help="run the program with this LP tolerance instead "
                         "of the mix's (no other control then)")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 2
    loose = args.solver_tol is not None
    controls = tuple(c for c in args.controls.split(",") if c)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = harness.run(
            ROOT, args.workload, seed, args.seconds, False,
            controls=() if loose else controls,
            solver={"tol": args.solver_tol} if loose else None)
        row = {"workload": args.workload, "seed": seed,
               "solver_tol": args.solver_tol,
               "correct": line["correct"], "checks": line["checks"],
               "control": line.get("control"), "metrics": line["metrics"],
               "attempted": line["attempted"], "failed": line["failed"],
               "device": line["device"],
               "wall_s": time.perf_counter() - t0}
        text = json.dumps(row)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
