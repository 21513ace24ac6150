"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  It prints one JSON object as the last line of standard
output (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with the plain reference beside its limit), and the same checks as
the last lines of standard error.  With ``--trace 0`` the metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profile of the window.  It exits with a non-zero code and prints no
result when no card is visible, when the cell needs more cards than there
are, or when JAX or the JAX package is loaded once the window has closed
and the metrics and checks have been read.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program's builds at a fixed place in the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(ROOT / "build" / "inductor")
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))

    import torch

    from bench import harness

    spec = harness.cell_spec(ROOT, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    line = harness.run(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=T_START)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
