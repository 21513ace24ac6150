"""The dry-run's ``--all`` cells, several at once: every eligible
(architecture x shape) cell of ``repro_torch.configs.cells`` on the 16x16
and 2x16x16 meshes, each through ``python -m repro_torch.launch.dryrun
--arch A --shape S --mesh pod|multipod`` in its own process (one fake
process group each).  ``--all`` runs the same cells one after another in
one process.

Prints one line per cell (OK with its trace seconds, FAIL with the op that
failed, or TIMEOUT), then a JSON summary, which it also writes to
``OUT/summary.json``; the records go to ``OUT``.  Run from the repository
root:

    python3 scripts/dryrun_all.py [--jobs 8] [--timeout 900] [--out DIR]
        [--device cpu] [--arch A ...]
"""

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

_OP = re.compile(r"(aten\.[\w.]+|_c10d_functional\.[\w.]+)")


def failing_op(text: str) -> str:
    """The last ATen op a failing cell's output names, else its last
    line."""
    ops = _OP.findall(text)
    if ops:
        return ops[-1]
    rows = [r for r in text.splitlines() if r.strip()]
    return rows[-1][:200] if rows else "no output"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "dryrun_all")
    ap.add_argument("--device", default=None)
    ap.add_argument("--arch", action="append", default=None,
                    help="only this architecture's cells (repeatable)")
    args = ap.parse_args(argv)

    from repro_torch.configs import cells

    (args.out / "logs").mkdir(parents=True, exist_ok=True)
    todo = [(arch, shape, mesh) for arch, shape, _ok, _why in cells()
            for mesh in ("pod", "multipod")
            if args.arch is None or arch in args.arch]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    running, results = [], {}
    t0 = time.perf_counter()
    while todo or running:
        while todo and len(running) < args.jobs:
            arch, shape, mesh = todo.pop(0)
            tag = f"{arch}__{shape}__{'16x16' if mesh == 'pod' else '2x16x16'}"
            log = open(args.out / "logs" / f"{tag}.log", "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", str(args.out)]
            if args.device:
                cmd += ["--device", args.device]
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    env=env, cwd=ROOT)
            running.append((tag, proc, log, time.perf_counter()))
        time.sleep(1.0)
        for item in list(running):
            tag, proc, log, start = item
            wall = time.perf_counter() - start
            if proc.poll() is None and wall < args.timeout:
                continue
            timed_out = proc.poll() is None
            if timed_out:
                proc.kill()
                proc.wait()
            log.close()
            running.remove(item)
            text = (args.out / "logs" / f"{tag}.log").read_text()
            if timed_out:
                res = {"outcome": "TIMEOUT", "wall_s": wall}
            elif proc.returncode == 0 and f"OK   {tag}" in text:
                rec = json.loads((args.out / f"{tag}.json").read_text())
                res = {"outcome": "OK", "wall_s": wall,
                       "trace_s": rec["lower_s"]}
            else:
                res = {"outcome": "FAIL", "wall_s": wall,
                       "op": failing_op(text)}
            results[tag] = res
            print(f"{res['outcome']:7} {tag}: wall {wall:.1f} s"
                  + (f", trace {res['trace_s']} s" if "trace_s" in res else "")
                  + (f", {res['op']}" if "op" in res else ""), flush=True)
    summary = {"cells": results, "wall_s": time.perf_counter() - t0,
               "ok": sum(r["outcome"] == "OK" for r in results.values()),
               "failed": sorted(t for t, r in results.items()
                                if r["outcome"] != "OK")}
    (args.out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0 if not summary["failed"] else 1


if __name__ == "__main__":
    sys.exit(main())
