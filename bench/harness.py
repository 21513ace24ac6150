"""The benchmark's harness: one run of one cell.

Everything a cell needs is found by name under the benchmark's folder:
its configuration in ``configs/<config>.json``, its traffic in
``mixes/<traffic>.json`` (which names its driver, ``drivers/<driver>.py``)
and each metric's reader in ``metrics/<name>.py`` (else
``metrics/<name before its first dot>.py``).  A run sets up (inputs drawn
from the seed, the program loaded, one warm step on the cell's shapes),
then runs the closed loop for ``seconds`` (every step that starts inside
the window completes; at least ``min_steps`` run), then reads the device's
memory peak, frees the program's state, reads the metrics, checks a
sample of the window's answers against the plain reference and, last,
looks for modules of JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import pathlib
import sys
import time

# top-level module names that may not be loaded when the window closes:
# JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path, name: str):
    """The module in ``path``, named as a member of ``bench.<folder>`` so
    that its relative imports reach the benchmark's package."""
    spec = importlib.util.spec_from_file_location(
        f"bench.{path.parent.name}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(bench_dir: pathlib.Path, name: str):
    """The ``read`` function of metric ``name``'s reader file."""
    for stem in (name, name.split(".")[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.is_file():
            return _module(path, stem).read
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{bench_dir / 'metrics'}")


def driver_class(bench_dir: pathlib.Path, name: str):
    path = bench_dir / "drivers" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no driver {name!r} under {path.parent}")
    return _module(path, name).Driver


def cell_spec(root: pathlib.Path, cell: str) -> dict:
    """The cell's entry, configuration, mix and metric entries."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise ValueError(f"unknown workload {cell!r}; have {sorted(cells)}")
    w = cells[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / bench["paths"][0]
    config = load_json(root / conf["file"])
    mix = load_json(bench_dir / "mixes" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", cells)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if m["moves"] in moved
             and cell in m.get("workloads", cells)]
    return {"cell": w, "config": config, "mix": mix, "end_to_end": e2e,
            "per_layer": layer, "bench_dir": bench_dir}


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(root: pathlib.Path, cell: str, seed: int, seconds: float,
        trace: bool, device=None, t_start: float | None = None,
        controls: tuple = (), solver: dict | None = None,
        log=print) -> dict:
    """One run; returns the result line's object.  ``device=None`` is the
    CUDA card; the tests pass ``"cpu"``.  ``controls`` adds, under
    ``"control"``, the verdict and numbers of the same window's answers
    under each named control of the drivers' ``check``: ``"float32"``
    puts the reference's float32 placements in the program's place,
    ``"primal_bound"`` the program's primal objective in the place of its
    lower bound.  ``solver`` replaces settings of the mix's solver (a
    control run of the program with its guarantee loosened).  Raises
    RuntimeError, and gives no line, where a module of JAX or the JAX
    package is loaded once everything of the run has been read."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = cell_spec(pathlib.Path(root), cell)
    mix, bench_dir = spec["mix"], spec["bench_dir"]
    if solver:
        mix["engine"] = dict(mix["engine"],
                             solver=dict(mix["engine"]["solver"], **solver))
    on_card = device is None or torch.device(device).type == "cuda"
    drv = driver_class(bench_dir, mix["driver"])(
        spec["config"], mix, seed, device, bench_dir)
    drv.warm()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    summary = None
    with contextlib.ExitStack() as stack:
        if trace:
            from . import trace as tr

            stack.enter_context(tr.spans())
            prof = stack.enter_context(tr.profiler())
            stack.enter_context(torch.profiler.record_function(
                tr.WINDOW_SPAN))
        t0 = time.perf_counter()
        deadline, steps, units = t0 + seconds, 0, 0
        while steps < mix["max_steps"] and (
                steps < mix["min_steps"] or time.perf_counter() < deadline):
            t1 = time.perf_counter()
            units += drv.step(steps)
            if on_card:
                torch.cuda.synchronize()
            rec = drv.records[-1]
            log(f"step {steps}: {time.perf_counter() - t1:.4f} s, lp "
                f"{rec['lp_s']:.4f} s, place {rec['place_s']:.4f} s",
                file=sys.stderr)
            steps += 1
        window_s = time.perf_counter() - t0
    if trace:
        summary = tr.summarize(prof)
        del prof
    if steps == mix["max_steps"] and time.perf_counter() < deadline:
        log(f"the window ran out of its {steps} drawn steps before "
            f"{seconds} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    drv.close()
    if on_card:
        torch.cuda.empty_cache()

    drv.work()
    ctx = {"cell": spec["cell"], "config": spec["config"], "mix": mix,
           "setup_s": setup_s, "window_s": window_s, "steps": steps,
           "units": units, "records": drv.records, "trace": summary}
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        value = reader(bench_dir, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    from .check import verdict

    numbers = drv.check()
    ok, checks = verdict(numbers, mix["limits"])
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": ok, "attempted": units, "failed": drv.failed(),
            "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = window_s
        line["breakdown"] = summary["breakdown"]
    if controls:
        line["control"] = {"numbers": numbers}
        for name in controls:
            c_ok, c_checks = verdict(drv.check(control=name), mix["limits"])
            line["control"][name] = {"correct": c_ok, "checks": c_checks}
    line["checks"] = checks
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: "
                           f"{found}")
    return line

