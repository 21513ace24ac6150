"""A copy of the benchmark at a size a CPU test run holds: the same
harness, drivers, readers and reference, with cells of a few small
instances (``tiny.fleet``, ``tinygct.fleet``, ``tinygct.forecast``)."""

from __future__ import annotations

import json
import pathlib
import shutil

ROOT = pathlib.Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "tiny": {"generator": "synthetic",
             "instance": {"n": 40, "m": 3, "D": 3, "T": 12,
                          "demand": [0.01, 0.1], "capacity": [0.2, 1.0],
                          "cost_model": "homogeneous"}},
    "tinygct": {"generator": "gct",
                "instance": {"n": 40, "m": 4, "cost_model": "gce"}},
}


def tiny_root(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout-like directory under ``tmp``: ``BENCHMARK.json`` with the
    tiny cells beside the real ones, and a copy of ``bench/``."""
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in TINY_CONFIGS.items():
        (tmp / "bench" / "configs" / f"{name}.json").write_text(
            json.dumps(dict(cfg, name=name, reduced=[], source="test")))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"bench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    # every answer of the first steps sampled, so that a fault in any lane
    # shows
    for mix, changes in (("fleet", {"fleet": 4, "max_steps": 3,
                                    "sample": 12}),
                         ("forecast", {"max_steps": 2, "sample": 16})):
        spec = json.loads((ROOT / "bench" / "mixes" / f"{mix}.json")
                          .read_text())
        spec.update(changes)
        if mix == "forecast":
            spec["plan"] = dict(spec["plan"], scenarios=8)
        (tmp / "bench" / "mixes" / f"{mix}_tiny.json").write_text(
            json.dumps(spec))
    cells = [("tiny.fleet", "tiny", "fleet_tiny"),
             ("tinygct.fleet", "tinygct", "fleet_tiny"),
             ("tinygct.forecast", "tinygct", "forecast_tiny")]
    for name, config, traffic in cells:
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            real = [w for w in m.get("workloads", ())
                    if w.split(".")[1] == traffic.split("_")[0]]
            if real:
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
