"""LM-job -> TL-task adapter, ported from ``repro.workload.jobs``: the same
tasks, constraints and ``Problem`` from the same schedule.

A *job* is "run (arch x shape) during a time window" — e.g. "train
gemma2-9b nightly 00-06", "serve qwen2.5-3b 08-18".  Its resource demand
vector (chips, HBM GB, host GB) comes from a total memory footprint per
(arch, shape): read from dry-run records (``*__16x16.json``: per-device
argument + temp + output bytes times devices) when a directory of them is
given and present, else from the built-in table ``BUILTIN_DEMANDS``.  Jobs
wider than the largest slice SKU are split into per-pod tasks with
identical windows (a data-parallel pod is the unit of placement).

Node-types are the slice SKUs of ``TPU_SKUS``: a planning catalogue of chip
counts with HBM and host memory per chip and an hourly price per chip.
These constants are the workload's input data, the catalogue this planner
buys from; none of them is a measurement of any chip.  Cost is sublinear in
size (bigger slices are cheaper per chip): the heterogeneous cost model of
paper §VI-C with e < 1.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os

import numpy as np

from ..core import NodeTypes, Problem, TaskConstraints

__all__ = ["TPU_SKUS", "Job", "DEFAULT_SCHEDULE", "jobs_from_dryrun",
           "fleet_problem", "BUILTIN_DEMANDS"]

# the catalogue's per-chip memory and hourly price (input data)
HBM_PER_CHIP_GB = 16.0
HOST_PER_CHIP_GB = 32.0
CHIP_HOUR_USD = 1.2

# (name, chips) — host/HBM follow the chip count; cost is sublinear in
# size (a volume discount, exponent e=0.92)
_SKU_CHIPS = [8, 16, 32, 64, 128, 256]


def _mk_skus() -> NodeTypes:
    cap = np.array([[c, c * HBM_PER_CHIP_GB, c * HOST_PER_CHIP_GB]
                    for c in _SKU_CHIPS], dtype=float)
    cost = np.array([CHIP_HOUR_USD * (c ** 0.92) for c in _SKU_CHIPS])
    names = tuple(f"v5e-{c}" for c in _SKU_CHIPS)
    return NodeTypes(cap=cap, cost=cost, names=names)


TPU_SKUS = _mk_skus()


@dataclasses.dataclass(frozen=True)
class Job:
    """One scheduled workload; optional hard constraints ride along.

    ``deadline_h`` is an inclusive finish hour (train jobs that must
    complete before the business day); ``exclusive`` reserves whole
    slices (isolation-sensitive serving); ``affinity``/``anti_affinity``
    are named groups (co-locate a tower of services / spread replicas);
    ``max_width``/``serial_frac`` allow widening a deadlined job per the
    Amdahl law.  Defaults are all vacuous, keeping ``DEFAULT_SCHEDULE``
    problems byte-stable.
    """

    name: str
    arch: str
    shape: str
    start_h: int
    end_h: int          # inclusive hour slot
    deadline_h: int | None = None
    exclusive: bool = False
    affinity: str | None = None
    anti_affinity: str | None = None
    max_width: int = 1
    serial_frac: float = 1.0


# a plausible production day: nightly training, business-hours serving,
# evening batch inference, always-on light service
DEFAULT_SCHEDULE = (
    Job("nightly-train-gemma2", "gemma2-9b", "train_4k", 0, 5),
    Job("nightly-train-olmoe", "olmoe-1b-7b", "train_4k", 0, 5),
    Job("nightly-train-rwkv", "rwkv6-7b", "train_4k", 1, 6),
    Job("day-serve-qwen", "qwen2.5-3b", "decode_32k", 8, 17),
    Job("day-serve-gemma3", "gemma3-1b", "decode_32k", 8, 17),
    Job("day-serve-vl", "qwen2-vl-2b", "decode_32k", 9, 18),
    Job("eve-batch-whisper", "whisper-small", "prefill_32k", 18, 22),
    Job("eve-batch-granite", "granite-34b", "prefill_32k", 18, 23),
    Job("allday-recgemma", "recurrentgemma-9b", "long_500k", 0, 23),
    Job("peak-kimi-serve", "kimi-k2-1t-a32b", "decode_32k", 10, 15),
)

# per-(arch, shape) total memory footprints (GB across the whole job),
# used where no dry-run record is present
BUILTIN_DEMANDS = {
    ("gemma2-9b", "train_4k"): 1600.0,
    ("olmoe-1b-7b", "train_4k"): 1100.0,
    ("rwkv6-7b", "train_4k"): 1200.0,
    ("qwen2.5-3b", "decode_32k"): 700.0,
    ("gemma3-1b", "decode_32k"): 300.0,
    ("qwen2-vl-2b", "decode_32k"): 500.0,
    ("whisper-small", "prefill_32k"): 150.0,
    ("granite-34b", "prefill_32k"): 900.0,
    ("recurrentgemma-9b", "long_500k"): 250.0,
    ("kimi-k2-1t-a32b", "decode_32k"): 4000.0,
}


def _dryrun_bytes(dryrun_dir: str) -> dict:
    """(arch, shape) -> total program bytes, from 16x16 artifacts."""
    out = {}
    for path in glob.glob(os.path.join(dryrun_dir, "*__16x16.json")):
        with open(path) as f:
            rec = json.load(f)
        per_dev = (rec.get("argument_size_in_bytes", 0)
                   + rec.get("temp_size_in_bytes", 0)
                   + rec.get("output_size_in_bytes", 0))
        out[(rec["arch"], rec["shape"])] = per_dev * rec["devices"]
    return out


def jobs_from_dryrun(schedule=DEFAULT_SCHEDULE,
                     dryrun_dir: str = "results/dryrun",
                     util: float = 0.85):
    """Expand jobs into TL tasks: demands (chips, HBM GB, host GB)."""
    measured = _dryrun_bytes(dryrun_dir)
    max_chips = max(_SKU_CHIPS)
    tasks = []
    for job in schedule:
        key = (job.arch, job.shape)
        if key in measured:
            total_gb = measured[key] / 1e9
            src = "dryrun"
        else:
            total_gb = BUILTIN_DEMANDS.get(key, 500.0)
            src = "builtin"
        chips = max(1, math.ceil(total_gb / (HBM_PER_CHIP_GB * util)))
        n_shards = max(1, math.ceil(chips / max_chips))
        per_shard = math.ceil(chips / n_shards)
        for s in range(n_shards):
            tasks.append({
                "name": f"{job.name}/{s}" if n_shards > 1 else job.name,
                "dem": np.array([
                    per_shard,
                    per_shard * HBM_PER_CHIP_GB * 0.95,
                    per_shard * HOST_PER_CHIP_GB * 0.5,
                ]),
                "start": job.start_h,
                "end": job.end_h,
                "source": src,
                # shards inherit the job's constraints verbatim (a job's
                # pods share its deadline, isolation, and groups)
                "deadline": job.deadline_h,
                "exclusive": job.exclusive,
                "affinity": job.affinity,
                "anti_affinity": job.anti_affinity,
                "max_width": job.max_width,
                "serial_frac": job.serial_frac,
            })
    return tasks


def _constraints_from_tasks(tasks) -> TaskConstraints | None:
    """``TaskConstraints`` for expanded task dicts, or None when every
    job carried only the vacuous defaults."""
    if all(t.get("deadline") is None and not t.get("exclusive")
           and t.get("affinity") is None and t.get("anti_affinity") is None
           and t.get("max_width", 1) == 1 for t in tasks):
        return None
    deadlines = {i: t["deadline"] for i, t in enumerate(tasks)
                 if t.get("deadline") is not None}
    affinity: dict[str, list[int]] = {}
    anti: dict[str, list[int]] = {}
    for i, t in enumerate(tasks):
        if t.get("affinity") is not None:
            affinity.setdefault(t["affinity"], []).append(i)
        if t.get("anti_affinity") is not None:
            anti.setdefault(t["anti_affinity"], []).append(i)
    widths = {i: (t["max_width"], t.get("serial_frac", 1.0))
              for i, t in enumerate(tasks) if t.get("max_width", 1) > 1}
    return TaskConstraints.from_groups(
        len(tasks), deadlines=deadlines, affinity=affinity,
        anti_affinity=anti,
        exclusive=[i for i, t in enumerate(tasks) if t.get("exclusive")],
        widths=widths)


def fleet_problem(schedule=DEFAULT_SCHEDULE,
                  dryrun_dir: str = "results/dryrun") -> tuple[Problem, list]:
    tasks = jobs_from_dryrun(schedule, dryrun_dir)
    dem = np.stack([t["dem"] for t in tasks])
    start = np.array([t["start"] for t in tasks])
    end = np.array([t["end"] for t in tasks])
    problem = Problem(dem=dem, start=start, end=end, node_types=TPU_SKUS,
                      T=24, constraints=_constraints_from_tasks(tasks))
    return problem, tasks
