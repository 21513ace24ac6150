"""Versioned checkpoint/recovery for ``RightsizingService``.

A snapshot is a directory holding two files:

  * ``manifest.json`` — version tag, the frozen ``ServiceConfig``, all
    scalar/structured state (tick counter, per-fleet plan costs and
    scale history, the event/shed/quarantine logs, tick records, retry
    bookkeeping, queue metadata), and a SHA-256 checksum of the array
    blob;
  * ``arrays.npz`` — every numpy array: per-fleet problems, task ids,
    adopted plans, the cropped warm ``PDHGState`` (x, y) with its
    id/slot alignment keys, solutions, pending-request payloads, and
    the telemetry vectors.

Floats that feed the parity gates (plan costs, the proposed-cost
accumulator, warm step sizes) ride in the JSON manifest, which
round-trips Python floats exactly (``repr`` precision); arrays ride in
npz losslessly.  A restored service therefore resumes **bit-identical**:
replaying the rest of a trace after ``restore`` adopts exactly the
plans the uninterrupted replay would have, and warm lanes stay warm
across the restart boundary — the crash-and-recover CI gate holds both.

Queue timestamps are rebased: ``time.perf_counter`` origins are
process-local, so each pending request's *age* is snapshotted and its
submission time is reconstructed against the restoring process's
clock.  Downtime is excluded from re-plan latency by construction.

Corruption (a torn write, bit rot) surfaces as ``SnapshotError`` at
restore time via the manifest checksum — never as silently-wrong fleet
state; ``serve.faults.corrupt_snapshot`` exercises that path in tests.

Ported from ``repro.serve.snapshot`` with the same format, version, keys and
checksum: a snapshot written by either package restores in the other, which
is how a live reference service moves into the port.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np

from ..core.constraints import TaskConstraints
from ..core.problem import NodeTypes, Problem
from ..core.solution import Solution

from .config import ServiceConfig
from .queue import PendingRequest, Request, ShedEvent
from .scale import ScaleEvent

__all__ = ["SNAPSHOT_VERSION", "SnapshotError", "save_snapshot",
           "restore_service"]

SNAPSHOT_VERSION = 1

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


class SnapshotError(RuntimeError):
    """A snapshot could not be read back: missing files, version
    mismatch, checksum failure, or undecodable manifest."""


def _sanitize(obj):
    """JSON-safe copy of free-form metadata (numpy scalars -> python,
    everything else -> repr string)."""
    return json.loads(json.dumps(obj, default=str))


def _request_entry(req: Request, arrays: dict, prefix: str) -> dict:
    """Manifest entry + array blobs for one ``Request``."""
    entry = {"fleet": req.fleet, "kind": req.kind, "T": req.T,
             "ids": None if req.ids is None else [int(i) for i in req.ids],
             "factor": req.factor, "deadline_s": req.deadline_s,
             "affinity": req.affinity,
             "anti_affinity": req.anti_affinity,
             "exclusive": req.exclusive,
             "deadline": req.deadline,
             "has_arrays": req.dem is not None,
             "has_node_types": req.node_types is not None}
    if req.dem is not None:
        arrays[f"{prefix}/dem"] = np.asarray(req.dem)
        arrays[f"{prefix}/start"] = np.asarray(req.start)
        arrays[f"{prefix}/end"] = np.asarray(req.end)
    if req.node_types is not None:
        entry["node_names"] = list(req.node_types.names)
        arrays[f"{prefix}/cap"] = np.asarray(req.node_types.cap)
        arrays[f"{prefix}/cost"] = np.asarray(req.node_types.cost)
    return entry


def _request_from(entry: dict, arrays, prefix: str) -> Request:
    node_types = None
    if entry["has_node_types"]:
        node_types = NodeTypes(cap=arrays[f"{prefix}/cap"],
                               cost=arrays[f"{prefix}/cost"],
                               names=tuple(entry["node_names"]))
    return Request(
        fleet=entry["fleet"], kind=entry["kind"],
        dem=arrays[f"{prefix}/dem"] if entry["has_arrays"] else None,
        start=arrays[f"{prefix}/start"] if entry["has_arrays"] else None,
        end=arrays[f"{prefix}/end"] if entry["has_arrays"] else None,
        node_types=node_types,
        T=None if entry["T"] is None else int(entry["T"]),
        ids=None if entry["ids"] is None else tuple(entry["ids"]),
        factor=entry["factor"], deadline_s=entry["deadline_s"],
        # .get keeps pre-constraint snapshots restorable
        affinity=entry.get("affinity"),
        anti_affinity=entry.get("anti_affinity"),
        exclusive=entry.get("exclusive"),
        deadline=entry.get("deadline"))


def save_snapshot(service, path: str) -> dict:
    """Checkpoint ``service`` into directory ``path`` (created if
    needed); returns the manifest dict.  Writes are staged through
    temporary names so a crash mid-snapshot never leaves a manifest
    pointing at a half-written blob."""
    os.makedirs(path, exist_ok=True)
    now_s = time.perf_counter()
    arrays: dict[str, np.ndarray] = {}

    fleets = []
    for i, (name, st) in enumerate(service._fleets.items()):
        p = st.problem
        entry = {
            "name": name,
            "T": int(p.T),
            "node_names": list(p.node_types.names),
            "next_id": int(st.next_id),
            "plan_cost": float(st.plan_cost),
            "last_scale_in_tick": int(st.last_scale_in_tick),
            "has_plan": st.plan is not None,
            "has_warm": st.warm is not None,
            "has_solution": st.solution is not None,
            "has_constraints": p.constraints is not None,
        }
        arrays[f"f{i}/dem"] = p.dem
        arrays[f"f{i}/start"] = p.start
        arrays[f"f{i}/end"] = p.end
        if p.constraints is not None:
            c = p.constraints
            entry["affinity_names"] = list(c.affinity_names)
            entry["anti_names"] = list(c.anti_names)
            arrays[f"f{i}/c_deadline"] = c.deadline
            arrays[f"f{i}/c_affinity"] = c.affinity
            arrays[f"f{i}/c_anti"] = c.anti_affinity
            arrays[f"f{i}/c_exclusive"] = c.exclusive
            arrays[f"f{i}/c_max_width"] = c.max_width
            arrays[f"f{i}/c_serial_frac"] = c.serial_frac
        arrays[f"f{i}/cap"] = p.node_types.cap
        arrays[f"f{i}/cost"] = p.node_types.cost
        arrays[f"f{i}/ids"] = st.ids
        if st.plan is not None:
            arrays[f"f{i}/plan"] = np.asarray(st.plan)
        if st.warm is not None:
            entry["warm_eta"] = st.warm.eta  # None or exact float
            entry["warm_omega"] = st.warm.omega
            arrays[f"f{i}/warm_x"] = st.warm.x
            arrays[f"f{i}/warm_y"] = st.warm.y
            arrays[f"f{i}/warm_ids"] = st.warm.ids
            arrays[f"f{i}/warm_kept"] = st.warm.kept
        if st.solution is not None:
            entry["solution_meta"] = _sanitize(st.solution.meta)
            arrays[f"f{i}/sol_node_type"] = st.solution.node_type
            arrays[f"f{i}/sol_assign"] = st.solution.assign
        fleets.append(entry)

    seq, pending = service.queue.dump()
    queue_items = []
    for j, item in enumerate(pending):
        entry = _request_entry(item.request, arrays, f"q{j}")
        entry["seq"] = int(item.seq)
        # perf_counter origins are process-local: persist the age, not
        # the raw timestamp (restore rebases onto its own clock)
        entry["age_s"] = float(max(0.0, now_s - item.submitted_s))
        queue_items.append(entry)

    arrays["t/latencies"] = np.asarray(service._latencies, dtype=float)
    for mode, vals in service._iters.items():
        arrays[f"t/iters_{mode}"] = np.asarray(vals, dtype=np.int64)
    arrays["t/converged"] = np.asarray(service._converged, dtype=bool)

    blob_path = os.path.join(path, _ARRAYS)
    tmp = blob_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, blob_path)
    with open(blob_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()

    manifest = {
        "version": SNAPSHOT_VERSION,
        "arrays_sha256": digest,
        "config": dataclasses.asdict(service.config),
        "tick": service._tick,
        "proposed_cost": service._proposed_cost,
        "retries": service._retries,
        "deadline_misses": service._deadline_misses,
        "attempts": {str(k): int(v)
                     for k, v in service._attempts.items()},
        "fleets": fleets,
        "queue": {"seq": int(seq), "items": queue_items},
        "events": [e.to_dict() for e in service.events],
        "shed_events": [e.to_dict() for e in service.shed_events],
        "quarantined": [q.to_dict() for q in service.quarantined],
        "ticks": [t.to_dict() for t in service.ticks],
    }
    manifest_path = os.path.join(path, _MANIFEST)
    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, manifest_path)
    return manifest


def _load(path: str):
    """Read and integrity-check a snapshot directory; returns
    ``(manifest, arrays)`` or raises ``SnapshotError``."""
    manifest_path = os.path.join(path, _MANIFEST)
    blob_path = os.path.join(path, _ARRAYS)
    for p in (manifest_path, blob_path):
        if not os.path.exists(p):
            raise SnapshotError(
                f"snapshot at {path!r} is missing {os.path.basename(p)}")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise SnapshotError(
            f"snapshot manifest at {manifest_path!r} is not valid "
            f"JSON ({e}) — the checkpoint is corrupt") from e
    version = manifest.get("version")
    if version != SNAPSHOT_VERSION:
        raise SnapshotError(
            f"snapshot version {version!r} is not supported (this "
            f"build reads version {SNAPSHOT_VERSION})")
    with open(blob_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != manifest.get("arrays_sha256"):
        raise SnapshotError(
            f"snapshot array blob at {blob_path!r} fails its checksum "
            f"(manifest {manifest.get('arrays_sha256')!r} != blob "
            f"{digest!r}) — the checkpoint is corrupt")
    try:
        arrays = dict(np.load(blob_path, allow_pickle=False))
    except Exception as e:  # zipfile/npy format errors
        raise SnapshotError(
            f"snapshot array blob at {blob_path!r} failed to load "
            f"({e})") from e
    return manifest, arrays


def restore_service(path: str, engine=None, config=None, faults=None,
                    device=None):
    """Rebuild a ``RightsizingService`` from ``save_snapshot`` output.

    ``engine`` defaults to the service's default engine (snapshots
    capture fleet/queue/telemetry state, not engine internals — pass
    the same engine configuration the crashed service ran for identical
    resumed behavior).  ``config`` overrides the snapshotted
    ``ServiceConfig``; ``faults`` re-attaches an injection harness;
    ``device`` places the default engine (None = the CUDA card).
    """
    from .service import (QuarantineRecord, RightsizingService,
                          TickRecord, _FleetState, _LaneState)

    manifest, arrays = _load(path)
    if config is None:
        config = ServiceConfig(**manifest["config"])
    svc = RightsizingService(engine=engine, config=config, faults=faults,
                             device=device)

    for i, entry in enumerate(manifest["fleets"]):
        node_types = NodeTypes(cap=arrays[f"f{i}/cap"],
                               cost=arrays[f"f{i}/cost"],
                               names=tuple(entry["node_names"]))
        constraints = None
        if entry.get("has_constraints"):
            constraints = TaskConstraints(
                deadline=arrays[f"f{i}/c_deadline"],
                affinity=arrays[f"f{i}/c_affinity"],
                anti_affinity=arrays[f"f{i}/c_anti"],
                exclusive=arrays[f"f{i}/c_exclusive"],
                max_width=arrays[f"f{i}/c_max_width"],
                serial_frac=arrays[f"f{i}/c_serial_frac"],
                affinity_names=tuple(entry["affinity_names"]),
                anti_names=tuple(entry["anti_names"]))
        problem = Problem(dem=arrays[f"f{i}/dem"],
                          start=arrays[f"f{i}/start"],
                          end=arrays[f"f{i}/end"],
                          node_types=node_types, T=int(entry["T"]),
                          constraints=constraints)
        st = _FleetState(problem=problem, ids=arrays[f"f{i}/ids"],
                         next_id=int(entry["next_id"]))
        st.plan_cost = float(entry["plan_cost"])
        st.last_scale_in_tick = int(entry["last_scale_in_tick"])
        if entry["has_plan"]:
            st.plan = arrays[f"f{i}/plan"]
        if entry["has_warm"]:
            eta = entry["warm_eta"]
            # snapshots older than the primal weight have none: .get keeps them
            # restorable (the lane just re-adapts omega from 1)
            om = entry.get("warm_omega")
            st.warm = _LaneState(
                x=arrays[f"f{i}/warm_x"], y=arrays[f"f{i}/warm_y"],
                eta=None if eta is None else float(eta),
                omega=None if om is None else float(om),
                ids=arrays[f"f{i}/warm_ids"],
                kept=arrays[f"f{i}/warm_kept"])
        if entry["has_solution"]:
            st.solution = Solution(
                node_type=arrays[f"f{i}/sol_node_type"],
                assign=arrays[f"f{i}/sol_assign"],
                meta=entry.get("solution_meta", {}))
        svc._fleets[entry["name"]] = st

    now_s = time.perf_counter()
    pending = []
    for j, entry in enumerate(manifest["queue"]["items"]):
        pending.append(PendingRequest(
            seq=int(entry["seq"]),
            submitted_s=now_s - float(entry["age_s"]),
            request=_request_from(entry, arrays, f"q{j}")))
    svc.queue.load(manifest["queue"]["seq"], pending)

    svc._tick = int(manifest["tick"])
    svc._proposed_cost = float(manifest["proposed_cost"])
    svc._retries = int(manifest["retries"])
    svc._deadline_misses = int(manifest["deadline_misses"])
    svc._attempts = {int(k): int(v)
                     for k, v in manifest["attempts"].items()}
    svc.events = [ScaleEvent.from_dict(d) for d in manifest["events"]]
    svc.shed_events = [ShedEvent.from_dict(d)
                       for d in manifest["shed_events"]]
    svc.quarantined = [QuarantineRecord.from_dict(d)
                       for d in manifest["quarantined"]]
    svc.ticks = [TickRecord.from_dict(d) for d in manifest["ticks"]]
    svc._latencies = [float(v) for v in arrays["t/latencies"]]
    svc._iters = {mode: [int(v) for v in arrays[f"t/iters_{mode}"]]
                  for mode in ("warm", "cold", "drift", "admit")}
    svc._converged = [bool(v) for v in arrays["t/converged"]]
    return svc
