"""Checkpointing: atomic step-tagged saves, async commit, keep-k GC, and
restore onto any device.

Ported from ``repro.train.checkpoint`` with another container.  The
reference writes one zstd-compressed msgpack file; neither package is in the
port's installation, so a checkpoint here is one file holding the same
entries (``{"step", "tree": {path: {"dtype", "shape", data}}}``) as a JSON
header followed by the raw bytes of each leaf:

    b"RTCKPT1\\n" | header length (8 bytes, little-endian) | header JSON |
    leaf bytes, back to back, each at its ``offset`` from the end of the
    header

The header's entries give ``dtype`` (a torch dtype name, ``bfloat16``
included), ``shape``, ``offset`` and ``nbytes``.  Leaves are written and
read one at a time, so a state is never held twice in host memory.  Port
checkpoints are not readable by the reference, nor the reverse: weights
cross the packages through ``convert``, not through checkpoints.

A tree is a nested dict, tuple or list whose leaves are tensors, and may
hold a ``models.Model``, whose leaves are its named parameters.
``restore`` returns a new tree on a device of the caller's choosing (the
card by default); with ``shardings`` it places each leaf onto a
``DeviceMesh`` that may differ from the one it was saved from, the
reference's elastic restore.  ``load`` reads into the tensors of a live
tree in place.  ``save`` and ``Checkpointer`` take ``DTensor`` leaves:
every rank gathers each one (``full_tensor``, a collective) and rank 0
writes, so the file holds whole tensors whatever mesh they were sharded on.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import struct
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from ..device import resolve_device
from ..models import Model

__all__ = ["save", "restore", "load", "latest_step", "Checkpointer"]

_STEP_RE = re.compile(r"^step_(\d+)\.ckpt$")
_MAGIC = b"RTCKPT1\n"


def _leaves(tree, prefix: str = ""):
    """(path, tensor) of every leaf, in a fixed order."""
    if isinstance(tree, Model):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix.rstrip("/"), tree
    else:
        raise TypeError(f"checkpoint leaf {prefix!r} is a {type(tree)}")


def _like(tree, device):
    """A tree of the structure of ``tree`` with new uninitialized leaves
    on ``device``."""
    if isinstance(tree, Model):
        return Model(tree.cfg, device)
    if isinstance(tree, dict):
        return {k: _like(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_like(v, device) for v in tree)
    return torch.empty(tree.shape, dtype=tree.dtype, device=device)


def _bytes(t: torch.Tensor):
    """A host tensor's bytes as a flat uint8 numpy view."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def _whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a leaf: a ``DTensor`` is gathered (a collective
    every rank of its mesh makes, leaf by leaf in the same order)."""
    t = t.detach()
    return t.full_tensor() if isinstance(t, DTensor) else t


def _writer() -> bool:
    """Whether this process writes: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(path: str, tree, step: int) -> str:
    """Atomic save: write tmp, fsync, rename.  Leaves on a card are copied
    to the host one at a time.  ``DTensor`` leaves are gathered on every
    rank and rank 0 writes; every rank returns once the file is in place."""
    leaves = list(_leaves(tree))
    fname = os.path.join(path, f"step_{step}.ckpt")
    if _writer():
        _write(path, fname, leaves, step)
    else:
        for _key, t in leaves:
            _whole(t)  # the writer's gathers
    if dist.is_initialized() and any(isinstance(t, DTensor)
                                     for _key, t in leaves):
        dist.barrier()
    return fname


def _write(path: str, fname: str, leaves: list, step: int) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = fname + ".tmp"
    entries, off = {}, 0
    for key, t in leaves:
        nbytes = t.numel() * t.element_size()
        entries[key] = {"dtype": str(t.dtype).removeprefix("torch."),
                        "shape": list(t.shape), "offset": off,
                        "nbytes": nbytes}
        off += nbytes
    header = json.dumps({"step": step, "tree": entries}).encode()
    with open(tmp, "wb") as f:
        f.write(_MAGIC + struct.pack("<Q", len(header)) + header)
        for _key, t in leaves:
            f.write(_bytes(_whole(t).cpu()))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fname)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := _STEP_RE.match(f))]
    return max(steps) if steps else None


def _read_into(path: str, tree, step: int | None) -> int:
    """Fill every leaf of ``tree`` from the checkpoint; returns its step."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    fname = os.path.join(path, f"step_{step}.ckpt")
    with open(fname, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{fname} is not a checkpoint of this package")
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = f.tell()
        with torch.no_grad():
            for key, t in _leaves(tree):
                ent = header["tree"].get(key)
                if ent is None:
                    raise KeyError(f"checkpoint missing leaf {key}")
                dtype = getattr(torch, ent["dtype"])
                if dtype != t.dtype or list(t.shape) != ent["shape"]:
                    raise ValueError(
                        f"leaf {key}: checkpoint {ent['dtype']} "
                        f"{ent['shape']}, tree {t.dtype} {list(t.shape)}")
                host = torch.empty(ent["nbytes"], dtype=torch.uint8)
                f.seek(base + ent["offset"])
                if f.readinto(host.numpy()) != ent["nbytes"]:
                    raise ValueError(f"{fname} is truncated at leaf {key}")
                t.copy_(host.view(dtype).reshape(t.shape))
    return header["step"]


def _is_spec(s) -> bool:
    return (isinstance(s, tuple) and len(s) == 2
            and isinstance(s[0], DeviceMesh))


def _specs(like, shardings, prefix: str = ""):
    """(path, None or (mesh, placements)) of every leaf of ``like``, read
    from the matching tree ``shardings``; ``ValueError`` where they do not
    match."""
    if shardings is None or _is_spec(shardings):
        if isinstance(like, Model):
            raise ValueError(
                f"shardings for {prefix or 'the tree'!r}: a Model's leaves "
                f"take no shardings; restore dict(model.named_parameters())")
        for key, _t in _leaves(like, prefix):
            yield key, shardings
        return
    if isinstance(like, dict) and isinstance(shardings, dict) \
            and shardings.keys() == like.keys():
        for k, v in like.items():
            yield from _specs(v, shardings[k], f"{prefix}{k}/")
    elif isinstance(like, (tuple, list)) \
            and isinstance(shardings, (tuple, list)) \
            and len(shardings) == len(like):
        for i, v in enumerate(like):
            yield from _specs(v, shardings[i], f"{prefix}{i}/")
    else:
        raise ValueError(
            f"shardings do not match the tree at {prefix or 'its root'!r}: "
            f"a {type(shardings).__name__} against a "
            f"{type(like).__name__}")


def _placed(tree, specs: dict, prefix: str = ""):
    """``tree`` with each leaf that has a (mesh, placements) spec
    distributed onto its mesh."""
    if isinstance(tree, Model):
        return tree  # its leaves take no spec (``_specs``)
    if isinstance(tree, dict):
        return {k: _placed(v, specs, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_placed(v, specs, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    spec = specs[prefix.rstrip("/")]
    if spec is None:
        return tree
    mesh, placements = spec
    return distribute_tensor(tree, mesh, list(placements))


def restore(path: str, like, step: int | None = None, device=None,
            shardings=None):
    """Restore into a new tree of the structure of ``like`` on ``device``
    (None = the CUDA card).  Returns (tree, step).

    ``shardings`` is a tree matching ``like`` (a ``None`` or a
    ``(DeviceMesh, placements)`` pair at a leaf, or in place of a whole
    subtree) that re-places leaves onto a possibly different mesh, the
    elastic-rescale path: a leaf with a pair comes back as a ``DTensor``
    from ``distribute_tensor`` (every rank of the mesh reads the file and
    calls it), a ``None`` leaf on ``device``.  A tree that does not match
    raises ``ValueError``."""
    dev = resolve_device(device)
    if shardings is None:
        tree = _like(like, dev)
        return tree, _read_into(path, tree, step)
    specs = dict(_specs(like, shardings))
    tree = _like(like, dev)
    for key, t in _leaves(tree):
        spec = specs[key]
        if spec is not None and t.device.type != spec[0].device_type:
            raise ValueError(
                f"leaf {key}: a mesh of {spec[0].device_type} devices "
                f"cannot take a leaf restored to {t.device}; pass "
                f"device={spec[0].device_type!r}")
    got = _read_into(path, tree, step)
    return _placed(tree, specs), got


def load(path: str, tree, step: int | None = None) -> int:
    """Read the checkpoint into the leaves of ``tree`` in place, on their
    own devices.  Returns its step."""
    return _read_into(path, tree, step)


class Checkpointer:
    """Async checkpointer: snapshot on the caller thread (host copies),
    commit (write) on a worker thread, one save in flight; keeps the
    newest ``keep`` files.  ``records`` holds one entry per committed save:
    step, bytes, snapshot and commit seconds."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self.records: list[dict] = []
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: cf.Future | None = None

    def save_async(self, tree, step: int):
        """Snapshot ``tree`` on this thread and commit it on the worker.
        ``DTensor`` leaves are gathered here on every rank (a collective);
        only rank 0 commits."""
        self.wait()  # one in flight at a time
        t0 = time.perf_counter()
        host = {k: _whole(t).to("cpu", copy=True) for k, t in _leaves(tree)}
        snapshot_s = time.perf_counter() - t0
        if _writer():
            self._pending = self._pool.submit(self._commit, host, step,
                                              snapshot_s)

    def _commit(self, host: dict, step: int, snapshot_s: float):
        t0 = time.perf_counter()
        fname = save(self.path, host, step)
        self.records.append({"step": step, "bytes": os.path.getsize(fname),
                             "snapshot_s": snapshot_s,
                             "commit_s": time.perf_counter() - t0})
        self._gc()
        return step

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for f in os.listdir(self.path)
            if (m := _STEP_RE.match(f)))
        for s in steps[: -self.keep]:
            os.remove(os.path.join(self.path, f"step_{s}.ckpt"))

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self):
        self.wait()
        self._pool.shutdown()
