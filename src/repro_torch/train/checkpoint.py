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
card by default; on one card, a restore onto another device is the
reference's elastic restore, whose ``shardings=`` is not ported); ``load``
reads into the tensors of a live tree in place.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import struct
import time

import torch

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


def save(path: str, tree, step: int) -> str:
    """Atomic save: write tmp, fsync, rename.  Leaves on a card are copied
    to the host one at a time."""
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"step_{step}.ckpt")
    tmp = fname + ".tmp"
    leaves = list(_leaves(tree))
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
            f.write(_bytes(t.cpu()))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fname)
    return fname


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


def restore(path: str, like, step: int | None = None, device=None):
    """Restore into a new tree of the structure of ``like`` on ``device``
    (None = the CUDA card).  Returns (tree, step)."""
    tree = _like(like, resolve_device(device))
    return tree, _read_into(path, tree, step)


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
        self.wait()  # one in flight at a time
        t0 = time.perf_counter()
        host = {k: t.detach().to("cpu", copy=True)
                for k, t in _leaves(tree)}
        snapshot_s = time.perf_counter() - t0
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
