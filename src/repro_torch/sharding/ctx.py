"""Ambient sharding-hint context.

Ported from ``repro.sharding.ctx``.  Model code is mesh-agnostic; launchers
establish a mesh context and the model's hot spots call
``constrain(x, 'batch', None, 'heads', None)`` with *logical* axis names.
Without a context (one card, the CPU tests) the calls are no-ops that cost
one Python check, so the same model code runs everywhere.

Logical axes:
  'batch'  -> the ('pod','data') prefix that divides the dim
  'model'  -> 'model' if it divides the dim
  'heads'  -> alias of 'model' (reads better at call sites)
  None     -> unsharded

Under a mesh, ``constrain`` redistributes a ``DTensor`` to those placements
(the reference's ``with_sharding_constraint``); a plain tensor, which the
port's DTensor code treats as replicated, passes through.
"""

from __future__ import annotations

import contextlib
import functools
import threading

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

__all__ = ["use_mesh", "constrain", "current_mesh", "hints_enabled",
           "shard_local"]

_STATE = threading.local()


def current_mesh():
    return getattr(_STATE, "mesh", None)


def hints_enabled() -> bool:
    return getattr(_STATE, "mesh", None) is not None


@contextlib.contextmanager
def use_mesh(mesh):
    """Enable sharding hints under ``mesh`` (None = disable)."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``: the reference's
    ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _resolve(axis, dim: int, sizes: dict):
    if axis is None:
        return None
    if axis == "batch":
        chosen = []
        prod = 1
        for a in ("pod", "data"):
            sz = sizes.get(a, 0)
            if sz and dim % (prod * sz) == 0:
                chosen.append(a)
                prod *= sz
        if not chosen:
            return None
        return tuple(chosen) if len(chosen) > 1 else chosen[0]
    name = "model" if axis in ("model", "heads") else axis
    sz = sizes.get(name, 0)
    return name if sz and dim % sz == 0 else None


def constrain(x, *axes):
    """``with_sharding_constraint`` with logical axes; no-op without a
    mesh context or when an axis does not divide."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"{len(axes)} axes for rank-{x.ndim} array")
    if not isinstance(x, DTensor):
        return x
    from .partitioning import named

    sizes = axis_sizes(mesh)
    spec = tuple(_resolve(a, d, sizes) for a, d in zip(axes, x.shape))
    # redistributed even where the placements already agree: the gradient
    # is held to them too, as with_sharding_constraint holds the cotangent
    return x.redistribute(mesh, named(mesh, spec))


def shard_local(fn, *args, outputs=1, **kwargs):
    """``fn(*args, **kwargs)`` run on each device's shards.

    For a function that computes every index of dimensions 0 and 2 on its
    own (attention over batch and heads, a recurrence over batch and
    channels): when the tensor arguments are DTensors with one layout,
    sharded along those dimensions only, each
    device runs ``fn`` on its local shards and the result (``outputs``
    tensors of the same rank) takes the same layout, which is exact.  The
    eager DTensor dispatch of every op inside ``fn`` is then skipped.
    Anything else (plain tensors on one card, another layout) calls ``fn``
    as it is.
    """
    first = args[0]
    if not isinstance(first, DTensor):
        return fn(*args, **kwargs)
    placements = tuple(first.placements)
    if any(not (p.is_replicate() or (p.is_shard() and p.dim in (0, 2)))
           for p in placements) or any(
               not isinstance(a, DTensor) or tuple(a.placements) != placements
               for a in args):
        return fn(*args, **kwargs)
    # one output's placements are a list; a tuple holds one per output
    out = list(placements)
    return local_map(functools.partial(fn, **kwargs),
                     out_placements=out if outputs == 1 else (out,) * outputs,
                     in_placements=tuple(list(placements) for _ in args),
                     device_mesh=first.device_mesh)(*args)
