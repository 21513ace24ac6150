"""Production mesh definition.

Ported from ``repro.launch.mesh``.  A mesh is a ``DeviceMesh`` built over
the process group that is already initialised: the reference forces 512
fake host devices before JAX starts; the port's dry-run initialises a
``"fake"`` process group of 256 or 512 ranks in one process
(``fake_world``), whose collectives move no data.  Functions, not module
constants, so importing this module touches no process group.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "fake_world"]


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks, this process
    rank 0, for the duration of the block; destroyed on exit.  Raises
    ``RuntimeError`` when a process group is already initialised."""
    # registers the "fake" backend (torch.distributed and the C++
    # FakeProcessGroup only)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(device, shape, axes) -> DeviceMesh:
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise ValueError("no process group is initialised (see fake_world)")
    world, need = dist.get_world_size(), 1
    for s in shape:
        need *= s
    if world != need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs a "
                         f"process group of {need} ranks, not {world}")
    ranks = torch.arange(need, dtype=torch.int64).reshape(shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips when ``multi_pod``.
    Axes: data (FSDP/batch), model (TP/EP), pod (pure DP, gradient sync
    over DCN).  The initialised process group must have exactly 256 (512)
    ranks: ``ValueError`` otherwise.  ``device`` names the device type the
    mesh stands for (None = the CUDA card, which must be visible)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_host_mesh(device=None) -> DeviceMesh:
    """A 1x1 ("data", "model") mesh over one device: the CUDA card (None),
    or the CPU when asked; the initialised process group must have one
    rank."""
    return _mesh(device, (1, 1), ("data", "model"))
