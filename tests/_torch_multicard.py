"""The ranks of a gloo world on the CPU, for
``tests/test_torch_multicard_train.py``.  Torch and the port only, no JAX,
so a spawned rank starts quickly.

``rank_main`` is the function ``torch.multiprocessing.spawn`` runs in every
rank: it joins the world through a ``FileStore``, then

* runs ``compressed_psum`` over the "pod" dimension of a one-dimensional
  mesh of every rank, on each rank's own inputs (``psum_inputs``), and
* restores a plain checkpoint onto that mesh with ``Shard(0)`` and
  ``Replicate()`` leaves, saves the restored tree with ``save`` and with
  ``Checkpointer``,

writing what it got to ``rank{r}.pt`` under the output directory.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch.sharding.ctx import use_mesh
from repro_torch.train import checkpoint, compression

# flat sizes that are not multiples of 256, and a shape of two dimensions
PSUM_SHAPES = ((1000,), (3, 300), (7, 37))
PSUM_DTYPES = ("float32", "bfloat16")


def psum_inputs(rank: int) -> list[tuple[np.ndarray, np.ndarray, str]]:
    """(g as float32, err, dtype) per case for ``rank``: bfloat16 cases hold
    values a bfloat16 represents exactly, so either package's cast of the
    float32 array is exact."""
    rng = np.random.default_rng(100 + rank)
    out = []
    for dtype in PSUM_DTYPES:
        for shape in PSUM_SHAPES:
            g = rng.standard_normal(shape).astype(np.float32)
            if dtype == "bfloat16":
                g = torch.from_numpy(g).bfloat16().float().numpy()
            err = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
            out.append((g, err, dtype))
    return out


def checkpoint_tree() -> dict:
    """The tree the checkpoint round trip saves: leaves whose first
    dimension two ranks split evenly, and one they do not."""
    g = torch.Generator().manual_seed(7)
    return {"w": torch.randn((6, 5), generator=g),
            "opt": {"m": torch.randn((4, 3), generator=g).bfloat16(),
                    "step": torch.tensor([3], dtype=torch.int32)},
            "b": torch.randn((5,), generator=g)}


def rank_main(rank: int, world: int, store: str, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = DeviceMesh("cpu", list(range(world)), mesh_dim_names=("pod",))
        got: dict = {"psum": []}
        with use_mesh(mesh):
            for g, err, dtype in psum_inputs(rank):
                deq, new_err = compression.compressed_psum(
                    torch.from_numpy(g).to(getattr(torch, dtype)),
                    torch.from_numpy(err), "pod")
                got["psum"].append((deq.float(), new_err, str(deq.dtype)))
        like = checkpoint_tree()
        shard, rep = (mesh, [Shard(0)]), (mesh, [Replicate()])
        tree, step = checkpoint.restore(
            os.path.join(root, "plain"), like, device="cpu",
            shardings={"w": shard, "opt": {"m": shard, "step": rep},
                       "b": None})
        got["step"] = step
        got["local"] = {"w": tree["w"].to_local(),
                        "m": tree["opt"]["m"].to_local(),
                        "step": tree["opt"]["step"].to_local(),
                        "b": tree["b"]}
        got["placements"] = [str(tree["w"].placements),
                             str(tree["opt"]["step"].placements)]
        checkpoint.save(os.path.join(root, "sharded"), tree, 2)
        # after save's barrier the file is in place on every rank
        got["saved_seen"] = checkpoint.latest_step(
            os.path.join(root, "sharded"))
        ck = checkpoint.Checkpointer(os.path.join(root, "async"))
        ck.save_async(tree, 3)
        ck.close()
        got["records"] = ck.records
        torch.save(got, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
