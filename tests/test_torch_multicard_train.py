"""``compressed_psum`` over a process group and ``restore(shardings=)`` on
the CPU: gloo worlds of one rank (in this process) and of two (one spawn,
``tests/_torch_multicard.py``), against ``compress_decompress``, the plain
checkpoint path and the reference on two forced host devices.

Tolerances:
  * a world of one: ``compressed_psum`` bit-equal to ``compress_decompress``
    (the sum over one participant is its own ``q * s``);
  * a world of two against the reference's ``shard_map`` over two host
    devices: the residual ``new_err`` bit-equal (the same float32
    quantization), the sum within ``2 * eps32 * sum_p |q_p * s_p|`` per
    element, plus one rounding of the output dtype (``eps(dtype) *
    |sum|``) for bfloat16: each package rounds every ``q_p * s_p`` and the
    sum of two in float32, and may fuse a product into the addition;
  * checkpoints: every value equal, at every step of plain -> ``Shard(0)``
    over two ranks -> saved -> restored onto one device, and each rank's
    shard equal to the reference's shard on that device after
    ``restore(shardings=NamedSharding(...))``.

The reference runs in a subprocess, where ``XLA_FLAGS`` can force two host
devices before JAX starts.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.ctx import use_mesh
from repro_torch.train import checkpoint, compression

from _torch_multicard import checkpoint_tree, psum_inputs, rank_main
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
EPS32 = float(np.finfo(np.float32).eps)

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.train import checkpoint as jck
    from repro.train.compression import compressed_psum
    root = sys.argv[1]
    inp = np.load(os.path.join(root, "inputs.npz"))
    mesh = Mesh(np.array(jax.devices()[:2]), ("pod",))

    def one(g, e):
        d, ne = compressed_psum(g[0], e[0], "pod")
        return d[None], ne[None]

    fn = shard_map(one, mesh=mesh, in_specs=(P("pod"), P("pod")),
                   out_specs=(P("pod"), P("pod")), check_rep=False)
    out = {}
    for i in range(int(inp["cases"])):
        dt = jnp.bfloat16 if str(inp[f"dtype{i}"]) == "bfloat16" \\
            else jnp.float32
        deq, ne = fn(jnp.asarray(inp[f"g{i}"]).astype(dt),
                     jnp.asarray(inp[f"err{i}"]))
        out[f"deq{i}"] = np.asarray(deq.astype(jnp.float32))
        out[f"err{i}"] = np.asarray(ne)
    tree = {k: inp[f"tree_{k}"] for k in ("w", "m", "step")}
    jck.save(os.path.join(root, "reference"), tree, 1)
    rows, rep = NamedSharding(mesh, P("pod")), NamedSharding(mesh, P())
    placed, step = jck.restore(os.path.join(root, "reference"), tree,
                               shardings={"w": rows, "m": rows, "step": rep})
    out["step"] = np.asarray(step)
    for k, v in placed.items():
        shards = sorted(v.addressable_shards, key=lambda s: s.device.id)
        for r, s in enumerate(shards):
            out[f"shard_{k}{r}"] = np.asarray(s.data)
    np.savez(os.path.join(root, "reference.npz"), **out)
""")


@pytest.fixture
def one_rank(tmp_path):
    """A gloo world of one rank, this process, for the test's duration."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two gloo ranks (``_torch_multicard.rank_main``) after a
    plain save of ``checkpoint_tree``; returns (directory, each rank's
    results)."""
    root = tmp_path_factory.mktemp("two_ranks")
    checkpoint.save(str(root / "plain"), checkpoint_tree(), 1)
    mp.spawn(rank_main, args=(2, str(root / "store"), str(root)), nprocs=2,
             join=True)
    return root, [torch.load(root / f"rank{r}.pt") for r in range(2)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ``compressed_psum`` under ``shard_map`` and its
    sharded restore, both over two forced host devices, on the inputs of
    ``_torch_multicard``."""
    root = tmp_path_factory.mktemp("reference")
    inputs = {"cases": len(psum_inputs(0))}
    for i, ((g0, e0, dtype), (g1, e1, _)) in enumerate(
            zip(psum_inputs(0), psum_inputs(1))):
        inputs.update({f"g{i}": np.stack([g0, g1]),
                       f"err{i}": np.stack([e0, e1]), f"dtype{i}": dtype})
    tree = checkpoint_tree()
    inputs.update({"tree_w": tree["w"].numpy(),
                   "tree_m": tree["opt"]["m"].float().numpy(),
                   "tree_step": tree["opt"]["step"].numpy()})
    np.savez(root / "inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", REFERENCE, str(root)], env=env,
                   check=True, timeout=300)
    return np.load(root / "reference.npz")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_world_of_one_is_compress_decompress(one_rank,
                                                             dtype):
    mesh = DeviceMesh("cpu", [0], mesh_dim_names=("pod",))
    with use_mesh(mesh):
        for g, err, _ in psum_inputs(0):
            g = torch.from_numpy(g).to(getattr(torch, dtype))
            err = torch.from_numpy(err)
            got, got_err = compression.compressed_psum(g, err, "pod")
            want, want_err = compression.compress_decompress(g, err)
            assert got.dtype == want.dtype == g.dtype
            assert torch.equal(got, want) and torch.equal(got_err, want_err)
        with pytest.raises(ValueError, match="no dimension 'data'"):
            compression.compressed_psum(g, err, "data")


def test_compressed_psum_two_ranks_against_reference(two_ranks, reference):
    _, ranks = two_ranks
    cases = list(zip(psum_inputs(0), psum_inputs(1)))
    for i, inputs in enumerate(cases):
        # sum_p |q_p * s_p| from each rank's own quantization
        mag = sum((compression.dequantize_int8(
            *compression.quantize_int8(torch.from_numpy(g).to(
                getattr(torch, dt)).float() + torch.from_numpy(e)),
            g.shape)).abs() for g, e, dt in inputs)
        dtype = inputs[0][2]
        for r in range(2):
            deq, new_err, name = ranks[r]["psum"][i]
            assert name == f"torch.{dtype}"
            want = torch.from_numpy(reference[f"deq{i}"][r])
            assert torch.equal(new_err, torch.from_numpy(
                reference[f"err{i}"][r])), (i, r)
            bound = 2 * EPS32 * mag
            if dtype == "bfloat16":
                bound = bound + torch.finfo(torch.bfloat16).eps * want.abs()
            assert bool(((deq - want).abs() <= bound).all()), (i, r)
        # every rank holds the same sum
        assert torch.equal(ranks[0]["psum"][i][0], ranks[1]["psum"][i][0])


def test_checkpoint_round_trip_over_two_ranks(two_ranks):
    """plain -> Shard(0) over two ranks -> saved -> restored onto one
    device: the values at every step."""
    root, ranks = two_ranks
    tree = checkpoint_tree()
    for r, got in enumerate(ranks):
        assert got["step"] == 1 and got["saved_seen"] == 2
        assert got["placements"] == ["(Shard(dim=0),)", "(Replicate(),)"]
        loc = got["local"]
        assert torch.equal(loc["w"], tree["w"].chunk(2)[r])
        assert torch.equal(loc["m"], tree["opt"]["m"].chunk(2)[r])
        assert torch.equal(loc["step"], tree["opt"]["step"])
        assert not isinstance(loc["b"], DTensor)
        assert torch.equal(loc["b"], tree["b"])
    assert [len(got["records"]) for got in ranks] == [1, 0]  # rank 0 commits
    for sub, step in (("sharded", 2), ("async", 3)):
        back, got_step = checkpoint.restore(str(root / sub), tree,
                                            device="cpu")
        assert got_step == step
        for (k, a), (_, b) in zip(checkpoint._leaves(back),
                                  checkpoint._leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b), (sub, k)


def test_sharded_restore_against_reference(two_ranks, reference):
    _, ranks = two_ranks
    assert int(reference["step"]) == 1
    for r, got in enumerate(ranks):
        loc = got["local"]
        for key in ("w", "m", "step"):
            np.testing.assert_array_equal(loc[key].float().numpy(),
                                          reference[f"shard_{key}{r}"],
                                          err_msg=f"{key} on rank {r}")


def test_restore_onto_a_host_mesh(one_rank, tmp_path):
    tree = checkpoint_tree()
    checkpoint.save(str(tmp_path / "ck"), tree, 4)
    mesh = make_host_mesh("cpu")
    rows, rep = (mesh, [Shard(0), Replicate()]), (mesh, [Replicate()] * 2)
    got, step = checkpoint.restore(
        str(tmp_path / "ck"), tree, device="cpu",
        shardings={"w": rows, "opt": rep, "b": None})
    assert step == 4
    assert isinstance(got["w"], DTensor) and isinstance(got["opt"]["m"],
                                                        DTensor)
    assert got["w"].placements == (Shard(0), Replicate())
    plain, _ = checkpoint.restore(str(tmp_path / "ck"), tree, device="cpu")
    for (k, a), (_, b) in zip(checkpoint._leaves(got),
                              checkpoint._leaves(plain)):
        whole = a.full_tensor() if isinstance(a, DTensor) else a
        assert whole.dtype == b.dtype and torch.equal(whole, b), k
    # the sharded tree saves whole tensors and restores onto one device
    checkpoint.save(str(tmp_path / "again"), got, 5)
    back, step = checkpoint.restore(str(tmp_path / "again"), tree,
                                    device="cpu")
    assert step == 5 and all(torch.equal(a, b) for (_, a), (_, b) in zip(
        checkpoint._leaves(back), checkpoint._leaves(plain)))
    for bad in ({"w": rows, "opt": rep}, {"w": rows, "opt": [rep], "b": None},
                [rows, rep, None]):
        with pytest.raises(ValueError, match="do not match"):
            checkpoint.restore(str(tmp_path / "ck"), tree, device="cpu",
                               shardings=bad)
