"""The port's per-device cost accounting (``repro_torch.launch.hlo_cost``)
against analytic counts and the reference's ``repro.launch.hlo_cost``: the
counterparts of ``tests/test_hlo_cost.py``, and two cases that only a
sharded trace has (a collective's bytes, and FLOPs counted on the local
shards, not on the global tensors).

The port traces an eager call op by op, so a loop's ratio of trips is exact
where the reference's HLO count holds it within 15%.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.launch.hlo_cost import analyze as ref_analyze
from repro_torch.launch.hlo_cost import HloCost, analyze
from repro_torch.launch.mesh import fake_world


def _ref_cost(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return ref_analyze(jax.jit(fn).lower(*args).compile().as_text())


def _cost(fn, *shapes):
    gen = torch.Generator().manual_seed(0)
    return analyze(fn, *(torch.randn(s, generator=gen) for s in shapes))


def _loop_matmul(n_iters):
    def f(x, w):
        for _ in range(n_iters):
            x = torch.tanh(x @ w)
        return x
    return f


class TestFlops:
    def test_single_matmul_exact_and_reference_within_2x(self):
        c = _cost(lambda a, b: a @ b, (128, 256), (256, 64))
        analytic = 2 * 128 * 256 * 64
        assert c.flops == analytic
        ref = _ref_cost(lambda a, b: a @ b, (128, 256), (256, 64))
        assert analytic <= ref.flops <= 2.0 * analytic, (ref.flops, analytic)

    def test_loop_multiplies_by_trip_count(self):
        long, short = 17, 5
        c_long = _cost(_loop_matmul(long), (64, 64), (64, 64))
        c_short = _cost(_loop_matmul(short), (64, 64), (64, 64))
        assert c_long.flops == long * 2 * 64 ** 3
        assert c_short.flops == short * 2 * 64 ** 3
        assert c_long.flops / c_short.flops == long / short

    def test_nested_loop_matches_flat_loop(self):
        def nested(x, w):
            for _ in range(5):
                for _ in range(3):
                    x = x @ w
            return x

        def flat(x, w):
            for _ in range(15):
                x = x @ w
            return x

        c_nested = _cost(nested, (32, 32), (32, 32))
        c_flat = _cost(flat, (32, 32), (32, 32))
        assert c_nested.flops == c_flat.flops == 15 * 2 * 32 ** 3

    def test_batched_dot_scales_with_batch(self):
        def bdot(a, b):
            return torch.einsum("bij,bjk->bik", a, b)

        c8 = _cost(bdot, (8, 32, 64), (8, 64, 16))
        c2 = _cost(bdot, (2, 32, 64), (2, 64, 16))
        assert c8.flops == 2 * 8 * 32 * 64 * 16
        assert c8.flops / c2.flops == 4.0


class TestTraffic:
    def test_traffic_at_least_io(self):
        c = _cost(lambda a, b: a @ b, (256, 256), (256, 256))
        io_bytes = 3 * 256 * 256 * 4
        assert c.traffic_bytes >= io_bytes

    def test_views_move_no_bytes(self):
        c = _cost(lambda a: a.reshape(-1)[:10].unsqueeze(0).T, (64, 32))
        assert c.traffic_bytes == 0 and c.flops == 0
        # a transposed tensor's reshape copies: that moves bytes
        c = _cost(lambda a: a.T.reshape(-1), (64, 32))
        assert c.traffic_bytes >= 2 * 64 * 32 * 4


def _dtensor(mesh, placements, shape):
    local = list(shape)
    for p, size in zip(placements, mesh.shape):
        if p.is_shard():
            local[p.dim] //= size
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False, shape=shape,
                              stride=stride)


class TestCollectives:
    def test_sharded_contraction_all_reduce_bytes(self):
        """4 ranks: (64, 128) sharded on its columns @ (128, 32) sharded on
        its rows is a partial sum; replicating it all-reduces the (64, 32)
        float32 result, 8192 bytes."""
        from torch.distributed.device_mesh import DeviceMesh

        with fake_world(4):
            mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("model",))
            a = _dtensor(mesh, (Shard(1),), (64, 128))
            b = _dtensor(mesh, (Shard(0),), (128, 32))
            c = analyze(lambda: (a @ b).redistribute(mesh, (Replicate(),)))
        assert c.collective_bytes["all-reduce"] == 64 * 32 * 4
        assert c.collective_count == 1
        assert c.flops == 2 * 64 * (128 // 4) * 32
        assert set(c.collective_bytes) == {
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"}

    def test_counts_local_shards_on_16x16(self):
        """A (4096, 1024) @ (1024, 2048) product sharded over data (rows)
        and model (columns) counts 1/256 of the global FLOPs per device."""
        from repro_torch.launch.mesh import make_production_mesh

        with fake_world(256):
            mesh = make_production_mesh(device="cpu")
            a = _dtensor(mesh, (Shard(0), Replicate()), (4096, 1024))
            b = _dtensor(mesh, (Replicate(), Shard(1)), (1024, 2048))
            c = analyze(lambda: a @ b)
        assert c.flops == 2 * 4096 * 1024 * 2048 / 256
        assert c.collective_count == 0


def test_to_dict_keys_match_reference():
    from repro.launch.hlo_cost import HloCost as RefHloCost

    args = (1.0, 2.0, {"all-gather": 3.0}, 4)
    assert HloCost(*args).to_dict() == RefHloCost(*args).to_dict()
