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
from repro_torch.launch.hlo_cost import (HloCost, OpCounter, analyze,
                                         workspace_registry)
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


class TestWorkspace:
    """A registered operator's scratch (``workspace_registry``): the WKV
    backward's kernels allocate 278,921,216 bytes inside one call at B = 4,
    S = 2048, H = N = 64 (``chip_smoke.py`` phase 16 reads that many on the
    card), which its fake implementation, returning the outputs only,
    cannot show."""

    SHAPE = (4, 2048, 64, 64)

    def _peak(self):
        B, S, H, N = self.SHAPE
        meta = dict(device="meta")
        r, k, v = (torch.empty(self.SHAPE, dtype=torch.bfloat16, **meta)
                   for _ in range(3))
        lw, gy = (torch.empty(self.SHAPE, **meta) for _ in range(2))
        u = torch.empty((H, N), **meta)
        gs = torch.empty((B, H, N, N), **meta)
        args = (r, k, v, lw, u, gy, gs)
        with OpCounter() as counter:
            counter.track(args)
            outs = torch.ops.repro_torch.wkv_backward(*args)
        held = sum(t.untyped_storage().nbytes() for t in args + outs)
        return counter, held

    def test_peak_rises_by_the_scratch(self, monkeypatch):
        from repro_torch.kernels import wkv

        counter, held = self._peak()
        assert wkv.backward_scratch_bytes(*self.SHAPE) == 278_921_216
        assert counter.workspace_bytes == 278_921_216
        assert counter.peak_bytes == counter.workspace_peak_bytes == \
            held + 278_921_216
        # without the registration the same call peaks at what is held
        monkeypatch.delitem(workspace_registry,
                            torch.ops.repro_torch.wkv_backward)
        bare, held_bare = self._peak()
        assert bare.peak_bytes == held_bare == held
        assert counter.peak_bytes - bare.peak_bytes == 278_921_216
        assert bare.workspace_bytes == bare.workspace_peak_bytes == 0

    def test_formula_is_what_the_wrapper_allocates(self):
        """One function gives both: the registered formula sums the shapes
        ``wkv_backward_launch`` allocates, B H (2 nc + 1) N^2 * 4 + 12 B H
        nc N bytes with nc = ceil(S / 64)."""
        from repro_torch.kernels import wkv

        for B, S, H, N in ((4, 2048, 64, 64), (1, 65, 2, 16), (2, 1, 4, 64)):
            nc = -(-S // 64)
            want = B * H * (2 * nc + 1) * N * N * 4 + 12 * B * H * nc * N
            assert wkv.backward_scratch_bytes(B, S, H, N) == want
            meta = torch.empty((B, S, H, N), device="meta")
            assert workspace_registry[torch.ops.repro_torch.wkv_backward](
                meta, meta, meta, meta) == want
