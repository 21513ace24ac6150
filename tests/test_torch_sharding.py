"""The port's sharding specs (``repro_torch.sharding``) against the
reference's (``repro.sharding``): every parameter, batch and decode-state
spec of the ten configs at full width, on the 16x16 and 2x16x16 production
mesh shapes, and the counterparts of ``tests/test_fleet.py``'s
``TestPartitioning``.

Nothing is allocated: the reference's trees are ``jax.eval_shape``
stand-ins and its spec functions read only ``mesh.shape``, so an
``AbstractMesh`` stands in for its mesh; the port's model, state and batch
are ``meta`` tensors on a ``DeviceMesh`` over a fake process group.  A port
spec is ``tuple(PartitionSpec)`` of the reference's, less the leading
``repeats`` entry of the reference's stacked leaves.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch.dryrun import batch_shapes as ref_batch_shapes
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_params as ref_init_params
from repro.sharding import batch_specs as ref_batch_specs
from repro.sharding import decode_state_specs as ref_decode_state_specs
from repro.sharding import param_specs as ref_param_specs
from repro_torch.configs import ARCHS, SHAPES, cell_eligible, get_config
from repro_torch.convert import segment_layers
from repro_torch.launch.dryrun import batch_shapes
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import Model, init_decode_state
from repro_torch.sharding import (batch_specs, decode_state_specs, named,
                                  param_specs, tree_named)

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield prefix + key, val


def _ref_named(specs: dict, cfg) -> dict:
    """{port parameter name: reference spec as a tuple} of the reference's
    parameter specs, the stacked leaves' leading entry checked None and
    dropped."""
    out = {"embed": tuple(specs["embed"]),
           "final_norm": tuple(specs["final_norm"])}

    def unstack(spec):
        spec = tuple(spec)
        assert spec[0] is None, spec
        return spec[1:]

    for layer, si, _r, j in segment_layers(cfg):
        for name, spec in _flat(specs["segments"][si][j]):
            out[f"layers.{layer}.{name}"] = unstack(spec)
    if cfg.encoder_layers:
        enc = specs["encoder"]
        out["encoder.final_norm"] = tuple(enc["final_norm"])
        for i in range(cfg.encoder_layers):
            for name, spec in _flat(enc["blocks"]):
                out[f"encoder.blocks.{i}.{name}"] = unstack(spec)
    return out


@pytest.fixture(params=sorted(MESHES))
def meshes(request):
    shape, axes = MESHES[request.param]
    world = int(np.prod(shape))
    with fake_world(world):
        yield (AbstractMesh(shape, axes),
               make_production_mesh(multi_pod=len(shape) == 3, device="cpu"))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_reference_at_full_width(arch, meshes):
    ref_mesh, mesh = meshes
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    ref_params = jax.eval_shape(
        lambda: ref_init_params(jax.random.PRNGKey(0), ref_cfg))
    model = Model(cfg, device="meta")

    # parameters: every leaf, by the port's name
    want = _ref_named(ref_param_specs(ref_params, ref_cfg, ref_mesh), cfg)
    got = param_specs(model, cfg, mesh)
    assert got == want
    assert set(got) == {k for k, _ in model.named_parameters()}

    for shape_name, shape in SHAPES.items():
        if not cell_eligible(cfg, shape)[0]:
            continue
        # the batch of the cell's mode
        ref_b = ref_batch_shapes(ref_cfg, shape.seq_len, shape.global_batch,
                                 shape.mode)
        b = batch_shapes(cfg, shape.seq_len, shape.global_batch, shape.mode)
        assert {k: tuple(v) for k, v in ref_batch_specs(
            ref_b, ref_cfg, ref_mesh).items()} == batch_specs(b, cfg, mesh)
        if shape.mode != "decode":
            continue
        # the decode state: one cache dict per layer, pos replicated
        ref_state = jax.eval_shape(
            lambda p, s=shape: ref_init_decode_state(
                p, ref_cfg, s.global_batch, s.seq_len), ref_params)
        ref_specs = ref_decode_state_specs(ref_state, ref_cfg, ref_mesh)
        specs = decode_state_specs(
            init_decode_state(model, shape.global_batch, shape.seq_len),
            cfg, mesh)
        assert tuple(ref_specs["pos"]) == specs["pos"] == ()
        assert len(specs["caches"]) == cfg.num_layers
        for layer, si, _r, j in segment_layers(cfg):
            ref_cache = ref_specs["caches"][si][j]
            assert set(ref_cache) == set(specs["caches"][layer]), shape_name
            for key, spec in ref_cache.items():
                spec = tuple(spec)
                assert spec[0] is None
                assert specs["caches"][layer][key] == spec[1:], (
                    shape_name, layer, key)


def test_reference_shapes_equal_the_ports():
    assert {k: (s.seq_len, s.global_batch, s.mode)
            for k, s in REF_SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.mode) for k, s in SHAPES.items()}


def test_named_places_specs_on_the_mesh(meshes):
    from torch.distributed.tensor import Replicate, Shard

    _ref, mesh = meshes
    n = mesh.ndim
    assert named(mesh, (None, None)) == (Replicate(),) * n
    assert named(mesh, ("data", "model"))[-2:] == (Shard(0), Shard(1))
    if n == 3:
        assert named(mesh, (None, ("pod", "data"))) == (
            Shard(1), Shard(1), Replicate())
    tree = tree_named(mesh, {"a": ("model",), "b": [(None,), ()]})
    assert tree["a"][-1] == Shard(0) and tree["b"][1] == (Replicate(),) * n


class TestPartitioning:
    def test_param_specs_cover_all_leaves(self):
        from repro_torch.configs import smoke_config

        with fake_world(1):
            mesh = make_host_mesh("cpu")
            for arch in ("gemma2-9b", "olmoe-1b-7b", "recurrentgemma-9b",
                         "rwkv6-7b", "whisper-small"):
                cfg = smoke_config(arch)
                model = Model(cfg, device="meta")
                specs = param_specs(model, cfg, mesh)
                params = dict(model.named_parameters())
                assert set(specs) == set(params), arch
                for name, p in params.items():
                    assert len(specs[name]) <= p.ndim, (arch, name)

    def test_constrain_noop_without_mesh(self):
        from repro_torch.sharding.ctx import constrain, hints_enabled

        assert not hints_enabled()
        x = torch.ones((4, 8))
        assert constrain(x, "batch", "model") is x

    def test_constrain_axis_count_checked(self):
        from repro_torch.sharding.ctx import constrain, use_mesh

        with fake_world(1), use_mesh(make_host_mesh("cpu")):
            with pytest.raises(ValueError):
                constrain(torch.ones((4, 8)), "batch")

    def test_constrain_redistributes_a_dtensor(self):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from repro_torch.sharding.ctx import constrain, use_mesh

        with fake_world(256):
            mesh = make_production_mesh(device="cpu")
            x = DTensor.from_local(torch.empty((2, 64, 16, 8), device="meta"),
                                   mesh, (Shard(0), Replicate()),
                                   run_check=False, shape=(32, 64, 16, 8),
                                   stride=(64 * 16 * 8, 16 * 8, 8, 1))
            with use_mesh(mesh):
                y = constrain(x, "batch", None, "heads", None)
                z = constrain(x, "batch", None, None, "model")  # 8 % 16
            assert y.placements == (Shard(0), Shard(2))
            assert y._local_tensor.shape == (2, 64, 1, 8)
            assert z.placements == (Shard(0), Replicate())

    def test_production_mesh_needs_its_world(self):
        with fake_world(64):
            with pytest.raises(ValueError, match="256 ranks, not 64"):
                make_production_mesh(device="cpu")
        with fake_world(256):
            with pytest.raises(ValueError, match="512 ranks"):
                make_production_mesh(multi_pod=True, device="cpu")
            mesh = make_production_mesh(device="cpu")
            assert mesh.mesh_dim_names == ("data", "model")
            assert tuple(mesh.shape) == (16, 16)
        with pytest.raises(ValueError, match="no process group"):
            make_production_mesh(device="cpu")
