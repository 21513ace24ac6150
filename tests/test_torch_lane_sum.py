"""The lane-sum kernel's plain versions (``kernels/lane_sum.py``,
``kernels/ref.py``) on the CPU, against the reference's sums.

``lane_sum`` on a CPU tensor is torch's own sum (bit-equal).
``ref.lane_sum_ordered`` adds in the CUDA kernel's order, which the card
tests hold bit-equal to the kernel: here a lane alone gives the bits it gives
in any batch, and each output lies within depth * eps * sum |x| of the
float64 sum, depth being the adds on an element's way to the output (64 in
its thread's run of a chunk, 10 in the two butterflies, and again as many
where the chunks' sums are summed).  The reference's ``jnp.sum`` and its
capped-simplex projection are held to the same bound and to the port's
projection within 1e-6 relative (two float32 Newton runs on sums of another
order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import batch as tb
from repro_torch.kernels import lane_sum as klane
from repro_torch.kernels import ref

SHAPES = [((16, 24, 10, 5), (1, 3)), ((4, 1000, 10), (1, 2)),
          ((16, 24, 10, 5), (1, 2, 3)), ((3, 7), (1,)), ((1, 1, 1, 1), (1, 3)),
          ((2, 997, 14, 3), (1, 3))]


def _x(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


def _bound(x, dims, chunk):
    """depth * eps * sum |x| per output (see the module docstring)."""
    B, R1, M, R2 = ref.lane_view(x.shape, dims)
    chunks = -(-(R1 * R2) // chunk)
    depth = chunk // 256 + 10
    if chunks > 1:
        depth += -(-chunks // 256) + 10
    eps = torch.finfo(x.dtype).eps
    return depth * eps * x.abs().double().sum(dim=dims, keepdim=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,dims", SHAPES)
def test_cpu_wrapper_is_torch_sum(shape, dims, dtype):
    x = _x(shape, dtype)
    before = klane.lane_sum.launches
    got = klane.lane_sum(x, dims)
    assert klane.lane_sum.launches == before  # no launch on the CPU
    assert torch.equal(got, x.sum(dim=dims, keepdim=True))


@pytest.mark.parametrize("chunk", [klane.CHUNK, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,dims", SHAPES)
def test_ordered_lanes_do_not_depend_on_the_batch(shape, dims, dtype, chunk):
    x = _x(shape, dtype, seed=1)
    whole = ref.lane_sum_ordered(x, dims, chunk)
    exact = x.double().sum(dim=dims, keepdim=True)
    assert whole.shape == exact.shape and whole.dtype == dtype
    assert bool(((whole.double() - exact).abs()
                 <= _bound(x, dims, chunk)).all())
    for lo, hi in ((0, 1), (x.shape[0] - 1, x.shape[0]),
                   (0, (x.shape[0] + 1) // 2)):
        part = ref.lane_sum_ordered(x[lo:hi].clone(), dims, chunk)
        assert torch.equal(part, whole[lo:hi])


def test_ordered_two_passes_past_one_chunk():
    # 40000 elements a lane: three chunks, then their sum
    x = _x((3, 40000), torch.float32, seed=2)
    got = ref.lane_sum_ordered(x, (1,), klane.CHUNK)
    for b in range(3):
        assert torch.equal(ref.lane_sum_ordered(x[b:b + 1], (1,),
                                                klane.CHUNK), got[b:b + 1])
    exact = x.double().sum(dim=1, keepdim=True)
    assert bool(((got.double() - exact).abs()
                 <= _bound(x, (1,), klane.CHUNK)).all())


@pytest.mark.parametrize("shape,dims", SHAPES[:3])
def test_against_the_reference_sum(shape, dims):
    jnp = pytest.importorskip("jax.numpy")
    x = _x(shape, torch.float32, seed=3)
    theirs = torch.from_numpy(np.array(
        jnp.sum(jnp.asarray(x.numpy()), axis=dims, keepdims=True)))
    ours = ref.lane_sum_ordered(x, dims, klane.CHUNK)
    both = 2 * _bound(x, dims, klane.CHUNK)
    assert bool(((ours.double() - theirs.double()).abs() <= both).all())


def test_capped_projection_against_the_reference():
    pytest.importorskip("jax")
    from repro.core import batch as rb
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    y = rng.standard_normal((4, 24, 10, 5)).astype(np.float32)
    cap = rng.uniform(0.5, 3.0, (4, 1, 10, 1)).astype(np.float32)
    ours = tb._project_capped_simplex_td(torch.from_numpy(y),
                                         torch.from_numpy(cap),
                                         klane.lane_sum).numpy()
    theirs = np.asarray(rb._project_capped_simplex_td(jnp.asarray(y),
                                                      jnp.asarray(cap)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)
    assert (ours.sum(axis=(1, 3), keepdims=True) <= cap * (1 + 1e-6)).all()


def test_refuses_what_it_does_not_sum():
    x = torch.ones((2, 3, 4))
    with pytest.raises(ValueError, match="every axis but the first"):
        klane.lane_sum(x, (1,))
    with pytest.raises(ValueError, match="every axis but the first"):
        klane.lane_sum(torch.ones(5), (0,))
    with pytest.raises(TypeError, match="float32 or float64"):
        klane.lane_sum(torch.ones((2, 3), dtype=torch.int32), (1,))
    with pytest.raises(ValueError, match="unsupported device"):
        klane.lane_sum(torch.ones((2, 3), device="meta"), (1,))
