"""The LP's one-launch congestion apply (``congestion_lp``) on the CPU.

On CPU tensors ``repro_torch.kernels.congestion.congestion_lp`` returns its
plain version, ``ref.congestion_lp_ref``.  These tests hold that against the
reference's ``operator="pallas"`` forward apply
(``repro.core.batch._make_operators``, its Pallas kernel in interpret mode)
at rtol/atol 1e-5 (float32 sums in another order), and hold the port's CPU
LP bit-equal to the expression it had before the apply became one launch:
a permute, the product ``w * x`` and ``congestion_many`` over B*m groups.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch as jbatch
from repro.workload import SyntheticSpec, sweep_specs, synthetic_batch
from repro_torch.convert import problem_from_arrays
from repro_torch.core import batch as tbatch
from repro_torch.kernels import congestion as tcong
from repro_torch.kernels import ref as tref

RTOL = ATOL = 1e-5


def _lp_inputs(seed, B, n, m, D, Tp):
    """Spans, weights and an iterate as the LP holds them, with both kinds
    of padding task: the pack's [0, 0] with zero weight, and start > end."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, Tp, (B, n)).astype(np.int32)
    end = np.minimum(start + rng.integers(0, Tp, (B, n)), Tp - 1)
    end = end.astype(np.int32)
    w = rng.random((B, n, m, D)).astype(np.float32)
    x = rng.random((B, n, m)).astype(np.float32)
    start[:, 0], end[:, 0], w[:, 0] = 0, 0, 0.0
    if n > 1:
        start[:, 1], end[:, 1] = 1, 0
    return start, end, w, x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _parent_pallas_fwd(w_all, start, end, Tp):
    """The port's operator="pallas" forward before it became one launch."""
    B, n, m, D = w_all.shape
    start_g = start.repeat_interleave(m, dim=0).contiguous()
    end_g = end.repeat_interleave(m, dim=0).contiguous()
    w_g = w_all.permute(0, 2, 1, 3).reshape(B * m, n, D)

    def fwd_all(xv):
        x_g = xv.permute(0, 2, 1).reshape(B * m, n)
        cong = tcong.congestion_many(start_g, end_g,
                                     (w_g * x_g[:, :, None]).contiguous(), Tp)
        return cong.reshape(B, m, Tp, D).permute(0, 2, 1, 3)
    return fwd_all


# n is no multiple of any slice or group size the kernel picks; T' > 32
# needs more than one 32-slot time tile on the card
@pytest.mark.parametrize("B,n,m,D,Tp", [
    (1, 37, 1, 1, 33),
    (2, 61, 3, 2, 40),
    (3, 101, 3, 5, 70),
    (2, 45, 1, 5, 33),
])
def test_lp_apply_matches_reference_pallas_forward(B, n, m, D, Tp):
    start, end, w, x = _lp_inputs(B * 100 + n, B, n, m, D, Tp)
    fwd_j, _ = jbatch._make_operators(jnp.asarray(w), jnp.asarray(start),
                                      jnp.asarray(end), Tp, "pallas")
    want = np.asarray(fwd_j(jnp.asarray(x)))
    got = tref.congestion_lp_ref(_t(start), _t(end), _t(w), _t(x), Tp)
    assert got.shape == (B, Tp, m, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # on CPU tensors the wrapper is the plain version
    wrapped = tcong.congestion_lp(_t(start), _t(end), _t(w), _t(x), Tp)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("B,n,m,D,Tp", [(2, 61, 3, 2, 40), (1, 9, 4, 3, 7)])
def test_lp_apply_is_bit_equal_to_the_parent_expression(B, n, m, D, Tp):
    start, end, w, x = _lp_inputs(7 + n, B, n, m, D, Tp)
    args = _t(w), _t(start), _t(end), Tp
    fwd, _ = tbatch._make_operators(*args, "pallas")
    want = _parent_pallas_fwd(*args)(_t(x))
    got = fwd(_t(x))
    assert torch.equal(got, want)
    assert got.stride() == want.stride()


def test_tpu_contract_is_the_case_m_1_without_x():
    start, end, w, _ = _lp_inputs(3, 4, 50, 1, 5, 36)
    ones = torch.ones((4, 50, 1))
    lp = tcong.congestion_lp(_t(start), _t(end), _t(w), ones, 36)
    many = tcong.congestion_many(_t(start), _t(end), _t(w[:, :, 0]), 36)
    assert torch.equal(lp[:, :, 0], many)


def test_solve_through_pallas_is_bit_equal_to_the_parent(monkeypatch):
    grid = synthetic_batch(sweep_specs(SyntheticSpec(n=40, m=4, D=3, T=16),
                                       seeds=2, n=(30, 40)))
    probs = [problem_from_arrays(p) for p in grid]
    got = tbatch.solve_lp_many(probs, iters=60, operator="pallas",
                               device="cpu")

    make = tbatch._make_operators

    def parent_operators(w_all, start, end, Tp, operator):
        fwd, adj = make(w_all, start, end, Tp, operator)
        if operator == "pallas":
            fwd = _parent_pallas_fwd(w_all, start, end, Tp)
        return fwd, adj

    monkeypatch.setattr(tbatch, "_make_operators", parent_operators)
    want = tbatch.solve_lp_many(probs, iters=60, operator="pallas",
                                device="cpu")
    for g, w in zip(got, want):
        assert g.objective == w.objective
        assert g.lower_bound == w.lower_bound
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.mapping, w.mapping)


def test_lp_wrapper_checks_its_inputs():
    s = torch.zeros((2, 5), dtype=torch.int32)
    w = torch.ones((2, 5, 3, 2))
    x = torch.ones((2, 5, 3))
    with pytest.raises(TypeError):
        tcong.congestion_lp(s.long(), s, w, x, 4)
    with pytest.raises(TypeError):
        tcong.congestion_lp(s, s, w.double(), x, 4)
    with pytest.raises(TypeError):
        tcong.congestion_lp(s, s, w, x.double(), 4)
    with pytest.raises(ValueError):
        tcong.congestion_lp(s, s, w, x[:, :, :2], 4)
    with pytest.raises(ValueError):
        tcong.congestion_lp(s[:, :4], s, w, x, 4)
    with pytest.raises(ValueError):
        tcong.congestion_lp(s, s, w[..., 0], x, 4)
    with pytest.raises(ValueError, match="device"):
        tcong.congestion_lp(s, s, w.to("meta"), x, 4)


def test_cpu_lp_applies_never_count_launches():
    before = tcong.congestion_many.launches
    start, end, w, x = _lp_inputs(1, 2, 10, 3, 2, 8)
    tcong.congestion_lp(_t(start), _t(end), _t(w), _t(x), 8)
    assert tcong.congestion_many.launches == before


def test_column_tile_is_the_kernels_own():
    src = (pathlib.Path(tcong.__file__).parent / "csrc" / "congestion.cu")
    text = src.read_text()
    part = re.search(r"constexpr int kPartFloats = (\d+);", text)
    tile_t = re.search(r"constexpr int kMinTileT = (\d+);", text)
    assert int(part.group(1)) == tcong.PART_FLOATS
    assert int(tile_t.group(1)) == tcong._MIN_TILE_T
    # one tile while the columns fit; past that, tiles of at most
    # PART_FLOATS // min(T, 8) columns, as even as they can be
    assert tcong.column_tiles(tcong.PART_FLOATS, 24) == (tcong.PART_FLOATS, 1)
    for C, T in [(tcong.PART_FLOATS + 1, 1), (8280, 24), (9000, 4),
                 (240000, 997)]:
        width, tiles = tcong.column_tiles(C, T)
        assert tiles > 1 and (tiles - 1) * width < C <= tiles * width
        assert width * min(T, 8) <= tcong.PART_FLOATS
    # CPU tensors take the plain version, past one tile as below it
    C = tcong.PART_FLOATS + 1
    s = torch.zeros((1, 2), dtype=torch.int32)
    w = torch.ones((1, 2, 1, C))
    out = tcong.congestion_lp(s, s, w, torch.ones((1, 2, 1)), 3)
    assert out.shape == (1, 3, 1, C)
    assert torch.equal(out[0, 0], torch.full((1, C), 2.0))
    assert not out[0, 1:].any()