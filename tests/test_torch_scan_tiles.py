"""The linear-scan kernels' tile walk (``tests/_torch_scan_tiles.py``, a
transcription of ``csrc/scan.cu``) against the plain loops on the CPU.

What is held, and how closely:
  * the walk's h, and its (ga, gb) from the plain h, bit-equal in float32 to
    ``ref.linear_scan_ref`` and ``ref.linear_scan_backward_ref`` (the walk
    rounds the multiply and the add apart in time order, as the kernels and
    the loops do), every output element stored exactly once, at the ragged
    shapes the card checks: W not a multiple of 4 or 32, S not a multiple
    of the tile, B * W below one block, and the path's own shape;
  * the same at every (steps a tile, stages) the plan rule can pick, each
    channel count and both copy widths, at one small shape;
  * the plan rule (``plan``, which ``kernels.scan.launch_plan`` must equal
    on the card) across the path's shapes and the smoke configurations'
    widths: blocks cover every (b, channel) once, shared memory fits a
    block's 227 KB, and at the path's shapes every block is resident at
    once with several MB of loads in flight.
"""

import numpy as np
import pytest
import torch

import _torch_scan_tiles as tiles
from repro_torch.kernels import ref

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMS = 132  # the H100's SMs
RAGGED = [(1, 1, 1), (2, 7, 300), (1, 65, 33), (3, 300, 4098),
          (4, 4100, 4096)]
# (B, S, W): the path's forward (16a's prefill) and backward (16c's step),
# and the smoke configurations' width (rnn_width 64) at their batches
PATH = [(4, 4100, 4096), (4, 2048, 4096)]
SMOKE = [(B, S, 64) for B in (1, 2, 4, 32) for S in (12, 64)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, shape)
    b, gh = rng.standard_normal(shape), rng.standard_normal(shape)
    return [torch.from_numpy(x.astype(np.float32)) for x in (a, b, gh)]


def _hold(a, b, gh, **kw):
    h, n_h = tiles.forward(a, b, **kw)
    want = ref.linear_scan_ref(a, b)
    assert torch.equal(h, want)
    ga, gb, n_g = tiles.backward(a, want, gh, **kw)
    pa, pb = ref.linear_scan_backward_ref(a, want, gh)
    assert torch.equal(ga, pa) and torch.equal(gb, pb)
    assert bool((n_h == 1).all()) and bool((n_g == 1).all())


@pytest.mark.parametrize("B,S,W", RAGGED, ids=lambda x: str(x))
def test_walk_is_bit_equal_to_plain(B, S, W):
    a, b, gh = _inputs((B, S, W), seed=S + W)
    _hold(a, b, gh, sms=SMS)


@pytest.mark.parametrize("vec", [1, 4])
@pytest.mark.parametrize("C", [8, 16, 32, 64])
@pytest.mark.parametrize("T,stages", tiles.SHAPES, ids=lambda x: str(x))
def test_walk_is_bit_equal_at_every_tile_shape(T, stages, C, vec):
    B, S, W = 2, 70, 36
    a, b, gh = _inputs((B, S, W), seed=T * stages + C)
    p = {"blocks": B * -(-W // C), "channels": C, "steps": T,
         "stages": stages, "vec": vec}
    _hold(a, b, gh, p=p)


def _covers_once(p, B, W):
    """Every (b, channel) below W has exactly one lane that stores it, and
    no lane stores past W."""
    bi, cols, keep = tiles._lanes(p, B, W)
    if bool((cols[keep] >= W).any()):
        return False
    n = torch.zeros((B, W), dtype=torch.int64)
    n.index_put_((bi[:, None].expand_as(cols)[keep], cols[keep]),
                 torch.ones_like(cols[keep]), accumulate=True)
    return bool((n == 1).all())


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("B,S,W", RAGGED + PATH + SMOKE,
                         ids=lambda x: str(x))
def test_plan_covers_each_channel_once_and_fits(B, S, W, backward):
    p = tiles.plan(B, W, backward, SMS)
    assert p["blocks"] == B * -(-W // p["channels"])
    assert _covers_once(p, B, W)
    assert p["smem_bytes"] <= tiles.MAX_SMEM_PER_BLOCK
    assert p["vec"] == (4 if W % 4 == 0 else 1)
    assert p["steps"] * p["channels"] % 4 == 0  # 16-byte slot offsets


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("B,S,W", PATH, ids=lambda x: str(x))
def test_plan_keeps_every_sm_busy_in_one_wave(B, S, W, backward):
    p = tiles.plan(B, W, backward, SMS)
    per_sm = min(tiles.SMEM_PER_SM // (p["smem_bytes"]
                                       + tiles.RESERVE_PER_BLOCK),
                 tiles.MAX_RESIDENT)
    assert SMS <= p["blocks"] <= SMS * per_sm, (p, per_sm)
    assert p["blocks"] == 256 and p["channels"] == 64
    ins = 3 if backward else 2
    in_flight = ((p["stages"] - 1) * ins * p["steps"] * p["channels"] * 4
                 * p["blocks"])
    assert in_flight >= 8 << 20, in_flight
