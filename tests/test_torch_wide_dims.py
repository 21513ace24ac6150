"""Wide constrained instances on the CPU: the port against the reference.

Every instance is ``synthetic_instance`` with exclusive tasks and
anti-affinity pairs drawn by ``np.random.default_rng(2000 + seed)`` over
disjoint tasks (``tests/_torch_wide.py`` ``wide_instance``, as
``chip_smoke.py`` phase 10c draws them); each pair lowers to one
unit-capacity dimension and the exclusive set to one more, so D = 3 + 1 + 40
= 44 here (phase 10c's D = 276 and m * D = 8280 on the card).  On the card
these shapes pass the steppers' old D <= 32 and D <= 256 and the congestion
kernel's old m * D <= 8192 limits; on the CPU every kernel wrapper runs its
plain version, so these tests hold the CPU side of those paths:

* ``rightsize`` for the four algorithms, ``backend="numpy"`` and
  ``backend="kernel"`` (``ref.two_phase_ref`` here), against the
  reference's: costs and ``assign`` equal, 0 ``check_plan`` violations;
* ``congestion_lp`` and ``congestion_many`` at m * D = 8280 against the
  reference's Pallas kernel in interpret mode, within 1e-5 of the output's
  max |value| (float32 sums in another order).

The D = 274 fleet has files of its own: ``test_torch_wide_fleet.py`` (the
evaluate against the reference's) and ``test_torch_wide_place_first.py`` /
``test_torch_wide_place_similarity.py`` (the compiled route's plain version
given the reference's LP mappings, one fit policy each).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import batch as jbatch
from repro.kernels.congestion import congestion_many_pallas
from repro_torch import core as P
from repro_torch.kernels import congestion as tcong

from _torch_wide import d44_instance
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CONG_TOL = 1e-5


@pytest.fixture(scope="module")
def d44():
    return (*d44_instance(), {})


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("algo", J.ALGORITHMS)
def test_rightsize_at_44_dimensions(d44, algo, backend):
    ref, port, cache = d44
    if algo not in cache:
        cache[algo] = J.rightsize(ref, algo)
    want = cache[algo]
    got = P.rightsize(port, algo, backend=backend, device="cpu")
    assert got.cost(port) == want.cost(ref)
    assert np.array_equal(got.assign, want.assign)
    assert np.array_equal(got.node_type, want.node_type)
    assert P.check_plan(port, got) == []


def _spans(rng, G, n, T):
    start = rng.integers(0, T, (G, n)).astype(np.int32)
    end = np.minimum(start + rng.integers(0, T, (G, n)), T - 1)
    return start, end.astype(np.int32)


def test_congestion_lp_past_one_column_tile():
    rng = np.random.default_rng(8280)
    B, n, m, D, Tp = 1, 12, 30, 276, 8
    start, end = _spans(rng, B, n, Tp)
    w = rng.random((B, n, m, D)).astype(np.float32)
    x = rng.random((B, n, m)).astype(np.float32)
    fwd, _ = jbatch._make_operators(jnp.asarray(w), jnp.asarray(start),
                                    jnp.asarray(end), Tp, "pallas")
    want = np.asarray(fwd(jnp.asarray(x)))
    got = tcong.congestion_lp(*(torch.from_numpy(a)
                                for a in (start, end, w, x)), Tp)
    assert tcong.column_tiles(m * D, Tp)[1] > 1
    assert got.shape == (B, Tp, m, D)
    assert np.abs(got.numpy() - want).max() <= CONG_TOL * np.abs(want).max()


def test_congestion_many_past_one_column_tile():
    rng = np.random.default_rng(8281)
    G, n, K, T = 2, 12, 8280, 8
    start, end = _spans(rng, G, n, T)
    start[:, 0], end[:, 0] = 1, 0  # a never-active padding task
    w = rng.random((G, n, K)).astype(np.float32)
    want = np.asarray(congestion_many_pallas(
        jnp.asarray(start), jnp.asarray(end), jnp.asarray(w), T,
        interpret=True))
    got = tcong.congestion_many(*(torch.from_numpy(a)
                                  for a in (start, end, w)), T)
    assert got.shape == (G, T, K)
    assert np.abs(got.numpy() - want).max() <= CONG_TOL * np.abs(want).max()
