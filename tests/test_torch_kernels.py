"""The port's kernel modules on the CPU, against the JAX reference.

On CPU tensors every kernel wrapper of ``repro_torch.kernels`` returns its
plain PyTorch version; these tests hold those (and the host-facing
``repro_torch.kernels.ops``) against ``repro.kernels.ref`` and against the
reference's Pallas kernels in interpret mode, over the shape sweeps of
``tests/test_kernels.py``.  Tolerances: congestion rtol/atol 1e-5 (float32
sums in another order); the fit margin is exact (a float32 difference and a
minimum, in any order); fit dot/norm rtol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fit import fit_scores_many_pallas, fit_scores_pallas
from repro_torch.kernels import congestion as tcong
from repro_torch.kernels import fit as tfit
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CPU = "cpu"
RTOL = ATOL = 1e-5

# the reference's plain versions, each compiled as one program per shape
# (op-by-op dispatch compiles every primitive separately)
J_CONGESTION = jax.jit(jref.congestion_ref, static_argnums=3)
J_CONGESTION_MANY = jax.jit(jref.congestion_many_ref, static_argnums=3)
J_FIT = jax.jit(jref.fit_scores_ref)
J_FIT_MANY = jax.jit(jref.fit_scores_many_ref)


def _spans(rng, n, T, width):
    start = rng.integers(0, T, n)
    end = np.minimum(start + rng.integers(0, max(width, 1), n), T - 1)
    return start, end


def _t(x, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)


class TestCongestion:
    @pytest.mark.parametrize("n,K,T", [
        (1, 1, 1),
        (7, 3, 24),
        (128, 128, 128),
        (300, 10, 200),
        (1000, 26, 995),
        (513, 129, 130),
    ])
    def test_matches_reference(self, n, K, T):
        rng = np.random.default_rng(n * 1000 + K)
        start, end = _spans(rng, n, T, T // 2)
        w = rng.random((n, K)).astype(np.float32)
        got = tops.congestion(start, end, w, T, device=CPU).numpy()
        want_ref = np.asarray(J_CONGESTION(
            np.asarray(start, np.int32), np.asarray(end, np.int32), w, T))
        want_kernel = np.asarray(jops.congestion(start, end, w, T))
        np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, want_kernel, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("G,n,K,T", [(1, 5, 2, 3), (6, 40, 5, 24),
                                         (3, 513, 9, 33)])
    def test_many_matches_reference(self, G, n, K, T):
        rng = np.random.default_rng(G * 100 + n)
        start, end = _spans(rng, G * n, T, T // 2)
        start, end = start.reshape(G, n), end.reshape(G, n)
        start[:, 0] = 1  # a never-active padding task (start > end)
        end[:, 0] = 0
        w = rng.random((G, n, K)).astype(np.float32)
        got = tops.congestion_many(start, end, w, T, device=CPU).numpy()
        want_ref = np.asarray(J_CONGESTION_MANY(
            np.asarray(start, np.int32), np.asarray(end, np.int32), w, T))
        want_kernel = np.asarray(jops.congestion_many(start, end, w, T))
        np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, want_kernel, rtol=RTOL, atol=ATOL)

    def test_point_tasks(self):
        got = tops.congestion([3, 3, 5], [3, 3, 5], np.ones((3, 1)), 8,
                              device=CPU).numpy()
        np.testing.assert_allclose(got[:, 0], [0, 0, 0, 2, 0, 1, 0, 0])

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_dtypes(self, dtype):
        rng = np.random.default_rng(5)
        n, K, T = 50, 4, 30
        start, end = _spans(rng, n, T, 10)
        w = rng.random((n, K)).astype(dtype)
        got = tops.congestion(start, end, w, T, device=CPU).numpy()
        want = np.asarray(jops.congestion(start, end, w, T))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_use_ref_and_wrapper_agree(self):
        rng = np.random.default_rng(6)
        start, end = _spans(rng, 60, 20, 8)
        w = rng.random((60, 3)).astype(np.float32)
        a = tops.congestion(start, end, w, 20, device=CPU)
        b = tops.congestion(start, end, w, 20, use_ref=True, device=CPU)
        assert torch.equal(a, b)

    def test_wrapper_checks_dtypes(self):
        s = torch.zeros((1, 3), dtype=torch.int64)
        with pytest.raises(TypeError):
            tcong.congestion_many(s, s, torch.ones((1, 3, 2)), 4)


def _fit_inputs(rng, B, N, T, D):
    rem = rng.random((B, N, T, D)).astype(np.float32)
    dem = (rng.random((B, D)) * 0.2).astype(np.float32)
    cap = (0.5 + rng.random((B, D))).astype(np.float32)
    s = rng.integers(0, T, B)
    e = np.array([rng.integers(a, T) for a in s])
    return rem, dem, cap, s, e


class TestFit:
    @pytest.mark.parametrize("N,T,D", [
        (1, 1, 1),
        (3, 24, 2),
        (128, 256, 5),
        (130, 300, 7),
        (64, 1000, 2),
    ])
    def test_single_matches_reference_kernel(self, N, T, D):
        rng = np.random.default_rng(N + 7 * T + D)
        rem, dem, cap, s, e = _fit_inputs(rng, 1, N, T, D)
        rem, dem, cap, s, e = rem[0], dem[0], cap[0], int(s[0]), int(e[0])
        inv = (1.0 / cap).astype(np.float32)
        mask = np.zeros(T, np.float32)
        mask[s: e + 1] = 1.0
        got = tfit.fit_scores(_t(rem), _t(dem), s, e, _t(inv))
        want_k = fit_scores_pallas(np.ascontiguousarray(rem.transpose(1, 2, 0)),
                                   dem, mask, inv, interpret=True)
        want_r = J_FIT(rem, dem, mask, inv)
        for want in (want_k, want_r):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=RTOL, atol=ATOL)
        # host-facing API (the reference's host finishing over its Pallas
        # kernel, already compiled for this shape above): identical
        # feasibility, cosine within tolerance
        feas, cos = tops.fit_scores(rem, dem, s, e, cap, scored=True,
                                    device=CPU)
        feas_j, cos_j = jops.fit_scores(rem, dem, s, e, cap, scored=True)
        np.testing.assert_array_equal(feas, feas_j)
        np.testing.assert_allclose(cos, cos_j, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("B,N,T,D", [(1, 1, 1, 1), (3, 9, 24, 5),
                                         (4, 130, 30, 3), (2, 17, 300, 7)])
    def test_many_matches_reference_kernel(self, B, N, T, D):
        rng = np.random.default_rng(B * 31 + N)
        rem, dem, cap, s, e = _fit_inputs(rng, B, N, T, D)
        inv = (1.0 / cap).astype(np.float32)
        inv[:, -1] = 0.0 if D > 1 else inv[:, -1]  # a padded dimension
        t = np.arange(T)
        mask = ((s[:, None] <= t) & (t <= e[:, None])).astype(np.float32)
        got = tfit.fit_scores_many(_t(rem), _t(dem), _t(s, torch.int32),
                                   _t(e, torch.int32), _t(inv))
        want_k = fit_scores_many_pallas(
            np.ascontiguousarray(rem.transpose(0, 2, 3, 1)), dem, mask, inv,
            interpret=True)
        want_r = J_FIT_MANY(rem, dem, mask, inv)
        for want in (want_k, want_r):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=RTOL, atol=ATOL)
        feas, cos = tops.fit_scores_many(rem.astype(np.float64), dem, s, e,
                                         inv, scored=True, device=CPU)
        feas_j, cos_j = jops.fit_scores_many(rem.astype(np.float64), dem, s,
                                             e, inv, scored=True)
        np.testing.assert_array_equal(feas, feas_j)
        np.testing.assert_allclose(cos, cos_j, rtol=RTOL, atol=ATOL)

    def test_feasibility_boundary(self):
        """Exactly the demand left is feasible, 1e-3 less is not, and a
        float32 margin of exactly -1e-7 decides as the reference does."""
        T, D = 10, 2
        dem = np.array([0.5, 0.5], np.float32)
        rem = np.stack([
            np.full((T, D), 0.5, np.float32),
            np.full((T, D), 0.5 - 1e-3, np.float32),
            np.full((T, D), np.float32(0.5) - np.float32(1e-7), np.float32),
            np.full((T, D), np.float32(0.5) - np.float32(2e-7), np.float32),
        ])
        cap = np.ones(D, np.float32)
        feas, _ = tops.fit_scores(rem, dem, 0, T - 1, cap, device=CPU)
        feas_j, _ = jops.fit_scores(rem, dem, 0, T - 1, cap)
        assert feas[0] and not feas[1]
        np.testing.assert_array_equal(feas, feas_j)
        margin = tfit.fit_scores(_t(rem), _t(dem), 0, T - 1, _t(cap))[0]
        np.testing.assert_array_equal(
            margin.numpy(), (rem - dem).min(axis=(1, 2)))

    def test_span_masking(self):
        T, D = 12, 1
        rem = np.full((1, T, D), 1.0, np.float32)
        rem[0, 8:, 0] = 0.0
        dem = np.array([0.9], np.float32)
        one = np.ones(1, np.float32)
        feas, _ = tops.fit_scores(rem, dem, 0, 7, one, device=CPU)
        assert feas[0]
        feas, _ = tops.fit_scores(rem, dem, 0, 8, one, device=CPU)
        assert not feas[0]

    def test_wrapper_checks_shapes(self):
        rem = torch.ones((2, 3, 4, 2))
        s = torch.zeros(2, dtype=torch.int32)
        with pytest.raises(ValueError):
            tfit.fit_scores_many(rem, torch.ones((2, 3)), s, s,
                                 torch.ones((2, 2)))


def test_cpu_tensors_never_count_launches():
    before = (tcong.congestion_many.launches, tfit.fit_scores_many.launches,
              tfit.fit_scores.launches)
    s = torch.zeros((1, 4), dtype=torch.int32)
    tcong.congestion_many(s, s, torch.ones((1, 4, 2)), 3)
    tfit.fit_scores(torch.ones((2, 3, 2)), torch.ones(2), 0, 1, torch.ones(2))
    after = (tcong.congestion_many.launches, tfit.fit_scores_many.launches,
             tfit.fit_scores.launches)
    assert before == after


def test_plain_versions_are_generic_over_the_feature_axis():
    rng = np.random.default_rng(9)
    start, end = _spans(rng, 20, 10, 5)
    w = rng.random((20, 7)).astype(np.float32)
    a = tref.congestion_ref(_t(start), _t(end), _t(w), 10)
    b = tref.congestion_many_ref(_t(start)[None], _t(end)[None], _t(w)[None],
                                 10)[0]
    assert torch.equal(a, b)
