"""The work counts come from the instances' own shapes alone: each input
byte read once, each output byte written once, whatever the values."""

import numpy as np
import pytest

from bench import gen, work
from bench.reference.instance import trim


def instance(n, m, D, T, seed=0):
    return gen.synthetic_instance(np.random.default_rng(seed), n, m, D, T)


def nbytes(*arrays) -> int:
    return sum(a.nbytes for a in arrays)


@pytest.mark.parametrize("n,m,D,T", [(40, 3, 3, 12), (1000, 10, 5, 24),
                                     (1000, 10, 2, 997)])
def test_lp_counts_are_the_minimal_arrays(n, m, D, T):
    t = trim(instance(n, m, D, T))
    x = np.zeros((t.n, t.m), np.float32)          # the iterate
    dem = t.dem.astype(np.float32)                # the weights' factors
    cap = t.cap.astype(np.float32)
    spans = np.zeros((t.n, 2), np.int32)
    out = np.zeros((t.T, t.m, t.D), np.float32)   # congestion / dual
    fwd = nbytes(x, dem, cap, spans, out)
    assert work.congestion_apply_bytes(t) == fwd
    assert work.lp_iteration_bytes(t) == 2 * fwd


def test_counts_follow_shapes_not_values():
    a, b = trim(instance(200, 4, 3, 12, 1)), trim(instance(200, 4, 3, 12, 2))
    b = b._replace(T=a.T)   # the same trimmed shape, other values
    for fn in (work.congestion_apply_bytes, work.lp_iteration_bytes,
               work.placement_pass_bytes):
        assert fn(a) == fn(b)
        assert fn(a._replace(dem=a.dem * 3.0)) == fn(a)


def test_counts_take_the_trimmed_timeline():
    t = instance(30, 3, 2, 500)
    short = trim(t)
    assert short.T < t.T
    assert work.congestion_apply_bytes(short) == (
        work.congestion_apply_bytes(t) - (t.T - short.T) * t.m * t.D * 4)


def test_placement_pass_reads_each_task_once():
    t = trim(instance(100, 3, 4, 12))
    dem = t.dem.astype(np.float64)
    spans = np.zeros((t.n, 2), np.int32)
    node = np.zeros(t.n, np.int32)
    assert work.placement_pass_bytes(t) == nbytes(dem, spans, node)


def test_time_at_peak():
    assert work.seconds_at_peak(work.PEAK_BYTES_PER_S) == 1.0
