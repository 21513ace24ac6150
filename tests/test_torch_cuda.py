"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA card (sm_90a) and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Every test here is marked ``cuda`` and skips, with its reason, where no card
is visible; whether a card is present is decided inside a fixture, so every
pytest worker collects the same tests.  This file imports no JAX.
Tolerances: congestion rtol/atol 1e-5; fit margin bit-equal, dot/norm
rtol/atol 1e-5.
"""

import pytest
import torch

from repro_torch.kernels import congestion as cong
from repro_torch.kernels import fit, ref

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _spans(g, shape, T):
    s = torch.randint(0, T, shape, generator=g, dtype=torch.int32)
    ln = torch.randint(0, max(T // 2, 1), shape, generator=g,
                       dtype=torch.int32)
    return s, torch.clamp(s + ln, max=T - 1)


@pytest.mark.parametrize("G,n,T,K", [(1, 1, 1, 1), (3, 37, 1, 2),
                                     (160, 1000, 24, 5), (5, 513, 33, 9)])
def test_congestion_matches_plain(dev, G, n, T, K):
    g = torch.Generator().manual_seed(G + n)
    s, e = _spans(g, (G, n), T)
    if n > 2:
        e[:, 0] = s[:, 0]          # a point task
        s[:, 1], e[:, 1] = 1, 0    # a never-active padding task
    w = torch.rand((G, n, K), generator=g)
    s, e, w = s.to(dev), e.to(dev), w.to(dev)
    before = cong.congestion_many.launches
    got = cong.congestion_many(s, e, w, T)
    torch.cuda.synchronize()
    assert cong.congestion_many.launches == before + 1
    torch.testing.assert_close(got, ref.congestion_many_ref(s, e, w, T),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,N,T,D", [(1, 1, 1, 1), (3, 33, 1, 2),
                                     (16, 41, 24, 5), (2, 9, 300, 7)])
def test_fit_matches_plain(dev, B, N, T, D):
    g = torch.Generator().manual_seed(B * 7 + N)
    rem = torch.rand((B, N, T, D), generator=g)
    dem = torch.rand((B, D), generator=g) * 0.2
    inv = 1.0 / (0.2 + torch.rand((B, D), generator=g))
    s, e = _spans(g, (B,), T)
    rem, dem, inv, s, e = (x.to(dev) for x in (rem, dem, inv, s, e))
    got = fit.fit_scores_many(rem, dem, s, e, inv)
    want = ref.fit_scores_many_ref(rem, dem, ref.span_mask(s, e, T), inv)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    one = fit.fit_scores(rem[0], dem[0], int(s[0]), int(e[0]), inv[0])
    torch.cuda.synchronize()
    assert torch.equal(one[0], want[0][0])
    for a, b in zip(one[1:], want[1:]):
        torch.testing.assert_close(a, b[0], rtol=TOL, atol=TOL)


def test_fit_boundary_margin(dev):
    dem = torch.tensor([[0.5, 0.25]])
    rem = torch.stack([dem[0].expand(10, 2), (dem[0] - 1e-7).expand(10, 2)])
    rem = rem[None].clone()
    rem[0, :, 8:] = 0.0  # outside the span [0, 7]
    s = torch.tensor([0], dtype=torch.int32)
    e = torch.tensor([7], dtype=torch.int32)
    got = fit.fit_scores_many(rem.to(dev), dem.to(dev), s.to(dev), e.to(dev),
                              torch.ones((1, 2), device=dev))[0].cpu()
    assert torch.equal(got, (rem[0, :, :8] - dem[0]).amin(dim=(1, 2))[None])


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    w = torch.rand((2, 8, 3), device=dev)
    s = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cong.congestion_many(s, s, w.transpose(0, 1).contiguous()
                             .transpose(0, 1), 4)
    with pytest.raises(TypeError):
        cong.congestion_many(s, s, w.double(), 4)


def test_fleet_path_launches_both_batched_kernels(dev):
    from repro_torch.core import FleetEngine, PlacementConfig, SolverConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    fleet = [synthetic_instance(SyntheticSpec(n=40, m=3, D=2, T=10, seed=s))
             for s in range(2)]
    reset_launch_counts()
    res = FleetEngine(solver=SolverConfig(operator="pallas", iters=50),
                      placement=PlacementConfig(backend="kernel")
                      ).evaluate(fleet)
    counts = launch_counts()
    assert counts["congestion_many"] == 50 + 13
    assert counts["fit_scores_many"] > 0
    plain = FleetEngine(solver=SolverConfig(operator="pallas", iters=50),
                        placement=PlacementConfig(backend="kernel"),
                        device="cpu").evaluate(fleet)
    for a, b in zip(res.entries, plain.entries):
        assert a["lb"] == pytest.approx(b["lb"], rel=1e-4)
