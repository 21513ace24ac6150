"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA card (sm_90a) and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Every test here is marked ``cuda`` and skips, with its reason, where no card
is visible; whether a card is present is decided inside a fixture, so every
pytest worker collects the same tests.  This file imports no JAX.
Tolerances: congestion rtol/atol 1e-5 (float32 sums in another order; two
launches on the same inputs bit-equal); fit margin bit-equal, dot/norm
rtol/atol 1e-5; the placement stepper bit-equal (node choices, counts and
the pool after the sub-phase); the two_phase kernel bit-equal (counts,
stopping tasks, attempts and every task's node), also where ``rows`` is too
small and it stops; a tolerance-mode solve on the card against the same
solve on the CPU (objectives within the gap two tol-converged solves can
show, tol * (2 + both objectives + both bounds), certified bounds crossing,
costs equal wherever the two canonical mappings are), and the pipelined
sweep against the sequential chain (the same arithmetic: mappings and costs
equal, objectives within that gap); the float64 cumsum forward bit-equal
over repeated applies and within 1e-12 of the dense form on the CPU; the
constrained and GCT-like shapes (a lowered D of 14, T' about 995, pool rows
of about 2000 doubles that spill) held as above, the shapes the kernels do
not take refused with ``ValueError`` before any launch, and a constrained
fleet's plans on the card equal to the CPU's and clean under the oracle;
the serving loop in the kernel configuration ticked to its end twice with
bit-equal plans and reports (all but the wall-clock fields), every plan clean
under the oracle and every tick's compiled placements equal to the numpy
lockstep engine's.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import congestion as cong
from repro_torch.kernels import fit, ref
from repro_torch.kernels import place_step as kstep

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


def _padded_spans(g, shape, T):
    """Spans with a point task, the TPU contract's padding [1, 0] and the
    pack's padding [0, 0] (given zero weight by the caller)."""
    s, e = _spans(g, shape, T)
    if shape[-1] > 2:
        e[..., 0] = s[..., 0]
        s[..., 1], e[..., 1] = 1, 0
        s[..., 2], e[..., 2] = 0, 0
    return s, e


# G=1; n below one slice and far above slices x CTA; T' of 1, 24, 33, 200
# (one tile, several, a ragged last one); K of 1, 5, 50
@pytest.mark.parametrize("G,n,T,K", [
    (1, 5, 24, 5), (1, 1000, 24, 5), (2, 5000, 33, 1), (3, 300, 200, 50),
    (4, 77, 1, 50), (1, 3, 200, 1), (7, 4096, 24, 50),
])
def test_congestion_edges_match_plain(dev, G, n, T, K):
    g = torch.Generator().manual_seed(G * 13 + n + T)
    s, e = _padded_spans(g, (G, n), T)
    w = torch.rand((G, n, K), generator=g)
    if n > 2:
        w[:, 2] = 0.0
    s, e, w = s.to(dev), e.to(dev), w.to(dev)
    got = cong.congestion_many(s, e, w, T)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.congestion_many_ref(s, e, w, T),
                               rtol=TOL, atol=TOL)


def _lp_inputs(g, B, n, m, D, T, dev):
    s, e = _padded_spans(g, (B, n), T)
    w = torch.rand((B, n, m, D), generator=g)
    x = torch.rand((B, n, m), generator=g)
    if n > 2:
        w[:, 2] = 0.0
    return [t.to(dev) for t in (s, e, w, x)]


# the main path's shape (16 Table-I instances: n=1000, m=10, D=5, T'=24)
# and the edges: m*D of 1, 5, 50 and wider, T' of 1, 24, 33, 200
@pytest.mark.parametrize("B,n,m,D,T", [
    (16, 1000, 10, 5, 24), (1, 1000, 10, 5, 24), (1, 5, 1, 1, 1),
    (2, 5000, 1, 5, 33), (3, 300, 10, 5, 200), (2, 77, 50, 1, 24),
    (2, 9, 5, 10, 33), (1, 40, 40, 100, 3),
])
def test_congestion_lp_matches_plain(dev, B, n, m, D, T):
    g = torch.Generator().manual_seed(B * 31 + n + m + T)
    s, e, w, x = _lp_inputs(g, B, n, m, D, T, dev)
    before = cong.congestion_many.launches
    got = cong.congestion_lp(s, e, w, x, T)
    torch.cuda.synchronize()
    assert cong.congestion_many.launches == before + 1
    assert got.shape == (B, T, m, D) and got.is_contiguous()
    torch.testing.assert_close(got, ref.congestion_lp_ref(s, e, w, x, T),
                               rtol=TOL, atol=TOL)


def test_congestion_launches_are_deterministic(dev):
    g = torch.Generator().manual_seed(5)
    s, e, w, x = _lp_inputs(g, 16, 1000, 10, 5, 24, dev)
    a = cong.congestion_lp(s, e, w, x, 24)
    b = cong.congestion_lp(s, e, w, x, 24)
    wg = w.reshape(16, 1000, 50).contiguous()
    c = cong.congestion_many(s, e, wg, 24)
    d = cong.congestion_many(s, e, wg, 24)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)


def test_congestion_lp_rejects_what_the_kernel_does_not_take(dev):
    s = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    w = torch.rand((2, 8, 3, 2), device=dev)
    x = torch.rand((2, 8, 3), device=dev)
    with pytest.raises(TypeError):
        cong.congestion_lp(s, s, w, x.double(), 4)
    with pytest.raises(TypeError):
        cong.congestion_lp(s.long(), s, w, x, 4)
    with pytest.raises(ValueError):
        cong.congestion_lp(s, s, w, x[:, :4], 4)
    with pytest.raises(ValueError, match="contiguous"):
        cong.congestion_lp(s, s, w, x.transpose(1, 2).contiguous()
                           .transpose(1, 2), 4)
    with pytest.raises(ValueError, match="device"):
        cong.congestion_lp(s, s, w, x.cpu(), 4)
    # wider than one CTA's partial sums can hold: refused before a launch
    wide = torch.rand((1, 8, 9000), device=dev)
    before = cong.congestion_many.launches
    with pytest.raises(ValueError, match="at most 8192 columns, got K=9000"):
        cong.congestion_many(s[:1], s[:1], wide, 4)
    assert cong.congestion_many.launches == before


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


def _sub_phase_inputs(g, A, L, T, D, dem_scale, w0_max, purchase):
    """A random sub-phase: A lanes of up to L start-sorted attempts over T
    slots, the last dimension padded (+inf capacity, zero demand)."""
    f64 = torch.float64
    cap = 0.5 + torch.rand((A, D), generator=g, dtype=f64)
    cap[:, -1] = 1.0
    capx = cap.clone()
    capx[:, -1] = torch.inf
    dem = torch.rand((L, A, D), generator=g, dtype=f64) * dem_scale
    dem[..., -1] = 0.0
    s = torch.sort(torch.randint(0, T, (L, A), generator=g), dim=0).values
    e = torch.clamp(s + torch.randint(0, T // 2 + 1, (L, A), generator=g),
                    max=T - 1)
    dn = 0.5 + torch.rand((L, A), generator=g, dtype=f64)
    lens = torch.randint(0, L + 1, (A,), generator=g).to(torch.int32)
    w = torch.randint(0, w0_max + 1, (A,), generator=g).to(torch.int32)
    n_cap = w0_max + (L if purchase else 0)
    pool = cap.repeat(1, T)[:, None, :].expand(A, n_cap, T * D).clone()
    if not purchase:  # open rows already partly used
        pool -= torch.rand(pool.shape, generator=g, dtype=f64) * 0.3
    rows = n_cap if purchase else w0_max
    return [pool, w, lens, dem, s.to(torch.int32), e.to(torch.int32), dn,
            capx, cap], rows


@pytest.mark.parametrize("similarity", [False, True])
@pytest.mark.parametrize("A,L,T,D,dem_scale,w0_max,purchase", [
    (1, 1, 1, 2, 0.3, 0, True),
    (160, 120, 24, 6, 0.3, 0, True),      # type-parallel width
    (16, 300, 24, 6, 0.2, 0, True),       # wave width, long lists
    (16, 200, 24, 6, 0.2, 40, False),     # cross-fill into open rows
    (3, 60, 300, 9, 0.6, 0, True),        # rows of 21.6 KB: most spill
])
def test_place_step_matches_plain(dev, similarity, A, L, T, D, dem_scale,
                                  w0_max, purchase):
    g = torch.Generator().manual_seed(A * 31 + L + D)
    args, rows = _sub_phase_inputs(g, A, L, T, D, dem_scale, w0_max,
                                   purchase)
    want_args = [t.to(dev) for t in args]
    got_args = [t.to(dev) for t in args]
    want = ref.sub_phase_ref(*want_args, 1e9, purchase, similarity)
    before = kstep.sub_phase.launches
    info = {}
    got = kstep.sub_phase(*got_args, 1e9, purchase, similarity, rows=rows,
                          telemetry=info)
    torch.cuda.synchronize()
    assert kstep.sub_phase.launches == before + 1
    assert 0 <= info["smem_rows"] <= rows
    assert torch.equal(got, want)
    assert torch.equal(got_args[0], want_args[0])
    if T == 300:
        assert int(got[:A].max()) > info["smem_rows"]  # the spill path ran


def test_compiled_placement_on_the_card(dev):
    import numpy as np

    from repro_torch.core import penalty_map, place_many
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    fleet = [synthetic_instance(SyntheticSpec(n=80, m=4, D=3, T=12, seed=s))
             for s in range(4)]
    maps = [penalty_map(p, "avg") for p in fleet]
    for fit in ("first", "similarity"):
        for filling in (False, True):
            tel = {}
            reset_launch_counts()
            got = place_many(fleet, maps, fit=fit, filling=filling,
                             placement="compiled", telemetry=tel)
            assert launch_counts()["place_step"] == tel["dispatches"] > 0
            want = place_many(fleet, maps, fit=fit, filling=filling,
                              device="cpu")
            for a, b in zip(got, want):
                assert np.array_equal(a.assign, b.assign)
                assert np.array_equal(a.node_type, b.node_type)


def test_compiled_placement_has_no_pool_cap_on_the_card(dev, monkeypatch):
    import numpy as np

    from repro_torch.core import penalty_map, place_many
    from repro_torch.core import place_step as core_step
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    # the CPU's cell cap sends a CPU call to the numpy engine; on the card
    # the stepper runs whatever the pool's size
    monkeypatch.setattr(core_step, "MAX_POOL_CELLS", 0)
    fleet = [synthetic_instance(SyntheticSpec(n=40, m=3, D=2, T=10, seed=s))
             for s in range(2)]
    maps = [penalty_map(p, "avg") for p in fleet]
    for filling in (False, True):
        tel = {}
        got = place_many(fleet, maps, filling=filling, placement="compiled",
                         telemetry=tel)
        assert tel["engine"] == "compiled" and "fallback" not in tel
        assert tel["mode"] == ("wave-sequential" if filling
                               else "type-parallel")
        want = place_many(fleet, maps, filling=filling, device="cpu")
        for a, b in zip(got, want):
            assert np.array_equal(a.assign, b.assign)
            assert np.array_equal(a.node_type, b.node_type)


def _walk_inputs(rng, n, P, D, T, dem_scale, filling, unfit):
    """A random single-instance walk (the ``two_phase`` kernel's inputs):
    tasks mapped to P phases, own parts in start order, cross-fill parts of
    the later phases' tasks (filling only).  With ``unfit`` one task's
    demand exceeds its phase's capacity.  Returns (args, rank of each task's
    phase, rows)."""
    cap = 0.5 + rng.random((P, D))
    dem = rng.random((n, D)) * dem_scale * cap.min()
    start = rng.integers(0, T, n)
    end = np.minimum(start + rng.integers(0, T // 2 + 1, n), T - 1)
    phase = rng.integers(0, P, n)
    if unfit:
        u = int(rng.integers(0, n))
        dem[u] = cap[phase[u]] * 1.5
    parts = []
    for p in range(P):
        mine = np.flatnonzero(phase == p)
        parts.append(mine[np.lexsort((mine, start[mine]))])
        later = np.flatnonzero(phase > p) if filling else np.zeros(0, int)
        parts.append(rng.permutation(later))
    ends = np.cumsum([0] + [len(x) for x in parts])
    bounds = np.stack([ends[0:-1:2], ends[1::2], ends[2::2]], axis=1)
    i32, f64 = torch.int32, torch.float64
    args = [torch.as_tensor(np.concatenate(parts), dtype=i32),
            torch.as_tensor(bounds, dtype=i32), torch.as_tensor(cap, dtype=f64),
            torch.as_tensor(dem, dtype=f64), torch.as_tensor(start, dtype=i32),
            torch.as_tensor(end, dtype=i32),
            torch.as_tensor(0.5 + rng.random(n), dtype=f64)]
    rows = max(int((phase == p).sum()) for p in range(P))
    return args, phase, rows


@pytest.mark.parametrize("similarity", [False, True])
@pytest.mark.parametrize("filling", [False, True])
@pytest.mark.parametrize("n,P,D,T,dem_scale,unfit", [
    (1, 1, 1, 1, 0.3, False),
    (200, 4, 5, 23, 0.2, False),     # a Table-I-like walk
    (1000, 10, 5, 23, 0.3, False),   # Table I's width
    (300, 2, 8, 200, 0.9, False),    # rows of 12.8 KB: most spill
    (120, 3, 3, 12, 0.3, True),      # a task no node of its type holds
    (60, 5, 32, 4, 0.2, False),      # the widest D the kernel takes
])
def test_two_phase_kernel_matches_plain(dev, similarity, filling, n, P, D, T,
                                        dem_scale, unfit):
    rng = np.random.default_rng(n * 7 + P + D + int(unfit))
    args, phase, rows = _walk_inputs(rng, n, P, D, T, dem_scale, filling,
                                     unfit)
    want = ref.two_phase_ref(*args, T, 1e9, similarity, filling, rows)
    before = kstep.two_phase_walk.launches
    info = {}
    got = kstep.two_phase_walk(*[t.to(dev) for t in args], T, 1e9,
                               similarity, filling, rows, telemetry=info)
    torch.cuda.synchronize()
    assert kstep.two_phase_walk.launches == before + 1
    assert torch.equal(got.cpu(), want)
    w, bad, _, placed_in, _ = kstep.split_walk(want.numpy(), P, n)
    assert (bad >= 0).any() == unfit
    if T == 200:
        assert int(w.max()) > info["smem_rows"]  # the spill path ran
    if filling and n >= 200:
        # cross-fill placed tasks of later phases, whose own entries the
        # walk then skipped
        assert (placed_in != phase).any()


@pytest.mark.parametrize("filling", [False, True])
@pytest.mark.parametrize("rows", [0, 2])
def test_two_phase_kernel_stops_where_rows_run_out(dev, filling, rows):
    """Phases that need more than ``rows`` nodes stop with bad = -2 instead
    of writing past the pool, bit-equal to the plain version, and the
    wrapper raises."""
    rng = np.random.default_rng(11 + rows)
    args, _, _ = _walk_inputs(rng, 120, 3, 3, 12, 0.9, filling, False)
    want = ref.two_phase_ref(*args, 12, 1e9, True, filling, rows)
    bad = kstep.split_walk(want.numpy(), 3, 120)[1]
    assert (bad == -2).any()
    got = kstep._launch_walk(*[t.to(dev) for t in args], 12, 1e9, True,
                             filling, rows, None)
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match=f"rows={rows}"):
        kstep.two_phase_walk(*[t.to(dev) for t in args], 12, 1e9, True,
                             filling, rows)


@pytest.mark.parametrize("steps", [0, 1, 1000])
def test_barrier_chain_counts_its_steps(dev, steps):
    from repro_torch.kernels import build

    out = torch.full((1,), -1, dtype=torch.int32, device=dev)
    err = build.load("place_step").barrier_chain_launch(
        steps, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0 and int(out.item()) == steps


def test_two_phase_route_launches_once_per_call(dev):
    from repro_torch.core import ALGORITHMS, penalty_map, rightsize, two_phase
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    p = synthetic_instance(SyntheticSpec(n=80, m=4, D=3, T=12, seed=3))
    mapping = penalty_map(p, "avg")
    for fit in ("first", "similarity"):
        for filling in (False, True):
            reset_launch_counts()
            got = two_phase(p, mapping, fit=fit, filling=filling,
                            backend="kernel")
            counts = launch_counts()
            assert counts["two_phase"] == 1 and counts["fit_scores"] == 0
            want = two_phase(p, mapping, fit=fit, filling=filling,
                             device="cpu")
            assert np.array_equal(got.assign, want.assign)
            assert np.array_equal(got.node_type, want.node_type)
    reset_launch_counts()
    for algo in ALGORITHMS:
        a = rightsize(p, algo, backend="kernel")
        b = rightsize(p, algo, device="cpu")
        assert a.cost(p) == b.cost(p)
        assert np.array_equal(a.assign, b.assign)
    counts = launch_counts()
    assert counts["two_phase"] == 4 + 4 + 2 + 2 and counts["fit_scores"] == 0


def _tol_slack(a, b, tol=5e-3):
    """Objective gap two tol-converged solves of one LP can show."""
    return tol * (2.0 + a.objective + a.lower_bound
                  + b.objective + b.lower_bound)


def test_cumsum_operator_is_deterministic_on_the_card(dev):
    from repro_torch.core import batch as tbatch

    g = torch.Generator().manual_seed(5)
    B, n, m, D, T = 4, 1000, 10, 5, 24
    s, e = _spans(g, (B, n), T)
    w = torch.rand((B, n, m, D), generator=g, dtype=torch.float64)
    x = torch.rand((B, n, m), generator=g, dtype=torch.float64)
    fwd, _ = tbatch._make_operators(w.to(dev), s.to(dev), e.to(dev), T,
                                    "cumsum")
    got = [fwd(x.to(dev)) for _ in range(3)]
    assert all(torch.equal(got[0], o) for o in got[1:])
    fwd_cpu, _ = tbatch._make_operators(w, s, e, T, "dense")
    torch.testing.assert_close(got[0].cpu(), fwd_cpu(x), rtol=1e-12,
                               atol=1e-12)


def test_tol_solve_on_the_card_matches_the_cpu(dev):
    from repro_torch.core import FleetEngine, SolverConfig
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    fleet = [synthetic_instance(SyntheticSpec(n=200, m=6, D=4, T=16, seed=s))
             for s in range(4)]
    solver = SolverConfig(tol=5e-3, iters=4000, operator="pallas")
    before = cong.congestion_many.launches
    got = FleetEngine(solver=solver, algos=("lp-map",)).evaluate(fleet)
    torch.cuda.synchronize()
    launches = cong.congestion_many.launches - before
    want = FleetEngine(solver=solver, algos=("lp-map",),
                       device="cpu").evaluate(fleet)
    # 12 power iterations, the initial apply, one per attempt
    (st,) = got.stats
    assert launches == 13 + int(st.iterations.max())
    assert st.converged.all() and want.stats[0].converged.all()
    for i, (g, w) in enumerate(zip(got.lp_results, want.lp_results)):
        assert abs(g.objective - w.objective) <= _tol_slack(g, w)
        assert g.lower_bound <= w.objective * (1 + 1e-6)
        assert w.lower_bound <= g.objective * (1 + 1e-6)
        # another summation order moves the tolerance-stopped iterate, and
        # canonical rounding of a degenerate LP may then pick another
        # type; where both solves round alike, the placement is the same
        if np.array_equal(g.mapping, w.mapping):
            assert got.entries[i]["costs"] == want.entries[i]["costs"]


def test_tol_pipeline_on_the_card_matches_the_sequential_chain(dev):
    from repro_torch.core import (FleetEngine, SolverConfig, SweepConfig,
                                  dispatch_count)
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    fleet = [synthetic_instance(SyntheticSpec(n=n, m=5, D=3, T=12, seed=s))
             for n in (120, 140, 160) for s in range(2)]
    runs = {}
    for pipeline in (False, True):
        eng = FleetEngine(solver=SolverConfig(tol=5e-3, iters=4000,
                                              operator="pallas"),
                          sweep=SweepConfig(warm_start=2, pipeline=pipeline),
                          algos=("lp-map", "lp-map-f"))
        before = dispatch_count()
        runs[pipeline] = eng.evaluate(fleet)
        assert dispatch_count() - before == (1 if pipeline else 3)
    for a, b in zip(runs[False].lp_results, runs[True].lp_results):
        assert np.array_equal(a.mapping, b.mapping)
        assert abs(a.objective - b.objective) <= _tol_slack(a, b)
    for a, b in zip(runs[False].entries, runs[True].entries):
        assert a["costs"] == b["costs"]


# --- the constrained and GCT-like shapes ---------------------------------

# a lowered Table-I instance (D = 5 + exclusivity + 8 anti-affinity groups,
# n shortened by the affinity merges) and GCT-like T' of about 995 (D=2)
@pytest.mark.parametrize("B,n,m,D,T", [
    (16, 968, 10, 14, 24), (16, 1000, 10, 2, 995), (1, 1000, 10, 2, 993)])
def test_congestion_lp_at_the_slice_shapes(dev, B, n, m, D, T):
    g = torch.Generator().manual_seed(B + n + D + T)
    s, e, w, x = _lp_inputs(g, B, n, m, D, T, dev)
    got = cong.congestion_lp(s, e, w, x, T)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.congestion_lp_ref(s, e, w, x, T),
                               rtol=TOL, atol=TOL)


def test_congestion_refuses_wide_shapes_before_a_launch(dev):
    s = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    before = cong.congestion_many.launches
    with pytest.raises(ValueError, match=r"m\*D=8200"):
        cong.congestion_lp(s, s, torch.rand((1, 8, 10, 820), device=dev),
                           torch.rand((1, 8, 10), device=dev), 4)
    cong.congestion_lp(s, s, torch.rand((1, 8, 8, 1024), device=dev),
                       torch.rand((1, 8, 8), device=dev), 4)  # 8192 runs
    torch.cuda.synchronize()
    assert cong.congestion_many.launches == before + 1


@pytest.mark.parametrize("similarity", [False, True])
@pytest.mark.parametrize("A,L", [(119, 120), (16, 200)])
def test_place_step_spills_gct_like_rows(dev, similarity, A, L):
    """Pool rows of K = 995 * 2 doubles (15.9 KB): only a few fit the
    shared-memory budget (14 rows at A=119), the rest take the spill path;
    demands of up to 0.6 of a node open a node every task or two."""
    g = torch.Generator().manual_seed(A + L)
    args, rows = _sub_phase_inputs(g, A, L, 995, 2, 0.6, 0, True)
    want_args = [t.to(dev) for t in args]
    got_args = [t.to(dev) for t in args]
    want = ref.sub_phase_ref(*want_args, 1e9, True, similarity)
    info = {}
    got = kstep.sub_phase(*got_args, 1e9, True, similarity, rows=rows,
                          telemetry=info)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_args[0], want_args[0])
    assert int(got[:A].max()) > info["smem_rows"]  # the spill path ran


def test_place_step_refuses_more_than_256_dimensions(dev):
    g = torch.Generator().manual_seed(3)
    args, rows = _sub_phase_inputs(g, 2, 3, 2, 257, 0.001, 0, True)
    before = kstep.sub_phase.launches
    with pytest.raises(ValueError, match="D <= 256, got 257"):
        kstep.sub_phase(*[t.to(dev) for t in args], 1e9, True, False,
                        rows=rows)
    assert kstep.sub_phase.launches == before


def test_constrained_fleet_on_the_card(dev):
    import dataclasses

    from repro_torch.core import (FleetEngine, PlacementConfig, SolverConfig,
                                  TaskConstraints, check_plan, rightsize)
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    fleet = []
    for s in range(3):
        p = synthetic_instance(SyntheticSpec(n=60, m=4, D=3, T=12, seed=s))
        c = TaskConstraints.from_groups(
            p.n, affinity={"a": (0, 1)}, anti_affinity={"s": (2, 3, 4)},
            exclusive=(5, 6), deadlines={7: int(p.end[7])})
        fleet.append(dataclasses.replace(p, constraints=c))
    solver = SolverConfig(tol=5e-3, iters=4000, operator="pallas")
    got = FleetEngine(solver=solver,
                      placement=PlacementConfig(engine="compiled")
                      ).evaluate(fleet)
    want = FleetEngine(solver=solver, device="cpu").evaluate(fleet)
    for i, (g, w) in enumerate(zip(got.lp_results, want.lp_results)):
        assert g.converged and w.converged
        assert g.lower_bound <= w.objective * (1 + 1e-6)
        assert w.lower_bound <= g.objective * (1 + 1e-6)
        if np.array_equal(g.mapping, w.mapping):
            assert got.entries[i]["costs"] == want.entries[i]["costs"]
    for p, r in zip(fleet, got.lp_results):
        for algo in ("penalty-map-f", "lp-map-f"):
            a = rightsize(p, algo, backend="kernel", lp_result=r)
            b = rightsize(p, algo, lp_result=r, device="cpu")
            assert np.array_equal(a.assign, b.assign)
            assert check_plan(p, a) == []


def _serve_on_the_card():
    """A two-fleet GCT-like trace through the serving loop in the kernel
    configuration (the congestion kernel on every LP apply, the compiled
    stepper on every placement sub-phase), ticked to its end.  Returns the
    service and, per tick, each placement call's inputs and compiled
    placements."""
    from repro_torch.core import (FleetEngine, PlacementConfig, SolverConfig,
                                  engine)
    from repro_torch.serve import (RightsizingService, TraceSpec, gct_trace,
                                   replay)

    svc = RightsizingService(engine=FleetEngine(
        solver=SolverConfig(tol=5e-3, iters=4000, operator="pallas"),
        placement=PlacementConfig(engine="compiled"), algos=("lp-map-f",)))
    calls, place = [], engine.place_many

    def recorded(batch, maps, **kw):
        tel: dict = {}
        sols = place(batch, maps, telemetry=tel, **kw)
        assert tel["engine"] == "compiled", tel
        calls.append((svc._tick, batch, [np.array(m) for m in maps], kw,
                      sols))
        return sols

    engine.place_many = recorded
    try:
        replay(svc, gct_trace(TraceSpec(fleets=2, requests=40, n0=60, m=5,
                                        seed=3)), push_per_tick=6)
    finally:
        engine.place_many = place
    return svc, calls


def _deterministic(svc) -> dict:
    rep = svc.report()
    for key in ("wall_s", "requests_per_s", "p50_replan_s", "p99_replan_s"):
        rep.pop(key)
    return {"report": rep,
            "ticks": [{k: v for k, v in t.to_dict().items()
                       if k not in ("solve_s", "place_s", "total_s")}
                      for t in svc.ticks],
            "plans": {f: svc.fleet(f).plan.tolist() for f in svc.fleets},
            "assign": {f: svc.fleet(f).solution.assign.tolist()
                       for f in svc.fleets},
            "events": [e.to_dict() for e in svc.events]}


def test_serving_loop_on_the_card_is_deterministic_and_clean(dev):
    from repro_torch.core import check_plan

    a, calls = _serve_on_the_card()
    b, _ = _serve_on_the_card()
    rep = a.report()
    assert rep["dispatches_per_tick"] == 1 and rep["converged_frac"] == 1.0
    assert rep["ticks"] > 2 and rep["warm_lanes"] > 0
    assert _deterministic(a) == _deterministic(b)
    for name in a.fleets:
        st = a._fleets[name]
        assert check_plan(st.problem, st.solution) == []
    assert calls


def test_serving_loop_placements_equal_the_lockstep_engine(dev):
    from repro_torch.core import place_many

    _, calls = _serve_on_the_card()
    ticks = {c[0] for c in calls}
    assert len(ticks) > 2
    for tick, batch, maps, kw, sols in calls:
        want = place_many(batch, maps, fit=kw["fit"], filling=kw["filling"],
                          device="cpu")
        for lane, (g, w) in enumerate(zip(sols, want)):
            assert np.array_equal(g.assign, w.assign), (tick, lane)
            assert np.array_equal(g.node_type, w.node_type), (tick, lane)
