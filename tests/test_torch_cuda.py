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
of about 2000 doubles that spill) held as above, and so the wide shapes
(congestion columns past one tile, the steppers' D past 32 and 256, rows
that spill; the congestion launch plan unchanged wherever the columns fit
one tile, against ``tests/_torch_congestion_plan.py``), and a constrained
fleet's plans on the card equal to the CPU's and clean under the oracle;
the serving loop in the kernel configuration ticked to its end twice with
bit-equal plans and reports (all but the wall-clock fields), every plan clean
under the oracle and every tick's compiled placements equal to the numpy
lockstep engine's; stochastic planning in the same configuration (one LP
dispatch, 13 + the most iterations congestion launches, stepper launches =
dispatches), its scenario plans and costs equal to the numpy lockstep
engine's on the same LP mappings, two calls bit-equal, and ``preprovision``
growing a served fleet's plan.  The LM serving path (no kernel of its own):
every architecture's smoke config in float32, one model run on the CPU and
then on the card, logits and decode states within 1e-4 abs (a local window
of 8 below the 12-token prompt), integer state leaves and MoE slots equal
(``tests/_torch_lm_card.py``, shared with ``chip_smoke.py`` phase 13c), and
``launch.serve`` on the card by default.  The LM training path (no kernel of
its own either): every architecture's smoke config in float32, one
``loss_fn`` (remat, a padded loss chunk) and backward on the CPU and on the
card, loss within 1e-4 abs and every gradient within 1e-4 of its own max
|value|, MoE slots equal in forward and recompute
(``tests/_torch_train_card.py``, shared with ``chip_smoke.py`` phase 14b);
``launch.train`` on the card by default; a CPU checkpoint restored onto the
card bit-equal.  The recurrences (``wkv.cu``, ``scan.cu``): the WKV forward
and backward (the chunked kernels, at lengths around and between their
64-step chunks, a tenth of the decays exactly 0) within 1e-4 of each
output's max |value| of the plain loops
(bfloat16 outputs within two bfloat16 roundings more), the linear scan
bit-equal to its plain loops (both round the multiply and the add apart),
the launch plan equal to the plan rule's transcription
(``tests/_torch_scan_tiles.py``) and the path's blocks resident at once,
the model's decay gradients through the chunked backward within 1e-4 of
each one's max |value| of the CPU's where half the decays underflow, and
the recurrent smoke models launching them.  The lane-sum kernel
(``lane_sum.cu``) bit-equal to ``ref.lane_sum_ordered`` (its order of adds)
in float32 and float64, one launch a call (two past one chunk), a lane alone
bit-equal to the same lane in a batch, and within the ordered sum's bound
plus torch's own sum's of torch's sum; the sharded sweep pipeline on one card
(``devices=1``) bit-equal lane for lane to the unsharded run.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import congestion as cong
from repro_torch.kernels import fit, ref
from repro_torch.kernels import lane_sum as klane
from repro_torch.kernels import place_step as kstep
from _torch_stepper_inputs import sub_phase_inputs as _sub_phase_inputs
from _torch_stepper_inputs import walk_inputs as _walk_inputs

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


# columns past one CTA's partial sums: K = 9000 for the TPU contract, the
# LP's m * D = 8280 (30 types, 276 lowered dimensions) and 8200; T' of 1, 3,
# 4, 24 and 40 (tiles of at least min(T', 8) slots)
@pytest.mark.parametrize("G,n,T,K", [(1, 8, 4, 9000), (3, 300, 40, 9000),
                                     (2, 50, 1, 8193)])
def test_congestion_many_past_one_column_tile(dev, G, n, T, K):
    g = torch.Generator().manual_seed(G + n + T + K)
    s, e = _spans(g, (G, n), T)
    w = torch.rand((G, n, K), generator=g)
    s, e, w = s.to(dev), e.to(dev), w.to(dev)
    before = cong.congestion_many.launches
    got = cong.congestion_many(s, e, w, T)
    torch.cuda.synchronize()
    assert cong.congestion_many.launches == before + 1
    torch.testing.assert_close(got, ref.congestion_many_ref(s, e, w, T),
                               rtol=TOL, atol=TOL)
    plan = cong.launch_plan(G, n, 1, K, T, lp=False)
    assert (plan["c_tile"], plan["c_tiles"]) == cong.column_tiles(K, T)
    assert plan["c_tiles"] > 1 and plan["t_tile"] >= min(T, 8)


@pytest.mark.parametrize("B,n,m,D,T", [
    (2, 300, 30, 276, 24), (4, 1000, 30, 276, 24), (1, 40, 10, 820, 4),
    (2, 64, 3, 5000, 3), (1, 33, 1, 9000, 1)])
def test_congestion_lp_past_one_column_tile(dev, B, n, m, D, T):
    g = torch.Generator().manual_seed(B + n + m + D + T)
    s, e, w, x = _lp_inputs(g, B, n, m, D, T, dev)
    before = cong.congestion_many.launches
    got = cong.congestion_lp(s, e, w, x, T)
    again = cong.congestion_lp(s, e, w, x, T)
    torch.cuda.synchronize()
    assert cong.congestion_many.launches == before + 2
    assert torch.equal(got, again)  # no atomics: the same bits each launch
    torch.testing.assert_close(got, ref.congestion_lp_ref(s, e, w, x, T),
                               rtol=TOL, atol=TOL)
    plan = cong.launch_plan(B, n, m, D, T)
    assert (plan["c_tile"], plan["c_tiles"]) == cong.column_tiles(m * D, T)
    assert plan["c_tiles"] > 1 and plan["smem_bytes"] <= 227 * 1024


# the shapes phases 3-12 of chip_smoke.py give the kernel, whose columns
# fit one tile: the plan is the one the kernel picked before it tiled them
@pytest.mark.parametrize("B,n,m,D,T,lp", [
    (16, 1000, 10, 5, 24, True), (160, 1000, 1, 5, 24, False),
    (1, 1000, 1, 5, 24, False), (16, 968, 10, 14, 24, True),
    (16, 1000, 10, 2, 997, True), (64, 1000, 10, 2, 993, True),
    (2, 3000, 3, 2, 33, True), (1, 8, 8, 1024, 4, True),
    (5, 513, 1, 9, 33, False)])
def test_launch_plan_is_unchanged_where_the_columns_fit(dev, B, n, m, D, T,
                                                       lp):
    from _torch_congestion_plan import one_tile_plan

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    got = cong.launch_plan(B, n, m, D, T, lp=lp)
    want = one_tile_plan(B, n, m, D, T, lp, sms)
    assert {k: got[k] for k in want} == want
    assert (got["c_tile"], got["c_tiles"]) == (m * D, 1)


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


@pytest.mark.parametrize("similarity", [False, True])
@pytest.mark.parametrize("filling", [False, True])
@pytest.mark.parametrize("n,P,D,T,dem_scale,unfit", [
    (1, 1, 1, 1, 0.3, False),
    (200, 4, 5, 23, 0.2, False),     # a Table-I-like walk
    (1000, 10, 5, 23, 0.3, False),   # Table I's width
    (300, 2, 8, 200, 0.9, False),    # rows of 12.8 KB: most spill
    (120, 3, 3, 12, 0.3, True),      # a task no node of its type holds
    (60, 5, 32, 4, 0.2, False),      # one dimension per scheduler lane
    (200, 4, 33, 12, 0.3, False),    # past one warp's lanes
    (300, 5, 64, 24, 0.3, False),
    (400, 10, 276, 24, 0.3, False),  # rows of 53 KB: most spill
    (150, 3, 276, 24, 0.3, True),
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
    if T == 200 or D == 276:
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


def test_congestion_takes_both_sides_of_one_tile_in_one_launch(dev):
    s = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    before = cong.congestion_many.launches
    for m, D in ((10, 820), (8, 1024)):  # 8200 columns: two tiles; 8192: one
        w = torch.rand((1, 8, m, D), device=dev)
        x = torch.rand((1, 8, m), device=dev)
        torch.testing.assert_close(cong.congestion_lp(s, s, w, x, 4),
                                   ref.congestion_lp_ref(s, s, w, x, 4),
                                   rtol=TOL, atol=TOL)
    torch.cuda.synchronize()
    assert cong.congestion_many.launches == before + 2


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


@pytest.mark.parametrize("similarity", [False, True])
@pytest.mark.parametrize("A,L,T,D,dem_scale,w0_max,purchase", [
    (2, 3, 2, 257, 0.001, 0, True),
    (16, 40, 24, 257, 0.3, 0, True),     # past one dimension per thread
    (8, 30, 24, 600, 0.2, 0, True),      # rows of 115 KB: most spill
    (16, 40, 12, 300, 0.2, 20, False),   # cross-fill into open rows
    (120, 60, 24, 276, 0.3, 0, True),    # phase 10c's type-parallel width
])
def test_place_step_takes_any_width(dev, similarity, A, L, T, D, dem_scale,
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
    assert torch.equal(got, want)
    assert torch.equal(got_args[0], want_args[0])
    if D >= 600:
        assert int(got[:A].max()) > info["smem_rows"]  # the spill path ran


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


def _card_engine():
    from repro_torch.core import FleetEngine, PlacementConfig, SolverConfig

    return FleetEngine(solver=SolverConfig(tol=5e-3, iters=4000,
                                           operator="pallas"),
                       placement=PlacementConfig(engine="compiled"),
                       algos=("lp-map-f",))


def _plan_on_the_card(K=8):
    """``plan_stochastic`` on a small GCT-like forecast in the kernel
    configuration, probed: the result, the LP results of its one
    ``solve_scenarios`` call, each placement call's inputs, telemetry and
    placements, and the launches of the run."""
    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.stochastic import (StochasticConfig, gct_forecast,
                                        plan_stochastic)

    eng = _card_engine()
    lp, calls = [], []
    solve, place = eng.solve_scenarios, engine.place_many

    def solved(problems):
        out = solve(problems)
        lp.append(out[0])
        return out

    def placed(batch, maps, **kw):
        tel: dict = {}
        sols = place(batch, maps, telemetry=tel, **kw)
        calls.append((batch, maps, kw, tel, sols))
        return sols

    eng.solve_scenarios = solved
    engine.place_many = placed
    try:
        kernels.reset_launch_counts()
        res = plan_stochastic(
            gct_forecast(n=60, m=4, seed=1, burst_prob=0.15),
            StochasticConfig(scenarios=K, cvar_lambda=2.0), engine=eng)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        engine.place_many = place
    return res, lp, calls, launches


def test_stochastic_plan_on_the_card_launches_and_places_as_numpy(dev):
    from repro_torch.core import place_many

    res, lp, calls, launches = _plan_on_the_card()
    s = res.summary()
    assert res.lp_dispatches == 1 and res.buckets == 1 and len(lp) == 1
    assert s["converged_frac"] == 1.0
    assert launches["congestion_many"] == 13 + int(
        res.stats[0].iterations.max())
    dispatches = sum(tel["dispatches"] for *_, tel, _ in calls)
    assert all(tel["engine"] == "compiled" for *_, tel, _ in calls)
    assert launches["place_step"] == dispatches > 0
    assert launches["fit_scores_many"] == launches["two_phase"] == 0
    best = np.full(res.K, np.inf)
    plans = np.zeros_like(res.scenario_plans)
    for batch, maps, kw, _, sols in calls:
        want = place_many(batch, maps, fit=kw["fit"], filling=kw["filling"],
                          device="cpu")
        for b, (g, w, t) in enumerate(zip(sols, want, batch.problems)):
            assert np.array_equal(g.assign, w.assign), (kw, b)
            assert np.array_equal(g.node_type, w.node_type), (kw, b)
            if w.cost(t) < best[b]:
                best[b], plans[b] = w.cost(t), w.nodes_per_type(t)
    assert np.array_equal(best, res.scenario_costs)
    assert np.array_equal(plans, res.scenario_plans)
    assert s["mean_scenario_cost"] <= s["fleet_cost"] + 1e-6
    assert s["fleet_cost"] <= s["max_fleet_cost"] + 1e-6


def test_stochastic_plan_on_the_card_is_deterministic(dev):
    a = _plan_on_the_card()[0]
    b = _plan_on_the_card()[0]
    assert a.summary() == b.summary()
    assert np.array_equal(a.scenario_costs, b.scenario_costs)


def test_preprovision_on_the_card(dev):
    from repro_torch.core.batch import dispatch_count
    from repro_torch.serve import RightsizingService, TraceSpec, gct_trace, \
        replay
    from repro_torch.stochastic import StochasticConfig

    svc = RightsizingService(engine=_card_engine())
    replay(svc, gct_trace(TraceSpec(fleets=2, requests=20, n0=60, m=5,
                                    seed=3)), push_per_tick=6)
    name = svc.fleets[0]
    before = svc.fleet(name).plan.copy()
    sol = svc._fleets[name].solution
    d0 = dispatch_count()
    res = svc.preprovision(name, config=StochasticConfig(scenarios=8))
    assert dispatch_count() - d0 == 1 and res.lp_dispatches == 1
    after = svc.fleet(name).plan
    assert (after >= before).all()
    assert svc._fleets[name].solution is sol
    ev = svc.events[-1]
    assert ev.scope == "preprovision" and ev.fleet == name
    assert ev.cost_after == float(
        after @ svc._fleets[name].problem.node_types.cost)


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-1b", "granite-34b",
                                  "kimi-k2-1t-a32b", "olmoe-1b-7b",
                                  "qwen2-vl-2b", "qwen2.5-3b",
                                  "recurrentgemma-9b", "rwkv6-7b",
                                  "whisper-small"])
def test_lm_smoke_on_the_card_matches_the_cpu(dev, arch):
    from _torch_lm_card import card_vs_cpu

    got = card_vs_cpu(arch, dev)
    assert got["logits"] <= 1e-4 and got["states"] <= 1e-4, got
    assert got["ints_equal"] and got["moe_equal"], got


def test_lm_serve_runs_on_the_card_by_default(dev, capsys):
    from repro_torch.launch import serve as lm_serve

    out = lm_serve.run(["--batch", "2", "--prompt-len", "10", "--gen", "3"])
    assert out.device.type == "cuda" and tuple(out.shape) == (2, 3)
    assert capsys.readouterr().out.startswith("prefill: batch=2 len=10")


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-1b", "granite-34b",
                                  "kimi-k2-1t-a32b", "olmoe-1b-7b",
                                  "qwen2-vl-2b", "qwen2.5-3b",
                                  "recurrentgemma-9b", "rwkv6-7b",
                                  "whisper-small"])
def test_lm_training_on_the_card_matches_the_cpu(dev, arch):
    from _torch_train_card import train_card_vs_cpu

    got = train_card_vs_cpu(arch, dev)
    assert got["loss"] <= 1e-4 and got["aux"] <= 1e-4, got
    assert got["grad_rel"] <= 1e-4 and got["moe_equal"], got


def test_lm_train_runs_on_the_card_by_default(dev, tmp_path, capsys):
    from repro_torch.launch import train as lm_train

    model, state, hist = lm_train.run(
        ["--steps", "3", "--ckpt-dir", str(tmp_path)])
    assert model.device.type == "cuda" and len(hist["loss"]) == 3
    assert state["opt"]["m"]["embed"].device.type == "cuda"
    assert capsys.readouterr().out.startswith("config: qwen2.5-3b-smoke")


def test_checkpoint_restores_onto_the_card(dev, tmp_path):
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.train import TrainConfig, checkpoint, init_train_state

    cfg = smoke_config("gemma3-1b")
    model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = init_train_state(model, TrainConfig())
    checkpoint.save(str(tmp_path), (model, state), 4)
    (m2, s2), step = checkpoint.restore(str(tmp_path), (model, state))
    assert step == 4 and m2.device.type == "cuda"
    for (n, a), (_n, b) in zip(model.named_parameters(),
                               m2.named_parameters()):
        assert torch.equal(a, b.cpu()), n
    assert s2["opt"]["step"].device.type == "cuda"


# --- the recurrences (wkv.cu, scan.cu) ---------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,N", [(1, 1, 1, 8), (2, 70, 3, 16),
                                     (1, 33, 2, 32), (2, 65, 4, 64),
                                     (1, 63, 2, 64), (1, 128, 1, 16)])
def test_wkv_matches_plain(dev, dtype, B, S, H, N):
    """Forward and backward (the chunked kernels, chunks of 64 steps)
    against the plain loops, at lengths around and between chunks: float32
    outputs within 1e-4 of each one's max |value| (sums in another order),
    bfloat16 ones within two bfloat16 roundings more; a tenth of the decays
    exactly 0 (log-decays -inf, or below the kernels' clamp)."""
    from repro_torch.kernels import wkv as kwkv

    g = torch.Generator(device=dev).manual_seed(B * S + N)
    r, k, v = (torch.randn((B, S, H, N), generator=g, device=dev) * 0.5
               for _ in range(3))
    r, k, v = r.to(dtype), k.to(dtype), v.to(dtype)
    lw = -torch.exp(torch.randn((B, S, H, N), generator=g, device=dev) - 2.0)
    pick = torch.rand(lw.shape, generator=g, device=dev)
    lw[pick < 0.05] = -float("inf")
    lw[(pick >= 0.05) & (pick < 0.1)] = -2000.0
    u = torch.randn((H, N), generator=g, device=dev)
    gy = torch.randn((B, S, H, N), generator=g, device=dev)
    gs = torch.randn((B, H, N, N), generator=g, device=dev)
    before = (kwkv.wkv_forward.launches, kwkv.wkv_backward_launch.launches)
    got = kwkv.wkv_forward(r, k, v, lw, u) + kwkv.wkv_backward_launch(
        r, k, v, lw, u, gy, gs)
    torch.cuda.synchronize()
    assert (kwkv.wkv_forward.launches, kwkv.wkv_backward_launch.launches) \
        == (before[0] + 1, before[1] + 1)
    want = ref.wkv_ref(r, k, v, lw, u) + ref.wkv_backward_ref(
        r, k, v, lw, u, gy, gs)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.double(), b.double()
        rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
        lim = rtol * b.abs() + 1e-4 * float(b.abs().max())
        assert bool(((a - b).abs() <= lim).all())


def test_wkv_decay_gradients_where_decays_underflow(dev):
    """The model's parameter gradients through ``timemix_scan`` on the card
    (the chunked backward) against the CPU's plain reverse loop, with about
    half the decays underflowing to 0 and lw down to about -17000: every
    gradient, ``w_decay``, ``decay_bias`` and ``mu_w`` among them, within
    1e-4 of its max |value| (``tests/_torch_wkv_decay.py``).  The kernel's
    glw is exactly 0 where exp(lw) is, as the loop's gw * w is; the chain
    rule scales glw by |lw| there."""
    from _torch_wkv_decay import RTOL as GRAD_RTOL
    from _torch_wkv_decay import timemix_grads, worst

    from repro_torch.kernels import wkv as kwkv

    want = timemix_grads("cpu")
    before = kwkv.wkv_backward_launch.launches
    got = timemix_grads(dev)
    assert kwkv.wkv_backward_launch.launches == before + 1
    errs = worst(got, want, want)
    assert max(errs.values()) < GRAD_RTOL, errs


def test_wkv_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels import wkv as kwkv

    x = torch.zeros((1, 2, 1, 128), device=dev)
    with pytest.raises(ValueError, match="N in"):
        kwkv.wkv_forward(x, x, x, x, torch.zeros((1, 128), device=dev))
    x = torch.zeros((1, 2, 1, 16), device=dev)
    # every other column: strided for real (a transpose about a dimension
    # of size 1 still counts as contiguous)
    strided = torch.zeros((1, 2, 1, 32), device=dev)[..., ::2]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        kwkv.wkv_forward(x, x, x, strided, torch.zeros((1, 16), device=dev))


# W not a multiple of 4 or 32, S not a multiple of a time tile, B * W below
# one block, and the path's shape
@pytest.mark.parametrize("B,S,W", [(1, 1, 1), (2, 7, 300), (1, 65, 33),
                                   (3, 300, 4098), (4, 513, 4096),
                                   (4, 4100, 4096)])
def test_linear_scan_is_bit_equal_to_plain(dev, B, S, W):
    from repro_torch.kernels import scan as kscan

    g = torch.Generator(device=dev).manual_seed(S + W)
    a = torch.rand((B, S, W), generator=g, device=dev)
    b = torch.randn((B, S, W), generator=g, device=dev)
    gh = torch.randn((B, S, W), generator=g, device=dev)
    h = kscan.scan_forward(a, b)
    assert torch.equal(h, ref.linear_scan_ref(a, b))
    got = kscan.scan_backward(a, h, gh)
    want = ref.linear_scan_backward_ref(a, h, gh)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_linear_scan_on_unaligned_views_is_bit_equal(dev):
    """Tensors that start 4 bytes past a 16-byte boundary take the kernels'
    4-byte copies."""
    from repro_torch.kernels import scan as kscan

    B, S, W = 2, 70, 36
    g = torch.Generator(device=dev).manual_seed(1)
    a, b, gh = (torch.rand(B * S * W + 1, generator=g, device=dev)[1:].view(
        B, S, W) for _ in range(3))
    assert a.data_ptr() % 16 != 0
    h = kscan.scan_forward(a, b)
    assert torch.equal(h, ref.linear_scan_ref(a, b))
    got = kscan.scan_backward(a, h, gh)
    want = ref.linear_scan_backward_ref(a, h, gh)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("B,S,W", [(1, 1, 1), (2, 7, 300), (1, 65, 33),
                                   (3, 300, 4098), (1, 4100, 4096),
                                   (4, 2048, 4096), (4, 4100, 4096),
                                   (2, 12, 64)])
def test_linear_scan_plan_is_the_rule(dev, B, S, W, backward):
    """The built kernel's launch plan equals the plan rule's transcription
    (``tests/_torch_scan_tiles.py``, which the CPU tests walk), and the
    card holds every block of the path's shapes at once."""
    from _torch_scan_tiles import plan as scan_plan

    from repro_torch.kernels import scan as kscan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    got = kscan.launch_plan(B, W, backward=backward)
    want = scan_plan(B, W, backward, sms)
    assert {k: got[k] for k in want} == want
    assert got["resident"] >= 1
    if (B, W) == (4, 4096):
        assert got["blocks"] <= got["resident"] * sms, got


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_recurrent_smoke_goes_through_the_kernels(dev, arch):
    """The smoke models' prefill on the card launches the recurrence's
    kernel once per recurrent layer, and training its backward too."""
    from _torch_lm_card import card_vs_cpu
    from _torch_train_card import train_card_vs_cpu

    from repro_torch import kernels

    name = {"rwkv6-7b": "wkv", "recurrentgemma-9b": "linear_scan"}[arch]
    kernels.reset_launch_counts()
    card_vs_cpu(arch, dev)
    assert kernels.launch_counts()[name] > 0
    train_card_vs_cpu(arch, dev)
    assert kernels.launch_counts()[name + "_backward"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,dims", [
    ((16, 24, 10, 5), (1, 3)), ((16, 1000, 10), (1, 2)),
    ((4, 24, 10, 5), (1, 2, 3)), ((1, 1, 1, 1), (1, 3)), ((3, 7), (1,)),
    ((2, 997, 14, 3), (1, 3)), ((3, 40000), (1,))])
def test_lane_sum_matches_its_order(dev, shape, dims, dtype):
    g = torch.Generator().manual_seed(len(shape) + shape[-1])
    x = torch.randn(shape, generator=g, dtype=dtype).to(dev)
    B, R1, M, R2 = ref.lane_view(shape, dims)
    before = klane.lane_sum.launches
    got = klane.lane_sum(x, dims)
    torch.cuda.synchronize()
    assert klane.lane_sum.launches == before + (1 if R1 * R2 <= klane.CHUNK
                                                else 2)
    assert torch.equal(got, ref.lane_sum_ordered(x, dims, klane.CHUNK))
    for b in (0, shape[0] - 1):
        assert torch.equal(klane.lane_sum(x[b:b + 1].clone(), dims),
                           got[b:b + 1])
    # both orders within depth * eps * sum |x| of the exact sum; torch's
    # depth is taken as the kernel's
    depth = klane.CHUNK // 256 + 10 + 2 * 10
    slack = 2 * depth * torch.finfo(dtype).eps * x.abs().double().sum(
        dim=dims, keepdim=True)
    assert bool(((got.double() - x.sum(dim=dims, keepdim=True).double())
                 .abs() <= slack).all())


def test_sharded_sweep_on_one_card_is_the_pipelined_run(dev):
    from repro_torch.core import FleetEngine, SolverConfig, SweepConfig
    from repro_torch.workload import SyntheticSpec, sweep_specs, synthetic_batch

    grid = synthetic_batch(sweep_specs(SyntheticSpec(n=60, m=4, D=3, T=12),
                                       seeds=2, n=(40, 50)))
    solver = SolverConfig(tol=5e-3, iters=4000, operator="pallas")
    runs = [FleetEngine(solver=solver, device=dev, sweep=SweepConfig(
        warm_start=2, pipeline=True, devices=d)).evaluate(grid)
        for d in (None, 1)]
    for a, b in zip(runs[0].lp_results, runs[1].lp_results):
        assert (a.iters, a.restarts, a.converged) == (b.iters, b.restarts,
                                                      b.converged)
        assert (a.objective, a.lower_bound) == (b.objective, b.lower_bound)
        assert np.array_equal(a.x, b.x)
