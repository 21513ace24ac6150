"""The tol LP's chunks as CUDA graphs (``core.batch._ChunkGraph``).

On the CPU no graph is recorded; the chunk body a capture records
(``_ChunkGraph._chunk``) is run eagerly through the graph's fixed buffers
and the step-factor table, chunk by chunk beside the eager loop, and every
carry field is compared bit for bit.  The key cache (``_take_graph``), the
buffers' one-solve-at-a-time rule and the launch bookkeeping are tested
directly.  The tests marked ``cuda`` replay real graphs on the card
(skipping where none is visible): bit-equal to the eager loop on Table-I
and GCT-shaped batches, the kernels' launch counts unchanged, a second
solve of a key replaying without a capture, a new T' capturing anew, a
one-chunk solve capturing nothing, and the sharded pipeline over two and
four cards bit-equal to the unsharded run.  This file imports no JAX.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import kernels, obs
from repro_torch.core import batch as tbatch
from repro_torch.workload import (SyntheticSpec, gct_like_instance,
                                  synthetic_instance)

COUNTERS = ("lp.chunks_eager", "lp.graph_captures", "lp.graph_replays")


def _fleet(k=3, n=30, m=4, D=3, T=10, seed=0):
    return [synthetic_instance(SyntheticSpec(n=n, m=m, D=D, T=T,
                                             seed=seed + s))
            for s in range(k)]


def _solve(fleet, device="cpu", **kw):
    kw = {"tol": 5e-3, "iters": 400, "operator": "pallas", **kw}
    return tbatch.solve_lp_many(fleet, full_output=True, device=device, **kw)


def _counted(fn):
    """``fn()`` under a CPU profile: its value and the graph counters of
    the step it ran in."""
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("evaluate"):
            out = fn()
    got = obs.steps()[-1]["counters"]
    return out, {k: got.get(k, 0) for k in COUNTERS}


def _assert_bit_equal(a, b):
    (ra, sa), (rb, sb) = a, b
    for x, y in zip(ra, rb):
        assert (x.iters, x.restarts, x.converged) == (y.iters, y.restarts,
                                                      y.converged)
        assert (x.objective, x.lower_bound, x.kkt) == (y.objective,
                                                       y.lower_bound, y.kkt)
        assert np.array_equal(x.x, y.x) and np.array_equal(x.mapping,
                                                           y.mapping)
    for f in ("x", "y", "eta", "omega"):
        u, v = getattr(sa.state, f), getattr(sb.state, f)
        assert (u is None and v is None) or np.array_equal(u, v), f


# (solver keywords, whether the solve starts from a previous one's state,
# the chunks run)
CASES = {
    "default": ({}, False, (25, 25, 25)),
    "fixed-steps": ({"adaptive": False}, False, (25, 25, 25)),
    "no-restarts": ({"restart": False}, False, (25, 25, 25)),
    "no-omega": ({"omega": False}, False, (25, 25, 25)),
    "f64": ({"precision": "f64"}, False, (25, 25, 25)),
    "unscaled-dense": ({"scaling": "none", "operator": "dense"}, False,
                       (25, 25, 25)),
    "cumsum": ({"operator": "cumsum"}, False, (25, 25, 25)),
    "warm": ({}, True, (25, 25, 25)),
    # a budget of 85 in chunks of 20 ends in a short one of 5; no lane
    # converges
    "max-iters": ({"tol": 1e-9}, False, (20, 20, 20, 20, 5)),
}


def _setup(fleet, kw, init=None):
    """``_tol_setup`` of ``fleet`` on the CPU as ``solve_lp_many`` makes it
    for these keywords: (ops, carry, fwd, adj, operator, flags)."""
    kw = {"tol": 5e-3, "operator": "pallas", "adaptive": True,
          "restart": True, "omega": True, "precision": "mixed",
          "scaling": "ruiz", **kw}
    batch = tbatch.pack_problems(fleet)
    operator = kw["operator"]
    if operator == "pallas" and kw["precision"] == "f64":
        operator = "cumsum"
    warm = {}
    if init is not None:
        x0, y0, eta, omega = tbatch._align_state(init, batch)
        warm = dict(x0=torch.from_numpy(x0), y0=torch.from_numpy(y0),
                    eta_init=torch.tensor(eta, dtype=torch.float32),
                    omega_init=torch.tensor(omega, dtype=torch.float32))
    w_dt = torch.float64 if kw["precision"] == "f64" else torch.float32
    ops, c, fwd, adj, _ = tbatch._tol_setup(
        *tbatch._device_arrays(batch, w_dt, torch.device("cpu")),
        tbatch._f32(0.9), batch.Tp, operator, tbatch._POWER_ITERS,
        kw["scaling"], kw["precision"], kw["omega"], **warm)
    flags = (tbatch._f32(kw["tol"]), kw["adaptive"], kw["restart"],
             kw["omega"])
    return ops, c, fwd, adj, operator, flags, batch.Tp


@pytest.mark.parametrize("case", list(CASES))
def test_graph_chunk_body_is_bit_equal_to_the_eager_loop(case):
    """Chunk by chunk, the body a capture records, run through the graph's
    buffers with the factor table's slice, leaves every carry field as the
    eager loop with its float32 scalars does."""
    kw, warm, chunks = CASES[case]
    init = _solve(_fleet(seed=10), iters=60)[1].state if warm else None
    ops, c, fwd, adj, operator, flags, Tp = _setup(_fleet(), kw, init)
    attempt, check = tbatch._tol_chunk_fns(fwd, adj, ops, *flags)
    table = tbatch._eta_table(sum(chunks), c.x.dtype, torch.device("cpu"))
    eager, through = c, dataclasses.replace(c)
    graphs = {}
    for chunk in chunks:
        k = eager.k
        for _ in range(chunk):
            attempt(eager, tbatch._eta_factors(eager.k))
        check(eager)
        g = graphs.get(chunk)
        if g is None:
            g = graphs[chunk] = tbatch._ChunkGraph(ops, through, chunk, Tp,
                                                   operator, *flags)
            g.load(ops)
        g.hold(through)
        g.factors.copy_(table[k:k + chunk])
        g._chunk()
        for f in tbatch._CARRY:
            want, got = getattr(eager, f), getattr(through, f)
            assert got is g.carry[f]
            assert torch.equal(got, want) or (
                got.isnan().equal(want.isnan())
                and torch.equal(got.nan_to_num(), want.nan_to_num())), f
    assert eager.k == sum(chunks)
    if case == "max-iters":
        assert not bool(eager.conv.any())


def test_eager_runs_count_their_chunks():
    (res, st), got = _counted(lambda: _solve(_fleet()))
    assert got["lp.graph_replays"] == got["lp.graph_captures"] == 0
    assert got["lp.chunks_eager"] == -(-int(st.iterations.max()) // 25)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_factor_table_holds_the_eager_factors(dtype):
    table = tbatch._eta_table(4000, dtype, torch.device("cpu"))
    want = torch.tensor([tbatch._eta_factors(k) for k in range(4000)],
                        dtype=torch.float64)
    assert table.dtype == dtype and table.shape == (4000, 2)
    assert torch.equal(table.double(), want)
    # float32 values: the eager scalars widen to them exactly
    assert torch.equal(want.float().double(), want)


def test_a_key_warms_up_then_captures_once():
    graphs, made = collections.OrderedDict(), []

    def make():
        made.append(object())
        return made[-1]

    assert tbatch._take_graph(graphs, "a", make) is None
    assert made == []
    g = tbatch._take_graph(graphs, "a", make)
    assert made == [g]
    assert tbatch._take_graph(graphs, "a", make) is g
    assert len(made) == 1 and list(graphs) == ["a"]


def test_the_cache_keeps_the_newest_keys():
    graphs = collections.OrderedDict()
    n = tbatch._GRAPHS_PER_DEVICE
    for key in range(n):
        tbatch._take_graph(graphs, key, object)
        tbatch._take_graph(graphs, key, object)
    tbatch._take_graph(graphs, 0, object)        # 0 is the newest now
    for key in range(n, n + 2):
        tbatch._take_graph(graphs, key, object)  # seen once: kept as None
    assert list(graphs) == [n - 1, 0, n, n + 1]
    assert graphs[n] is None and graphs[0] is not None


def test_a_failed_capture_drops_its_key():
    graphs = collections.OrderedDict()
    tbatch._take_graph(graphs, "a", object)

    def fail():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        tbatch._take_graph(graphs, "a", fail)
    assert "a" not in graphs
    # the key starts over: an eager chunk, then a capture
    assert tbatch._take_graph(graphs, "a", object) is None
    assert tbatch._take_graph(graphs, "a", object) is not None


def test_a_graph_in_use_refuses_a_second_solve():
    ops, c, _, _, operator, flags, Tp = _setup(_fleet(), {})
    g = tbatch._ChunkGraph(ops, c, 25, Tp, operator, *flags)
    g.load(ops)
    assert all(torch.equal(g.ops[k], v) for k, v in ops.items()
               if v is not None)
    with pytest.raises(RuntimeError, match="one solve at a time"):
        g.load(ops)
    g.in_use = False
    g.load(ops)


def test_a_failed_shard_closes_the_others():
    """A shard that raises leaves no other shard's solve suspended, so no
    chunk graph stays in use."""
    closed = []

    def steps(d, lanes):
        try:
            yield
            if lanes == 0:
                raise RuntimeError("shard 0 failed")
            yield
        finally:
            closed.append(lanes)

    cpu = torch.device("cpu")
    with pytest.raises(RuntimeError, match="shard 0 failed"):
        tbatch._run_shards(steps, [(cpu, 0), (cpu, 1)])
    assert sorted(closed) == [0, 1]


def test_rewound_launches_add_back_per_replay():
    kernels.reset_launch_counts()
    kernels.WRAPPERS["lane_sum"].launches = 2
    marks = kernels.launch_marks()
    kernels.WRAPPERS["lane_sum"].launches += 5
    kernels.WRAPPERS["congestion_many"].launches += 3
    kernels.congestion._BY_CARD[1] += 3
    added = kernels.rewind_launches(marks)
    assert added == ({"lane_sum": 5, "congestion_many": 3}, {1: 3})
    assert kernels.launch_marks() == marks
    for _ in range(2):
        kernels.add_launches(added)
    counts, by_card = kernels.launch_marks()
    assert counts["lane_sum"] == 12 and counts["congestion_many"] == 6
    assert by_card == {1: 6}
    kernels.reset_launch_counts()


# --- on the card -----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _shaped(shape):
    if shape == "table1":   # B = 64, n = 1000, m = 10, D = 5, T' = 24
        return [synthetic_instance(SyntheticSpec(seed=s)) for s in range(64)]
    # B = 64 trace instances: D = 2, T' about 997
    return [gct_like_instance(n=1000, m=10, seed=s, cost_model="gce")
            for s in range(64)]


TAKE = tbatch._take_graph


def _graphs_on(monkeypatch, on: bool):
    """The real key cache, or none: every chunk of every key eager."""
    monkeypatch.setattr(tbatch, "_take_graph",
                        TAKE if on else lambda graphs, key, make: None)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["table1", "gct"])
def test_replay_is_bit_equal_to_the_eager_loop_on_the_card(dev, monkeypatch,
                                                           shape):
    fleet = _shaped(shape)
    kw = {"tol": 5e-3, "iters": 4000, "operator": "pallas"}
    runs, launches = {}, {}
    monkeypatch.setattr(tbatch, "_DEVICE_GRAPHS", {})
    for mode in ("eager", "graph", "graph again"):
        _graphs_on(monkeypatch, mode != "eager")
        kernels.reset_launch_counts()
        runs[mode], got = _counted(lambda: _solve(fleet, device=dev, **kw))
        torch.cuda.synchronize()
        launches[mode] = kernels.launch_counts()
        if mode == "graph":
            assert got["lp.graph_captures"] == 1
            assert got["lp.graph_replays"] >= 1
        if mode == "graph again":
            assert got["lp.graph_captures"] == got["lp.chunks_eager"] == 0
    for mode in ("graph", "graph again"):
        _assert_bit_equal(runs[mode], runs["eager"])
        assert launches[mode] == launches["eager"]
    kernels.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("operator,precision", [
    ("dense", "mixed"), ("cumsum", "mixed"), ("pallas", "f64")])
def test_other_operators_replay_bit_equal_on_the_card(dev, monkeypatch,
                                                      operator, precision):
    fleet = _fleet(k=8, n=200, m=6, D=4, T=16)
    kw = {"tol": 1e-3, "iters": 4000, "operator": operator,
          "precision": precision}
    monkeypatch.setattr(tbatch, "_DEVICE_GRAPHS", {})
    _graphs_on(monkeypatch, False)
    want = _solve(fleet, device=dev, **kw)
    _graphs_on(monkeypatch, True)
    for _ in range(2):
        got, c = _counted(lambda: _solve(fleet, device=dev, **kw))
        assert c["lp.graph_replays"] >= 1
        _assert_bit_equal(got, want)


@pytest.mark.cuda
def test_keys_capture_once_and_replay_on_the_card(dev, monkeypatch):
    monkeypatch.setattr(tbatch, "_DEVICE_GRAPHS", {})
    kw = {"tol": 1e-3, "iters": 4000}
    _, a = _counted(lambda: _solve(_fleet(k=8, n=200), device=dev, **kw))
    _, b = _counted(lambda: _solve(_fleet(k=8, n=200, seed=9), device=dev,
                                   **kw))
    _, c = _counted(lambda: _solve(_fleet(k=8, n=200, T=9), device=dev,
                                   **kw))
    _, d = _counted(lambda: _solve(_fleet(k=8, n=200, T=7), device=dev,
                                   tol=0.9))
    assert a["lp.graph_captures"] == 1 and a["lp.chunks_eager"] == 1
    assert b["lp.graph_captures"] == b["lp.chunks_eager"] == 0
    assert c["lp.graph_captures"] == 1 and c["lp.chunks_eager"] == 1
    assert d == {"lp.chunks_eager": 1, "lp.graph_captures": 0,
                 "lp.graph_replays": 0}
    # every solve gave its graphs' buffers back
    (dg,) = tbatch._DEVICE_GRAPHS.values()
    assert not any(g.in_use for g in dg.graphs.values() if g is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [2, 4])
def test_sharded_pipeline_over_cards_is_bit_equal(dev, cards):
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA cards")
    from repro_torch.core import FleetEngine, SolverConfig, SweepConfig

    grid = [synthetic_instance(SyntheticSpec(n=n, m=4, D=3, T=12, seed=s))
            for n in (40, 50) for s in range(4)]
    solver = SolverConfig(tol=5e-3, iters=4000, operator="pallas")
    runs, counts = zip(*(_counted(lambda d=d: FleetEngine(
        solver=solver, device=dev, sweep=SweepConfig(
            warm_start=4, pipeline=True, devices=d)).evaluate(grid))
        for d in (None, cards)))
    # the cards replay their chunks
    assert counts[1]["lp.graph_replays"] >= cards
    for a, b in zip(runs[0].lp_results, runs[1].lp_results):
        assert (a.iters, a.restarts, a.converged) == (b.iters, b.restarts,
                                                      b.converged)
        assert (a.objective, a.lower_bound) == (b.objective, b.lower_bound)
        assert np.array_equal(a.x, b.x)
