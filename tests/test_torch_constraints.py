"""The port's constraint layer and feasibility oracle on the CPU, against the
reference (``repro.core.constraints`` / ``repro.core.checker``).

The same numpy-seeded instances and constraint sets go through both
packages.  Everything here is host numpy, so agreement is exact:

  * ``TaskConstraints``: the same arrays, names and validation messages;
  * lowering: every ``Lowering`` array equal (dem, start, end, cap, cost,
    row_of, widths, end_eff, identity) on the seeded constrained instances
    of the reference's own generator scheme, and the same ``ValueError``
    message wherever the reference rejects a set;
  * ``check_plan``: the same violation strings on hand-made and corrupted
    plans;
  * ``rightsize``: the same placements for penalty-map(-f), and for
    lp-map(-f) given the same LP mapping; every plan passes both oracles;
  * the lockstep, compiled and looped placement engines agree on lowered
    instances;
  * a small constrained ``FleetEngine.evaluate``: lower bounds rel 1e-4 and
    costs rel 1e-5 (``PERF.md`` §2's legacy bounds: two float32 PDHG
    trajectories).
"""

import dataclasses

import numpy as np
import pytest

import repro.core as J
from repro.workload import SyntheticSpec as JSpec
from repro.workload import synthetic_instance as j_synthetic_instance
import repro_torch.core as T
from repro_torch.convert import constraints_from, problem_from_arrays

LB_REL = 1e-4
COST_REL = 1e-5
SEEDS = range(14)


def _tiny(pkg, n=2, D=1, cap=((4.0,),), cost=(1.0,), dem=None, start=None,
          end=None, T=4, constraints=None):
    """A hand-sized instance of ``pkg`` (the reference's ``_tiny``)."""
    nt = pkg.NodeTypes(cap=np.array(cap), cost=np.array(cost))
    return pkg.Problem(
        dem=np.ones((n, D)) if dem is None else np.array(dem, float),
        start=np.zeros(n, np.int64) if start is None else
        np.array(start, np.int64),
        end=np.full(n, T - 1, np.int64) if end is None else
        np.array(end, np.int64),
        node_types=nt, T=T, constraints=constraints)


def _both(build):
    """``build(pkg)`` for the reference and the port."""
    return build(J), build(T)


def _outcome(fn):
    """``fn()``'s value, or its exception's type name and message."""
    try:
        return fn()
    except Exception as exc:  # compared between packages
        return (type(exc).__name__, str(exc))


def _same_constraints(a, b):
    for f in ("deadline", "affinity", "anti_affinity", "exclusive",
              "max_width", "serial_frac"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.affinity_names == b.affinity_names
    assert a.anti_names == b.anti_names
    assert a.n == b.n and a.is_vacuous() == b.is_vacuous()


def _same_problem(a, b):
    for f in ("dem", "start", "end"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    np.testing.assert_array_equal(a.node_types.cap, b.node_types.cap)
    np.testing.assert_array_equal(a.node_types.cost, b.node_types.cost)
    assert a.node_types.names == b.node_types.names
    assert a.T == b.T


def _same_lowering(a, b):
    _same_problem(a.lowered, b.lowered)
    assert a.lowered.constraints is None and b.lowered.constraints is None
    for f in ("row_of", "widths", "end_eff"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.identity == b.identity


def _candidates(seed):
    """The reference's ``_constrained_instance`` scheme (tests/
    test_constraints.py), copied: a random synthetic instance and its
    constraint sets, strongest first; the lowerer takes the first set it
    accepts (drop affinity, then widths, then one exclusive task)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 30))
    spec = JSpec(n=n, m=int(rng.integers(2, 5)), D=int(rng.integers(1, 4)),
                 T=int(rng.integers(6, 16)),
                 seed=int(rng.integers(0, 2**31 - 1)))
    p = j_synthetic_instance(spec)
    pool = list(rng.permutation(n))

    def pop(k):
        return [int(pool.pop()) for _ in range(min(k, len(pool)))]

    deadlines = {u: int(rng.integers(int(p.end[u]), p.T))
                 for u in pop(int(rng.integers(1, 4)))}
    widths = {}
    for u in pop(int(rng.integers(0, 3))):
        w, f = int(rng.integers(2, 5)), float(rng.uniform(0.0, 0.6))
        widths[u] = (w, f)
        dur0 = int(p.end[u] - p.start[u] + 1)
        fastest = int(p.start[u]) + int(J.width_duration(dur0, w, f)) - 1
        deadlines[u] = int(rng.integers(fastest, int(p.end[u]) + 1))
    affinity = {"aff0": pop(2)} if rng.random() < 0.7 else {}
    anti = {"anti0": pop(int(rng.integers(2, 4)))} \
        if rng.random() < 0.7 else {}
    exclusive = pop(int(rng.integers(0, 3)))
    return p, [
        dict(deadlines=deadlines, affinity=affinity, anti_affinity=anti,
             exclusive=exclusive, widths=widths),
        dict(deadlines=deadlines, anti_affinity=anti,
             exclusive=exclusive, widths=widths),
        dict(deadlines={u: d for u, d in deadlines.items()
                        if u not in widths},
             anti_affinity=anti, exclusive=exclusive),
        dict(exclusive=[0]),
    ]


def _constrained(seed):
    """(reference problem, port problem, reference lowering, port lowering)
    for the first candidate set the reference lowers; every rejected set
    must be rejected by the port with the same message."""
    p, cands = _candidates(seed)
    for cand in cands:
        jp = dataclasses.replace(
            p, constraints=J.TaskConstraints.from_groups(p.n, **cand))
        tp = dataclasses.replace(
            problem_from_arrays(p),
            constraints=T.TaskConstraints.from_groups(p.n, **cand))
        _same_constraints(jp.constraints, tp.constraints)
        want = _outcome(lambda: J.lower_constraints(jp))
        got = _outcome(lambda: T.lower_constraints(tp))
        if isinstance(want, tuple):
            assert got == want
            continue
        return jp, tp, want, got
    raise AssertionError("exclusive-only fallback must always lower")


# --- TaskConstraints ------------------------------------------------------

def test_vacuous_and_width_law():
    a, b = _both(lambda pkg: pkg.TaskConstraints.vacuous(5))
    _same_constraints(a, b)
    assert b.is_vacuous()
    assert T.DELTA == J.constraints.DELTA
    dur0 = np.arange(1, 25)
    for w in (1, 2, 3, 7):
        for f in (0.0, 0.25, 0.6, 1.0):
            np.testing.assert_array_equal(T.width_duration(dur0, w, f),
                                          J.width_duration(dur0, w, f))


@pytest.mark.parametrize("field,bad", [
    ("deadline", -2), ("affinity", -3), ("anti_affinity", -2),
    ("max_width", 0), ("serial_frac", 1.5), ("serial_frac", -0.1)])
def test_field_validation_messages(field, bad):
    def build(pkg):
        kw = dataclasses.asdict(pkg.TaskConstraints.vacuous(3))
        kw[field] = np.array([bad] * 3, type(np.asarray(kw[field])[0]))
        return _outcome(lambda: pkg.TaskConstraints(**kw))

    want, got = _both(build)
    assert want[0] == "ValueError" and got == want


@pytest.mark.parametrize("case", [
    "shape", "double_membership", "too_few_names", "wrong_arity"])
def test_construction_errors_match(case):
    def build(pkg):
        if case == "shape":
            kw = dataclasses.asdict(pkg.TaskConstraints.vacuous(3))
            kw["exclusive"] = np.zeros(4, bool)
            return _outcome(lambda: pkg.TaskConstraints(**kw))
        if case == "double_membership":
            return _outcome(lambda: pkg.TaskConstraints.from_groups(
                4, affinity={"a": (0, 1), "b": (1, 2)}))
        if case == "too_few_names":
            kw = dataclasses.asdict(pkg.TaskConstraints.vacuous(3))
            kw["affinity"] = np.array([0, 1, -1])
            kw["affinity_names"] = ("only",)
            return _outcome(lambda: pkg.TaskConstraints(**kw))
        return _outcome(lambda: _tiny(
            pkg, n=2, constraints=pkg.TaskConstraints.vacuous(3)))

    want, got = _both(build)
    assert want[0] == "ValueError" and got == want


def test_from_groups_take_extend_constrain():
    def build(pkg):
        c = pkg.TaskConstraints.from_groups(
            7, deadlines={1: 3}, affinity={"tower": (0, 1)},
            anti_affinity={"spread": (2, 3), "other": (6,)}, exclusive=(4,),
            widths={5: (4, 0.25)})
        c2 = c.constrain(np.array([2]), affinity="tower", deadline=3)
        c3 = c2.constrain(np.array([3, 5]), anti_affinity="fresh",
                          exclusive=True)
        return [c, c.take(np.array([0, 3, 5])), c.take(c.exclusive),
                c.extend(2), c2, c3]

    for a, b in zip(*_both(build)):
        _same_constraints(a, b)


# --- lowering -------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_lowering_arrays_equal(seed):
    jp, tp, want, got = _constrained(seed)
    _same_lowering(want, got)
    # the reference's constraints carried across by convert give the same
    # lowering as the port's own from_groups
    _same_lowering(want, T.lower_constraints(problem_from_arrays(jp)))


def test_generator_mostly_active():
    active = sum(not _constrained(s)[3].identity for s in SEEDS)
    assert active >= 10


def test_identity_paths():
    p = _tiny(T)
    low = T.lower_constraints(p)
    assert low.identity and low.lowered is p
    q = _tiny(T, constraints=T.TaskConstraints.vacuous(2))
    low = T.lower_constraints(q)
    assert low.identity and low.lowered.constraints is None
    assert low.lowered.dem is q.dem
    sol = T.Solution(node_type=np.array([0]), assign=np.array([0, 0]))
    assert T.expand_solution(low, sol) is sol


def _error_case(pkg, case):
    TC = pkg.TaskConstraints
    if case == "beyond_horizon":
        return _tiny(pkg, n=1, T=4, end=[3],
                     constraints=TC.from_groups(1, deadlines={0: 9}))
    if case == "before_start":
        return _tiny(pkg, n=1, start=[2], end=[3],
                     constraints=TC.from_groups(1, deadlines={0: 0}))
    if case == "unmeetable":
        return _tiny(pkg, n=1, start=[0], end=[3], constraints=TC.from_groups(
            1, deadlines={0: 1}, widths={0: (8, 1.0)}))
    if case == "contradiction":
        return _tiny(pkg, n=2, constraints=TC.from_groups(
            2, affinity={"g": (0, 1)}, anti_affinity={"s": (0, 1)}))
    if case == "merged_fits_no_type":
        return _tiny(pkg, dem=[[3.0], [3.0]], cap=((4.0,),),
                     constraints=TC.from_groups(2, affinity={"g": (0, 1)}))
    return _tiny(pkg, n=1, dem=[[3.0]], start=[0], end=[3], T=4,
                 cap=((4.0,),), constraints=TC.from_groups(
                     1, deadlines={0: 1}, widths={0: (4, 0.0)}))


@pytest.mark.parametrize("case", [
    "beyond_horizon", "before_start", "unmeetable", "contradiction",
    "merged_fits_no_type", "widened_fits_no_type"])
def test_lowering_errors_match(case):
    want, got = _both(
        lambda pkg: _outcome(lambda: pkg.lower_constraints(
            _error_case(pkg, case))))
    assert want[0] == "ValueError" and got == want


@pytest.mark.parametrize("gate", ["trim_timeline", "pack_problems",
                                  "solve_lp", "two_phase"])
def test_plain_entry_points_require_lowering(gate):
    p = _tiny(T, constraints=T.TaskConstraints.from_groups(2, exclusive=(0,)))
    call = {"trim_timeline": lambda: T.trim_timeline(p),
            "pack_problems": lambda: T.pack_problems([p]),
            "solve_lp": lambda: T.solve_lp(p),
            "two_phase": lambda: T.two_phase(p, np.zeros(2, np.int64),
                                             device="cpu")}[gate]
    with pytest.raises(ValueError, match="lower it first with "
                                         "lower_constraints"):
        call()


# --- the oracle -----------------------------------------------------------

def _checker_case(pkg, case):
    """(problem, solution, widths) of the reference's
    TestCheckerCatchesViolations cases."""
    TC, Sol = pkg.TaskConstraints, pkg.Solution
    one = Sol(node_type=np.array([0]), assign=np.array([0, 0]))
    if case == "capacity":
        return (_tiny(pkg, dem=[[1.5], [1.5]], cap=((2.0,),), T=2,
                      end=[1, 1]), one, None)
    if case == "assign_out_of_range":
        return _tiny(pkg), Sol(node_type=np.array([0]),
                               assign=np.array([0, 5])), None
    if case == "type_out_of_range":
        return _tiny(pkg), Sol(node_type=np.array([3]),
                               assign=np.array([0, 0])), None
    if case == "affinity_split":
        return (_tiny(pkg, constraints=TC.from_groups(
            2, affinity={"g": (0, 1)})),
            Sol(node_type=np.array([0, 0]), assign=np.array([0, 1])), None)
    if case == "anti_overlap":
        return (_tiny(pkg, start=[0, 1], end=[2, 3], constraints=TC.from_groups(
            2, anti_affinity={"s": (0, 1)})), one, None)
    if case == "anti_disjoint":
        return (_tiny(pkg, start=[0, 2], end=[1, 3], constraints=TC.from_groups(
            2, anti_affinity={"s": (0, 1)})), one, None)
    if case == "exclusive":
        return (_tiny(pkg, constraints=TC.from_groups(2, exclusive=(0,))),
                one, None)
    if case == "exclusive_own_group":
        return (_tiny(pkg, constraints=TC.from_groups(
            2, affinity={"g": (0, 1)}, exclusive=(0,))), one, None)
    if case == "deadline_miss":
        return (_tiny(pkg, n=1, start=[0], end=[3], T=4,
                      constraints=TC.from_groups(1, deadlines={0: 2})),
                Sol(node_type=np.array([0]), assign=np.array([0])), None)
    if case == "width_bounds":
        return (_tiny(pkg, n=1, dem=[[1.0]], start=[0], end=[3], T=4),
                Sol(node_type=np.array([0]), assign=np.array([0])), [3])
    if case == "width_length":
        return _tiny(pkg), one, [1, 1, 1]
    # widths from meta: a width-2 task finishes earlier but demands double
    return (_tiny(pkg, n=2, dem=[[1.5], [1.0]], start=[0, 0], end=[3, 3],
                  cap=((4.0,),), constraints=TC.from_groups(
                      2, widths={0: (2, 0.0)}, deadlines={0: 1})),
            Sol(node_type=np.array([0]), assign=np.array([0, 0]),
                meta={"widths": np.array([2, 1])}), None)


@pytest.mark.parametrize("case", [
    "capacity", "assign_out_of_range", "type_out_of_range", "affinity_split",
    "anti_overlap", "anti_disjoint", "exclusive", "exclusive_own_group",
    "deadline_miss", "width_bounds", "width_length", "widths_from_meta"])
def test_check_plan_strings_match(case):
    def build(pkg):
        p, sol, widths = _checker_case(pkg, case)
        return pkg.check_plan(p, sol, widths=widths)

    want, got = _both(build)
    assert got == want


def test_assert_feasible_raises_the_same():
    def build(pkg):
        p, sol, _ = _checker_case(pkg, "capacity")
        with pytest.raises(pkg.FeasibilityError) as info:
            pkg.assert_feasible(p, sol)
        assert isinstance(info.value, AssertionError)
        return str(info.value), info.value.violations

    want, got = _both(build)
    assert got == want


@pytest.mark.parametrize("seed", range(6))
def test_check_plan_strings_on_corrupted_plans(seed):
    jp, tp, _, _ = _constrained(seed)
    sol = J.rightsize(jp, "penalty-map-f")
    rng = np.random.default_rng(seed)
    nodes = len(sol.node_type)
    corrupt = [
        dataclasses.replace(sol, assign=np.zeros_like(sol.assign)),
        dataclasses.replace(sol, assign=rng.integers(0, nodes, jp.n)),
        dataclasses.replace(sol, node_type=np.zeros_like(sol.node_type)),
        dataclasses.replace(sol, meta=dict(
            sol.meta, widths=sol.meta.get("widths", np.ones(jp.n, int)) + 1)),
        dataclasses.replace(sol, assign=np.roll(sol.assign, 1)),
    ]
    flagged = 0
    for bad in corrupt:
        want = J.check_plan(jp, bad)
        assert T.check_plan(tp, bad) == want
        flagged += bool(want)
    assert flagged >= 3


# --- placement ------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_rightsize_matches_reference(seed):
    jp, tp, jlow, _ = _constrained(seed)
    lp = J.solve_lp(J.trim_timeline(jlow.lowered)[0])
    for algo in J.ALGORITHMS:
        kw = {"lp_result": lp} if algo.startswith("lp-map") else {}
        want = J.rightsize(jp, algo, **kw)
        got = T.rightsize(tp, algo, device="cpu", **kw)
        np.testing.assert_array_equal(got.node_type, want.node_type)
        np.testing.assert_array_equal(got.assign, want.assign)
        assert got.cost(tp) == want.cost(jp)
        assert got.meta.get("constrained") == want.meta.get("constrained")
        for key in ("widths", "end_eff"):
            if key in want.meta:
                np.testing.assert_array_equal(got.meta[key], want.meta[key])
        assert T.check_plan(tp, got) == [] and J.check_plan(jp, got) == []
        assert T.check_plan(tp, want) == []
    # the kernel backend's plain version (the two_phase walk) on the
    # lowered rows, the virtual dimensions included
    kern = T.rightsize(tp, "lp-map-f", backend="kernel", lp_result=lp,
                       device="cpu")
    np.testing.assert_array_equal(kern.assign, got.assign)


@pytest.mark.parametrize("seed", range(0, 14, 2))
def test_three_engines_agree_on_lowered_instances(seed):
    jp, tp, jlow, tlow = _constrained(seed)
    t, _ = T.trim_timeline(tlow.lowered)
    mp = T.penalty_map(t, "avg")
    want = J.two_phase(J.trim_timeline(jlow.lowered)[0], mp)
    batch = T.pack_problems([t], assume_trimmed=True)
    sols = [T.two_phase(t, mp, device="cpu"),
            T.two_phase(t, mp, backend="kernel", device="cpu")]
    for placement in ("lockstep", "compiled"):
        for backend in ("numpy", "kernel"):
            if placement == "compiled" and backend == "kernel":
                continue
            sols += T.place_many(batch, [mp], placement=placement,
                                 backend=backend, device="cpu")
    for got in sols:
        np.testing.assert_array_equal(got.node_type, want.node_type)
        np.testing.assert_array_equal(got.assign, want.assign)
    assert T.check_plan(tp, T.expand_solution(tlow, sols[0])) == []


def test_fleet_engine_place_expands_constrained_plans():
    jp, tp, _, tlow = _constrained(3)
    assert not tlow.identity
    mp = T.penalty_map(T.trim_timeline(tlow.lowered)[0], "avg")
    for engine in ("batched", "compiled", "loop"):
        eng = T.FleetEngine(placement=T.PlacementConfig(engine=engine),
                            device="cpu")
        sol = eng.place([tp], [mp])[0]
        assert sol.assign.shape == (tp.n,)
        assert sol.meta.get("constrained") is True
        T.assert_feasible(tp, sol)
        J.assert_feasible(jp, sol)


def test_vacuous_constraints_bit_stable():
    for seed in (0, 1, 2):
        base = j_synthetic_instance(JSpec(n=24, m=3, D=2, T=10, seed=seed))
        tp = problem_from_arrays(base)
        tq = dataclasses.replace(tp,
                                 constraints=T.TaskConstraints.vacuous(tp.n))
        a = T.rightsize(tp, device="cpu")
        b = T.rightsize(tq, device="cpu")
        np.testing.assert_array_equal(a.assign, b.assign)
        assert a.cost(tp) == b.cost(tp)


# --- the fleet ------------------------------------------------------------

def test_constrained_fleet_evaluate_matches_reference():
    pairs = [_constrained(s) for s in (0, 1, 3, 5)]
    assert sum(not low.identity for *_, low in pairs) >= 3
    want = J.FleetEngine(solver=J.SolverConfig(iters=300)).evaluate(
        [jp for jp, *_ in pairs])
    got = T.FleetEngine(solver=T.SolverConfig(iters=300),
                        device="cpu").evaluate([tp for _, tp, *_ in pairs])
    for g, w in zip(got.entries, want.entries):
        assert g["lb"] == pytest.approx(w["lb"], rel=LB_REL)
        for algo, cost in w["costs"].items():
            assert g["costs"][algo] == pytest.approx(cost, rel=COST_REL)
    # the compiled stepper's plain version places the lowered fleet as the
    # lockstep engine does, on the same LP results
    comp = T.FleetEngine(solver=T.SolverConfig(iters=300),
                         placement=T.PlacementConfig(engine="compiled"),
                         device="cpu").evaluate([tp for _, tp, *_ in pairs])
    for a, b in zip(comp.entries, got.entries):
        assert a["costs"] == b["costs"]


def test_convert_carries_constraints():
    c = J.TaskConstraints.from_groups(
        6, deadlines={1: 3}, affinity={"tower": (0, 1)},
        anti_affinity={"spread": (2, 3)}, exclusive=(4,),
        widths={5: (4, 0.25)})
    port = constraints_from(c)
    assert isinstance(port, T.TaskConstraints)
    _same_constraints(c, port)
    assert constraints_from(None) is None
