"""The port's ``evaluate_many`` shim on the CPU, against the reference's.

``repro_torch.core.evaluate_many(..., device="cpu")`` and
``repro.core.evaluate_many`` run the same legacy keyword arguments over the
same grid (``sweep_specs(SyntheticSpec(n=24, m=4), seeds=2, D=(2, 5))``):
the entries carry the same keys, lower bounds within rel 1e-4 and costs
within rel 1e-5 (ROADMAP's legacy-solver bounds), and the same
``DeprecationWarning`` text and the same ``ValueError`` text come out in the
same cases.  In tolerance mode the two certified lower bounds may part by
what two tol-converged solves can show, tol * (2 + both objectives + both
bounds) (``tests/test_torch_tol.py``), taken here with each objective
replaced by its bound (no larger, so the check is stricter); the small
grid's canonical mappings agree, so costs are held within rel 1e-5 as
above.

The reference's compiled stepper and its tolerance path import
``jax.experimental.enable_x64``, which the installed jax lacks; the
``x64_alias`` fixture supplies it (``jax.enable_x64(True)`` as a context
manager) for the tests that need it only, as ``tests/test_torch_tol.py``
does, so the reference's own tests keep failing as they do without it.
"""

import warnings

import jax
import jax.experimental
import pytest

from repro.core import evaluate_many as j_evaluate_many
from repro.workload import SyntheticSpec, sweep_specs, synthetic_batch
from repro_torch.convert import problem_from_arrays
from repro_torch.core import evaluate_many

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LB_RTOL = 1e-4
COST_RTOL = 1e-5
TOL = 5e-3


@pytest.fixture
def x64_alias(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


@pytest.fixture(scope="module")
def grid():
    ref = synthetic_batch(sweep_specs(SyntheticSpec(n=24, m=4), seeds=2,
                                      D=(2, 5)))
    return ref, [problem_from_arrays(p) for p in ref]


def _run(fn, problems, **kw):
    """(result, the DeprecationWarning messages) of one shim call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(problems, **kw)
    return out, [str(w.message) for w in caught
                 if issubclass(w.category, DeprecationWarning)
                 and "evaluate_many" in str(w.message)]


def _close(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(a), abs(b))


def _same_entries(got, want, tol=None):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert list(g["costs"]) == list(w["costs"])
        if tol is None:
            assert _close(g["lb"], w["lb"], LB_RTOL), (g["lb"], w["lb"])
        else:
            slack = tol * (2.0 + 2.0 * (g["lb"] + w["lb"]))
            assert abs(g["lb"] - w["lb"]) <= slack, (g["lb"], w["lb"])
        for algo, c in w["costs"].items():
            assert _close(g["costs"][algo], c, COST_RTOL), (algo, g, w)
            assert _close(g["costs"][algo] / g["lb"],
                          g["normalized"][algo], 1e-12)
        if "solver" in w:
            assert set(g["solver"]) == set(w["solver"])
            assert g["solver"]["converged"] and w["solver"]["converged"]


def test_defaults_warn_nothing_and_match(grid):
    ref, port = grid
    want, w_warn = _run(j_evaluate_many, ref)
    got, g_warn = _run(evaluate_many, port, device="cpu")
    assert w_warn == g_warn == []
    _same_entries(got, want)


@pytest.mark.parametrize("placement", ["compiled", "loop"])
def test_placement_engines_warn_alike_and_match(grid, x64_alias, placement):
    ref, port = grid
    want, w_warn = _run(j_evaluate_many, ref, placement=placement)
    got, g_warn = _run(evaluate_many, port, placement=placement,
                       device="cpu")
    assert g_warn == w_warn and len(w_warn) == 1
    assert "placement -> PlacementConfig(engine=...)" in g_warn[0]
    _same_entries(got, want)


def test_tol_warm_sweep_with_stats(grid, x64_alias):
    ref, port = grid
    kw = dict(lp_tol=5e-3, lp_iters=4000, warm_start=2, return_stats=True)
    (want, w_stats), w_warn = _run(j_evaluate_many, ref, **kw)
    (got, g_stats), g_warn = _run(evaluate_many, port, device="cpu", **kw)
    assert g_warn == w_warn and len(w_warn) == 1
    for name in ("lp_tol", "lp_iters", "warm_start", "return_stats"):
        assert name + " -> " in g_warn[0]
    _same_entries(got, want, tol=TOL)
    assert len(g_stats) == len(w_stats) == 2  # one per warm-started group
    for g, w in zip(g_stats, w_stats):
        assert g.converged.all() and w.converged.all()


@pytest.mark.parametrize("kw", [dict(warm_start=2), dict(warm_start=0),
                                dict(warm_start=-1, lp_tol=5e-3)])
def test_the_same_errors(grid, kw):
    ref, port = grid
    with pytest.raises(ValueError) as want:
        _run(j_evaluate_many, ref, **kw)
    with pytest.raises(ValueError) as got:
        _run(evaluate_many, port, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_device_is_not_a_legacy_keyword(grid):
    _, port = grid
    got, g_warn = _run(evaluate_many, port[:1], algos=("penalty-map",),
                       device="cpu")
    assert g_warn == [] and list(got[0]["costs"]) == ["penalty-map"]
