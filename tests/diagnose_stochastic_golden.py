"""A record of a diagnosis, not a test: where the port's readings on the
golden stochastic grid part from the reference's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/diagnose_stochastic_golden.py

Both packages plan ``test_torch_stochastic.py``'s golden grid in mixed
precision on the CPU.  It prints, per scenario lane, the costs, the LP
objectives and the tasks whose mapping differs; then the Ruiz scalings of the
scenario batch (the first quantity the two solves compute) on both sides, and
the port's readings again with the reference's scalings handed to it.  Every
patch it makes is undone before it returns.
"""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import torch

import repro.core as J
import repro.core.batch as jbatch
import repro.stochastic as JS
import repro_torch.core as P
import repro_torch.core.batch as tbatch
import repro_torch.stochastic as PS
from test_torch_stochastic import GOLDEN_FORECAST, GOLDEN_K, GOLDEN_SELECT

FIELDS = ("mean_scenario_cost", "mean_overload", "cvar_overload")


def port_plan():
    return PS.plan_stochastic(
        PS.gct_forecast(**GOLDEN_FORECAST),
        PS.StochasticConfig(scenarios=GOLDEN_K, **GOLDEN_SELECT),
        device="cpu")


def plan_both() -> tuple[dict, dict]:
    """Both packages' plans and the per-lane solves behind them."""
    solved, saved = {}, {}
    for key, core in (("ref", J), ("port", P)):
        orig = saved[key] = core.FleetEngine.solve_scenarios

        def spy(self, problems, *a, _orig=orig, _key=key, **k):
            out = _orig(self, problems, *a, **k)
            solved[_key] = out[0]
            return out

        core.FleetEngine.solve_scenarios = spy
    try:
        res = {"ref": JS.plan_stochastic(
            JS.gct_forecast(**GOLDEN_FORECAST),
            JS.StochasticConfig(scenarios=GOLDEN_K, **GOLDEN_SELECT)),
            "port": port_plan()}
    finally:
        for key, core in (("ref", J), ("port", P)):
            core.FleetEngine.solve_scenarios = saved[key]
    return res, solved


def with_reference_scalings() -> tuple:
    """The port's plan with the reference's Ruiz scalings, and how far the
    port's own scalings were from them."""
    orig, seen = tbatch._ruiz_scalings, []

    def ref_scalings(w, *a, **k):
        mine = orig(w, *a, **k)
        with jax.enable_x64(True):
            theirs = [torch.from_numpy(np.array(x)) for x in
                      jax.jit(jbatch._ruiz_scalings)(jnp.asarray(w.numpy()))]
        seen.append([(int((m != t).sum()), m.numel(),
                      float(((m - t).abs() / t.abs()).max()))
                     for m, t in zip(mine, theirs)])
        return tuple(theirs)

    tbatch._ruiz_scalings = ref_scalings
    try:
        again = port_plan()
    finally:
        tbatch._ruiz_scalings = orig
    return again, seen


def main() -> None:
    torch.set_num_threads(1)
    had = getattr(jax.experimental, "enable_x64", None)
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    try:
        res, solved = plan_both()
        again, seen = with_reference_scalings()
    finally:
        if had is None:
            del jax.experimental.enable_x64
        else:
            jax.experimental.enable_x64 = had
    for f in FIELDS:
        print(f"{f}: ref {res['ref'].summary()[f]} port "
              f"{res['port'].summary()[f]}")
    for s in range(GOLDEN_K):
        a, b = solved["ref"][s], solved["port"][s]
        moved = np.flatnonzero(np.asarray(a.mapping) != np.asarray(b.mapping))
        ca, cb = res["ref"].scenario_costs[s], res["port"].scenario_costs[s]
        print(f"lane {s}: cost ref {ca} port {cb}{'' if ca == cb else ' *'}; "
              f"LP objective ref {a.objective:.10g} port {b.objective:.10g} "
              f"(rel {abs(a.objective / b.objective - 1):.3g}); mapping "
              f"differs at tasks {moved.tolist()}")
    (col, row), = seen
    print(f"Ruiz scalings of the scenario batch: column scales differ in "
          f"{col[0]} of {col[1]} (max rel {col[2]:.3g}), row scales in "
          f"{row[0]} of {row[1]} (max rel {row[2]:.3g})")
    print("with the reference's scalings the port reads " + ", ".join(
        f"{f} {again.summary()[f]}" for f in FIELDS) + "; lanes whose cost "
        "differs from the reference's: " + str(np.flatnonzero(
            again.scenario_costs != res["ref"].scenario_costs).tolist()))


if __name__ == "__main__":
    main()
