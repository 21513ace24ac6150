"""Fleet rightsizing CLI — the paper's technique as the framework's
capacity-planning layer, as four subcommands over one config surface:

    python -m repro_torch.launch.rightsize plan    [--algo lp-map-f]
                                                   [--scenarios K --cvar-alpha A]
    python -m repro_torch.launch.rightsize compare
    python -m repro_torch.launch.rightsize fleet   [-n 8] [--placement compiled]
    python -m repro_torch.launch.rightsize serve   [--trace gct] [--requests 200]

``plan`` purchases a minimum-cost fleet for the LM-job schedule and
prints the placement (with ``--scenarios K`` it continues into the
stochastic layer: K-scenario fan-out, one batched dispatch, CVaR
frontier — docs/stochastic.md); ``compare`` runs all four paper
algorithms plus
the timeline-agnostic lower bound (§VI-F); ``fleet`` evaluates N
demand-scaled what-if scenarios through ONE ``FleetEngine`` session;
``serve`` replays an arrival trace through the long-lived
``RightsizingService`` (docs/service.md) and prints its sustained
requests/sec + re-plan latency report.

Every subcommand builds its engine through the shared
``configs_from_flags()`` helper — the solver/placement/sweep flags are
spelled once, map one-to-one onto the typed configs, and each
subcommand only overrides the *defaults* (e.g. ``serve`` defaults to a
tolerance-stopped solver because warm starts need early exit).

Ported from ``repro.launch.rightsize`` with the same subcommands, flags and
defaults, plus one shared ``--device`` flag: every engine (and so the
service) runs on the CUDA card unless given ``--device cpu``, where the
kernels run their plain PyTorch versions.  A kernel that does not build or
launch stops the command.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json

import numpy as np

from ..core import (
    FleetEngine,
    PlacementConfig,
    SolverConfig,
    SweepConfig,
    no_timeline_lowerbound,
    rightsize,
    trim_timeline,
)
from ..workload.jobs import DEFAULT_SCHEDULE, fleet_problem


def configs_from_flags(args) -> dict:
    """Map the shared CLI flags onto the typed-config family — the ONE
    place flag spellings meet config fields.  Returns kwargs for
    ``FleetEngine(**configs_from_flags(args))`` (minus ``algos``, which
    each subcommand picks), the engine's ``device`` among them."""
    return {
        "solver": SolverConfig(tol=args.lp_tol, iters=args.lp_iters,
                               operator=args.operator,
                               scaling=args.scaling,
                               precision=args.precision,
                               omega=not args.no_omega),
        "placement": PlacementConfig(engine=args.placement,
                                     backend=args.backend),
        "sweep": SweepConfig(max_buckets=args.buckets,
                             shard_size=args.shard_size,
                             warm_start=args.warm_start,
                             pipeline=args.pipeline,
                             devices=args.devices),
        "device": args.device,
    }


def stochastic_from_flags(args):
    """Map the ``plan`` subcommand's stochastic flags onto a
    ``StochasticConfig`` (the CVaR selection knobs; the forecast
    channels ride separately on ``--load-sigma``/``--burst-prob``).
    Lives next to ``configs_from_flags`` for the same reason: one
    place where flag spellings meet config fields."""
    from ..stochastic import StochasticConfig

    return StochasticConfig(
        scenarios=args.scenarios,
        seed=args.seed,
        cvar_alpha=args.cvar_alpha,
        cvar_lambda=args.cvar_lambda,
        recfg_weight=args.recfg_cost,
        algo=args.algo,
    )


def _shared_flags() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None,
                   help="where every engine runs (FleetEngine.device; "
                        "default: the CUDA card, 'cpu' for the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--dryrun-dir", default="results/dryrun")
    p.add_argument("--lp-tol", type=float, default=None,
                   help="tolerance-stopped LP solve "
                        "(SolverConfig.tol; default: fixed iterations)")
    p.add_argument("--lp-iters", type=int, default=2000,
                   help="LP iteration count / cap (SolverConfig.iters)")
    p.add_argument("--operator", default="auto",
                   choices=["auto", "dense", "cumsum", "pallas"],
                   help="congestion-operator form (SolverConfig.operator)")
    p.add_argument("--placement", default="batched",
                   choices=["batched", "compiled", "loop"],
                   help="placement engine (PlacementConfig.engine)")
    p.add_argument("--backend", default="numpy",
                   choices=["numpy", "kernel"],
                   help="placement scoring backend "
                        "(PlacementConfig.backend)")
    p.add_argument("--buckets", type=int, default=1,
                   help="max shape buckets (SweepConfig.max_buckets)")
    p.add_argument("--shard-size", type=int, default=None,
                   help="LP dispatch shard size (SweepConfig.shard_size)")
    p.add_argument("--warm-start", type=int, default=None,
                   help="warm-started sweep group size "
                        "(SweepConfig.warm_start)")
    p.add_argument("--scaling", default="ruiz",
                   choices=["none", "ruiz"],
                   help="operator equilibration (SolverConfig.scaling; "
                        "tol mode only)")
    p.add_argument("--precision", default="mixed",
                   choices=["f64", "mixed"],
                   help="solve precision: f32 iterate + f64 certificate/"
                        "polish, or full f64 (SolverConfig.precision)")
    p.add_argument("--no-omega", action="store_true",
                   help="disable primal-weight balancing "
                        "(SolverConfig.omega)")
    p.add_argument("--pipeline", action="store_true",
                   help="run the warm-started sweep chain as one host "
                        "call, one dispatch (SweepConfig.pipeline; "
                        "requires --warm-start)")
    p.add_argument("--devices", type=int, default=None,
                   help="shard the pipelined sweep's batch dim across "
                        "this many visible cards, or run that many shards "
                        "in turn under --device cpu (SweepConfig.devices); "
                        "on cards this is at present slower than one card "
                        "(one host thread launches for every card, and the "
                        "tol loop is bound by its launches)")
    return p


def _load_problem(args):
    problem, tasks = fleet_problem(DEFAULT_SCHEDULE, args.dryrun_dir)
    measured = sum(1 for t in tasks if t["source"] == "dryrun")
    print(f"jobs -> {problem.n} tasks ({measured} demand vectors measured "
          f"from dry-run artifacts), {problem.m} slice SKUs, T=24h\n")
    return problem, tasks


def _plan_stochastic(args, problem, current):
    """``plan --scenarios K``: fan the job fleet's point forecast into
    K scenarios (one batched dispatch) and print the CVaR frontier,
    the chosen robust fleet, and the expected-cost-only comparison.
    ``current`` (the deterministic point plan) anchors the Eva-style
    ``--recfg-cost`` reconfiguration term."""
    from ..stochastic import DemandForecast, plan_stochastic

    forecast = DemandForecast(base=problem,
                              load_sigma=args.load_sigma,
                              burst_prob=args.burst_prob)
    engine = FleetEngine(**configs_from_flags(args), algos=(args.algo,))
    res = plan_stochastic(forecast, stochastic_from_flags(args),
                          engine=engine, current_fleet=current)
    print(f"== stochastic plan ({res.K} scenarios, {res.lp_dispatches} "
          f"LP dispatch(es), alpha={args.cvar_alpha}, "
          f"lambda={args.cvar_lambda}) ==")
    names = problem.node_types.names
    fmt = lambda F: ", ".join(  # noqa: E731
        f"{c} x {names[b]}" for b, c in enumerate(F) if c) or "(empty)"
    print(f"  robust fleet:   {fmt(res.fleet)} "
          f"(${res.fleet_cost*24:,.2f}/day, worst-scenario overload "
          f"${res.worst_overload*24:,.2f}/day)")
    print(f"  expected-only:  {fmt(res.expected_fleet)} "
          f"(${res.expected_fleet_cost*24:,.2f}/day, worst-scenario "
          f"overload ${res.expected_overload.max()*24:,.2f}/day)")
    print(f"\n{'alpha':>6s} {'lambda':>7s} {'$/day':>10s} "
          f"{'cvar ov':>9s} {'worst ov':>9s}  fleet")
    for row in res.frontier:
        print(f"{row['alpha']:6.2f} {row['lambda']:7.2f} "
              f"{row['fleet_cost']*24:10,.2f} "
              f"{row['cvar_overload']*24:9,.2f} "
              f"{row['worst_overload']*24:9,.2f}  {row['fleet']}")
    return res


def cmd_plan(args):
    """One fleet plan with one algorithm; the mapping LP runs through
    the flag-configured engine (``rightsize`` consumes its result).
    With ``--scenarios K`` the point plan becomes the *current* fleet
    and planning continues stochastically (forecast fan-out + CVaR
    selection, docs/stochastic.md)."""
    problem, tasks = _load_problem(args)
    trimmed, _ = trim_timeline(problem)
    lp_result = None
    if args.algo.startswith("lp-map"):
        engine = FleetEngine(**configs_from_flags(args),
                             algos=(args.algo,))
        (lp_result,), _ = engine.solve([trimmed])
    sol = rightsize(trimmed, args.algo, lp_result=lp_result,
                    device=args.device)
    cost = sol.cost(trimmed)
    print(f"== fleet plan ({args.algo}) — ${cost*24:,.2f}/day ==")
    per_type = sol.nodes_per_type(trimmed)
    for b, count in enumerate(per_type):
        if count:
            print(f"  {count} x {trimmed.node_types.names[b]} "
                  f"(${trimmed.node_types.cost[b]*24:,.2f}/day each)")
    print("\nplacement:")
    by_node = collections.defaultdict(list)
    for u, node in enumerate(sol.assign):
        by_node[int(node)].append(tasks[u])
    for node in sorted(by_node):
        b = sol.node_type[node]
        names = ", ".join(
            f"{t['name']}[{t['start']:02d}-{t['end']:02d}h]"
            for t in by_node[node])
        print(f"  node{node} ({trimmed.node_types.names[b]}): {names}")
    if args.scenarios:
        print()
        return _plan_stochastic(args, problem, per_type)
    return sol


def cmd_compare(args):
    """All four paper algorithms on the job fleet, via ONE B=1
    ``FleetEngine`` session (the LP lower bound is the solver's
    certified dual bound)."""
    problem, _ = _load_problem(args)
    trimmed, _ = trim_timeline(problem)
    engine = FleetEngine(**configs_from_flags(args))
    result = engine.evaluate([trimmed])
    entry = result.entries[0]
    lb = entry["lb"]
    print(f"{'algorithm':16s} {'$/day':>10s} {'x LB':>7s}")
    for algo, cost in entry["costs"].items():
        print(f"{algo:16s} {cost*24:10.2f} {cost/lb:7.3f}")
    flat = no_timeline_lowerbound(trimmed)
    print(f"\nLP lower bound: ${lb*24:.2f}/day")
    print(f"timeline-agnostic LB (always-on): ${flat*24:.2f}/day "
          f"({flat/lb:.2f}x — the §VI-F gap)")
    return entry


def cmd_fleet(args):
    """N demand-scaled what-if scenarios in one FleetEngine session:
    every scenario's mapping LP solves in one fused batch and every
    greedy placement advances in lockstep.  Doubles as the docs'
    read-the-telemetry walkthrough (docs/benchmarks.md)."""
    problem, _ = _load_problem(args)
    cap_max = problem.node_types.cap.max(axis=0)
    factors = np.linspace(0.5, 1.5, args.scenarios)
    # clamp per-task demand to the largest SKU so every scenario stays
    # placeable (a job can never need more than one full slice here)
    scenarios = [dataclasses.replace(
        problem, dem=np.minimum(problem.dem * f, cap_max))
        for f in factors]
    engine = FleetEngine(**configs_from_flags(args),
                         algos=("penalty-map-f", "lp-map-f"))
    result = engine.evaluate(scenarios)
    t = result.timings
    print(f"== fleet scenarios ({args.scenarios} demand scalings, one "
          f"FleetEngine session) ==")
    # a warm-started sweep packs no buckets (plan None): its groups share
    # one padded shape
    shape = ("one warm-started sweep chain" if result.plan is None
             else f"{result.plan.n_buckets} shape bucket(s)")
    print(f"   pack {t['pack_s']:.2f}s + lp {t['lp_s']:.1f}s + "
          f"placement {t['place_s']:.1f}s over {shape}")
    tel = t["placement"]
    line = (f"   placement engine: {tel['engine']} "
            f"({tel['calls']} stepper calls")
    if "wave_s_total" in tel:
        line += (f", {tel['waves']} phase waves, "
                 f"{tel['wave_s_total']:.2f}s in waves")
    if tel.get("engine") == "compiled":
        line += (f", {tel['dispatches']} device dispatches, "
                 f"{tel['fallbacks']} fallbacks, "
                 f"modes {'/'.join(tel['modes'])}")
    print(line + ")\n")
    print(f"{'demand x':>9s} {'penalty-map-f $/day':>20s} "
          f"{'lp-map-f $/day':>15s} {'x LB':>6s}")
    for f, e in zip(factors, result.entries):
        cost = e["costs"]["lp-map-f"]
        print(f"{f:9.2f} {e['costs']['penalty-map-f']*24:20,.2f} "
              f"{cost*24:15,.2f} {e['normalized']['lp-map-f']:6.3f}")
    return result


def cmd_serve(args):
    """Replay an arrival trace through a ``RightsizingService`` and
    print the serving report (requests/sec, p50/p99 re-plan latency,
    warm-vs-cold iteration medians, decision-loop events).

    ``--restore DIR`` resumes a checkpointed service (warm lanes,
    adopted plans, and the pending queue carry over) before the replay;
    ``--checkpoint DIR`` snapshots the service after it drains, so a
    later invocation can pick up where this one stopped."""
    from ..serve import (RightsizingService, ServiceConfig, TraceSpec,
                         gct_trace, jobs_trace, replay)

    engine = FleetEngine(**configs_from_flags(args), algos=("lp-map-f",))
    config = ServiceConfig(
        max_requests_per_tick=args.max_requests_per_tick)
    if args.restore:
        service = RightsizingService.restore(args.restore,
                                             engine=engine, config=config)
        print(f"restored service from {args.restore}: "
              f"{len(service.fleets)} fleet(s), "
              f"{service.queue.pending} queued request(s)")
    else:
        service = RightsizingService(engine=engine, config=config)
    spec = TraceSpec(fleets=args.fleets, requests=args.requests,
                     seed=args.seed)
    if args.trace == "gct":
        trace = gct_trace(spec)
    else:
        trace = jobs_trace(dataclasses.replace(spec, n0=0),
                           dryrun_dir=args.dryrun_dir)
    print(f"replaying {len(trace)} requests over {args.fleets} "
          f"{args.trace} fleets ({args.push_per_tick}/tick pressure)\n")
    report = replay(service, trace, push_per_tick=args.push_per_tick)
    print(json.dumps(report, indent=2))
    if args.checkpoint:
        service.snapshot(args.checkpoint)
        print(f"# service checkpointed -> {args.checkpoint}")
    return report


def run(argv=None):
    shared = _shared_flags()
    ap = argparse.ArgumentParser(prog="repro_torch.launch.rightsize")
    sub = ap.add_subparsers(dest="command")

    p = sub.add_parser("plan", parents=[shared],
                       help="purchase one fleet plan and print it")
    p.add_argument("--algo", default="lp-map-f")
    p.add_argument("--scenarios", type=int, default=0, metavar="K",
                   help="also plan stochastically: fan the forecast "
                        "into K scenarios (one batched dispatch) and "
                        "print the CVaR frontier (0 = off)")
    p.add_argument("--seed", type=int, default=0,
                   help="scenario fan-out seed")
    p.add_argument("--cvar-alpha", type=float, default=0.9,
                   help="CVaR tail level (StochasticConfig.cvar_alpha)")
    p.add_argument("--cvar-lambda", type=float, default=1.0,
                   help="CVaR term weight (StochasticConfig.cvar_lambda)")
    p.add_argument("--recfg-cost", type=float, default=0.0,
                   help="Eva-style reconfiguration weight against the "
                        "point plan (StochasticConfig.recfg_weight)")
    p.add_argument("--load-sigma", type=float, default=0.15,
                   help="forecast scenario-wide load sigma "
                        "(DemandForecast.load_sigma)")
    p.add_argument("--burst-prob", type=float, default=0.05,
                   help="forecast per-task burst probability "
                        "(DemandForecast.burst_prob)")
    p.set_defaults(func=cmd_plan)

    p = sub.add_parser("compare", parents=[shared],
                       help="all four paper algorithms + §VI-F bounds")
    p.set_defaults(func=cmd_compare)

    p = sub.add_parser("fleet", parents=[shared],
                       help="N demand-scaled scenarios, one session")
    p.add_argument("-n", "--scenarios", type=int, default=8)
    p.set_defaults(func=cmd_fleet, lp_iters=1500, buckets=4)

    p = sub.add_parser("serve", parents=[shared],
                       help="replay an arrival trace through the "
                            "RightsizingService")
    p.add_argument("--trace", choices=["gct", "jobs"], default="gct")
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--fleets", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--push-per-tick", type=int, default=8)
    p.add_argument("--max-requests-per-tick", type=int, default=32)
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="snapshot the drained service to DIR")
    p.add_argument("--restore", default=None, metavar="DIR",
                   help="resume from a snapshot in DIR before replaying")
    p.set_defaults(func=cmd_serve, lp_tol=5e-3, lp_iters=4000)

    args = ap.parse_args(argv)
    if args.command is None:
        args = ap.parse_args(["plan"] + (argv or []))
    return args.func(args)


if __name__ == "__main__":
    run()
