"""The program's own spans and counters of a traced window
(``repro_torch.obs``, recorded while the profiler records).

A reader gets the window's steps from ``window(ctx)``: the last
``ctx["steps"]`` steps named for the cell's driver (``evaluate`` or
``plan``).  Where the program records no such steps (it has no
``repro_torch.obs``, or recorded fewer steps than the window ran), it gets
None and reports nothing.
"""

from __future__ import annotations

# the step span each driver's calls open
STEP = {"evaluate": "evaluate", "plan_stochastic": "plan"}


def window(ctx) -> list[dict] | None:
    try:
        from repro_torch import obs
    except ImportError:
        return None
    name = STEP.get(ctx["mix"]["driver"])
    got = [s for s in obs.steps() if s["name"] == name]
    n = ctx["steps"]
    if n < 1 or len(got) < n:
        return None
    return got[-n:]


def leaf(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def seconds(ctx, names) -> float | None:
    """Mean seconds a step of the spans named ``names`` (their totals)."""
    steps = window(ctx)
    if steps is None:
        return None
    return sum(v[1] for s in steps for p, v in s["spans"].items()
               if leaf(p) in names) / len(steps)


def host_seconds(ctx, under: str) -> float | None:
    """Mean seconds a step of the host-only spans below a span named
    ``under`` (their self times, so nested ones count once)."""
    steps = window(ctx)
    if steps is None:
        return None
    return sum(v[2] for s in steps for p, v in s["spans"].items()
               if v[3] and under in p.split("/")[:-1]) / len(steps)


def per_count(ctx, name: str, counter: str) -> float | None:
    """The window's seconds of the spans ``name`` over its ``counter``."""
    steps = window(ctx)
    if steps is None:
        return None
    n = sum(s["counters"].get(counter, 0) for s in steps)
    if n == 0:
        return None
    return sum(v[1] for s in steps for p, v in s["spans"].items()
               if leaf(p) == name) / n
