"""lp_attempt_us.<suffix>: the window's ``lp.enqueue`` seconds, in
microseconds, over its ``lp.attempts``: the host's cost to queue one
attempt, whatever number of attempts the slowest lane needed."""

from bench import spans


def read(ctx):
    v = spans.per_count(ctx, "lp.enqueue", "lp.attempts")
    return None if v is None else 1e6 * v
