"""lp_graph_hit.<suffix>: the share of the window's tol-LP chunks that ran
as a CUDA graph replay (``lp.graph_replays``) among all its chunks (those
and ``lp.chunks_eager``).  Nothing to read where the program counts
neither, as a program without chunk graphs does not."""

from bench import spans


def read(ctx):
    steps = spans.window(ctx)
    if steps is None:
        return None
    replays = sum(s["counters"].get("lp.graph_replays", 0) for s in steps)
    eager = sum(s["counters"].get("lp.chunks_eager", 0) for s in steps)
    if replays + eager == 0:
        return None
    return replays / (replays + eager)
