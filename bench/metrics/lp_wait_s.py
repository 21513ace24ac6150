"""lp_wait_s.<suffix>: seconds a step the LP's host spends blocked on the
card: each chunk's convergence read (``lp.wait``) and the results'
read-back (``lp.read``)."""

from bench import spans


def read(ctx):
    return spans.seconds(ctx, ("lp.wait", "lp.read"))
