"""lp_enqueue_s.<suffix>: seconds a step the LP's host spends setting up
(``lp.setup``: device arrays, Ruiz scaling, operators, power iteration),
queueing each chunk's attempts and check (``lp.enqueue``) and queueing the
certificate and polish (``lp.polish``)."""

from bench import spans


def read(ctx):
    return spans.seconds(ctx, ("lp.setup", "lp.enqueue", "lp.polish"))
