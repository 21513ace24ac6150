"""select_s.<suffix>: seconds a plan spends on the candidate menu, the
overloads, every CVaR selection and frontier row (the ``select`` span)."""

from bench import spans


def read(ctx):
    return spans.seconds(ctx, ("select",))
