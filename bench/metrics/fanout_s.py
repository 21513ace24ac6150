"""fanout_s.<suffix>: seconds a plan spends fanning the forecast out into
its scenarios (the ``fanout`` span)."""

from bench import spans


def read(ctx):
    return spans.seconds(ctx, ("fanout",))
