"""place_wait_s.<suffix>: seconds a step the placement spends copying its
packed attempt sequences to the card (``place.upload``) and launching the
stepper and reading its choices back (``place.dispatch``)."""

from bench import spans


def read(ctx):
    return spans.seconds(ctx, ("place.upload", "place.dispatch"))
