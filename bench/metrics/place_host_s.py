"""place_host_s.<suffix>: seconds a step of the placement's host-only
spans (``place.maps``, ``.prep``, ``.gather``, ``.pack``, ``.apply``,
``.solutions``, ``.costs``, ``.verify``: numpy and Python, no device work)
under ``place``."""

from bench import spans


def read(ctx):
    return spans.host_seconds(ctx, "place")
