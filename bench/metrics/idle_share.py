"""idle_share.<suffix>: the share of the traced window in which no
operation ran on the device (merged busy intervals of the trace)."""


def read(ctx):
    if ctx["trace"] is None:
        return None
    return 1.0 - ctx["trace"]["busy_s"] / ctx["window_s"]
