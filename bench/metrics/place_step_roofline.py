"""place_step_roofline.<suffix>, in %: the least time the placement passes
run on the card could take at the HBM3 rate (every task's demand and span
read and its node written once a pass) over the device time of the
placement stepper's launches in the trace.  Nothing to read without a
trace or a launch."""

from bench import work
from bench.trace import kernel_seconds

KERNEL = "place_step_kernel"


def read(ctx):
    if ctx["trace"] is None:
        return None
    secs, runs = kernel_seconds(ctx["trace"], KERNEL)
    if not runs:
        return None
    nbytes = sum(r["placement_bytes"] for r in ctx["records"])
    return 100.0 * work.seconds_at_peak(nbytes) / secs
