"""congestion_roofline.<suffix>, in %: the least time the LP's forward
congestion applies could take at the HBM3 rate (one a lane and iteration,
the bytes of its own shape) over the device time of the congestion
kernel's launches in the trace.  Nothing to read without a trace or a
launch."""

from bench import work
from bench.trace import kernel_seconds

KERNEL = "congestion_many_kernel"


def read(ctx):
    if ctx["trace"] is None:
        return None
    secs, runs = kernel_seconds(ctx["trace"], KERNEL)
    if not runs:
        return None
    nbytes = sum(r["congestion_bytes"] for r in ctx["records"])
    return 100.0 * work.seconds_at_peak(nbytes) / secs
