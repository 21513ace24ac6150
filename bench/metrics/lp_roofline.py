"""lp_roofline.<suffix>, in %: the least time the window's LP solves could
take at the HBM3 rate (each lane's iterations, from the solver's counts,
times the bytes one PDHG iteration must move on that lane's own shape)
over the LP phase's seconds."""

from bench import work


def read(ctx):
    recs = ctx["records"]
    lp_s = sum(r["lp_s"] for r in recs)
    return 100.0 * work.seconds_at_peak(sum(r["lp_bytes"] for r in recs)) \
        / lp_s
