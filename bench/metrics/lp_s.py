"""lp_s.<suffix>: the program's own host-clock seconds of its mapping-LP
phase (``timings["lp_s"]``) per step of the window."""


def read(ctx):
    recs = ctx["records"]
    return sum(r["lp_s"] for r in recs) / len(recs)
