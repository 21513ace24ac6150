"""place_s.<suffix>: the program's own host-clock seconds of its placement
phase (``timings["place_s"]``) per step of the window."""


def read(ctx):
    recs = ctx["records"]
    return sum(r["place_s"] for r in recs) / len(recs)
