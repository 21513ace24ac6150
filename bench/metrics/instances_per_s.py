"""instances_per_s: instances of every evaluate completed in the window
over the time from the window's start to the end of its last evaluate."""


def read(ctx):
    if ctx["mix"]["driver"] != "evaluate":
        return None
    return ctx["units"] / ctx["window_s"]
