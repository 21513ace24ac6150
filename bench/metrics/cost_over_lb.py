"""cost_over_lb: the mean over instances of the quality algorithm's plan
cost over the instance's certified LP lower bound, over the window's first
``quality_steps`` fleets, which every run plans."""


def read(ctx):
    steps = ctx["mix"].get("quality_steps")
    if not steps or len(ctx["records"]) < steps:
        return None
    q = [v for r in ctx["records"][:steps] for v in r["quality"]]
    return sum(q) / len(q)
