"""forecast_plan_s: the window's time over the forecasts it planned."""


def read(ctx):
    if ctx["mix"]["driver"] != "plan_stochastic":
        return None
    return ctx["window_s"] / ctx["steps"]
