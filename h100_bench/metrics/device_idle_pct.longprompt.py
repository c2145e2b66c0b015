"""Share of the profiled window in which no operation ran on the device (%)."""


def read(ctx):
    t = ctx.trace
    return None if t is None else (1 - t["busy_s"] / t["window_s"]) * 100
