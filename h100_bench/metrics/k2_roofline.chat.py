"""K2 (the grouped expert FFN): its least time by the roofline over the
profiled window (weights of the experts each call hits and its routed rows,
or its operations, whichever bounds) over its device time (%)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["k2_launches"] or not t["k2_s"]:
        return None
    return t["k2_least_s"] / t["k2_s"] * 100
