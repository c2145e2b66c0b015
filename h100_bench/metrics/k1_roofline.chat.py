"""K1 (paged decode attention): its least time by the roofline over the
profiled window (the cached K/V rows of every lane at its length, or its
operations, whichever bounds) over its device time (%)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["k1_launches"] or not t["k1_s"]:
        return None
    return t["k1_least_s"] / t["k1_s"] * 100
