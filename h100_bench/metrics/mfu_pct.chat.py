"""The profiled window's model operations (2 per weight a token multiplies
by, attention's QK and PV over each token's real context, the LM head where
it runs) over the window's length times the bf16 peak (%)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["model_flops"]:
        return None
    return t["model_flops"] / (t["window_s"] * ctx.counts.PEAK_BF16_FLOPS) * 100
