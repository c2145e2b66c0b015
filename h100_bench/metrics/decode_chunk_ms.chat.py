"""Mean time of one fused decode chunk, dispatch through readback
(jetstream:decode_step_duration_seconds, sum over count in the window) (ms)."""


def read(ctx):
    n = ctx.counters["decode_count"]
    return ctx.counters["decode_sum"] / n * 1e3 if n else None
