"""Prefill time per thousand prompt tokens: the window's
jetstream:prefill_step_duration_seconds sum over its
jetstream:prompt_tokens_total (ms)."""


def read(ctx):
    n = ctx.counters["prompt_tokens"]
    return ctx.counters["prefill_sum"] * 1e6 / n if n else None
