"""Output tokens received inside the window over its length (tokens/s)."""

from h100_bench import stats


def read(ctx):
    return stats.tokens_in_window(ctx) / ctx.seconds
