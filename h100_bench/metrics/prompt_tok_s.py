"""Prompt tokens of the requests whose first token arrived inside the window,
over its length (tokens/s)."""

from h100_bench import stats


def read(ctx):
    return sum(r["prompt_tokens"] for r in stats.requests(ctx)
               if (t := stats.first_token_at(r)) is not None
               and ctx.start <= t < ctx.end) / ctx.seconds
