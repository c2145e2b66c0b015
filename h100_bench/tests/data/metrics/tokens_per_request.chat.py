"""A metric defined only in the tests' data directory: mean output tokens
per finished request of the window."""

from h100_bench import stats


def read(ctx):
    done = [r["completion_tokens"] for r in stats.requests(ctx) if not r.get("error")]
    return sum(done) / len(done) if done else None
