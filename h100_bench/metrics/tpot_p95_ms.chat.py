"""95th percentile over the window's requests of (last token - first
token) / (output tokens - 1) (ms), a failed request counting as the
longest the run could see; in a traced run, over the requests that ended
before its profiled window opened."""

from h100_bench import stats


def read(ctx):
    per = [stats.tpot_s(ctx, r) for r in stats.requests(ctx)
           if r.get("error") or r["done"] < ctx.counted_until]
    per = [t * 1e3 for t in per if t is not None]
    return stats.percentile(per, 95) if per else None
