"""95th percentile of time to first streamed token, from each request's due
time, over the window's requests (ms). Above the knee the queue grows all
through the run, so this tail is a per-layer reading, not a bound. In a
traced run it covers the requests due before the profiled window, and a
request still waiting when that window opens counts the wait it had so far
(the profiler's stall would otherwise land in it)."""

from h100_bench import stats


def read(ctx):
    until, out = ctx.counted_until, []
    for r in stats.requests(ctx):
        if r["due"] >= until:
            continue
        t = stats.first_token_at(r)
        waiting = not r.get("error") and t >= until
        out.append(until - r["due"] if waiting else stats.ttft_s(ctx, r))
    return stats.percentile([x * 1e3 for x in out], 95) if out else None
