"""Arithmetic over the load generator's records, shared by the metric
readers. Times are ``time.monotonic()`` seconds; a record is one request.

A request that failed counts as missing any latency limit: its latency is
taken as the longest the run could have observed (from its due time to the
end of the wait past the window).
"""

from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between ranks."""
    xs = sorted(values)
    if not xs:
        return math.nan
    k = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def requests(ctx) -> list[dict]:
    """The requests of the window (due in it, or sent in it by a closed
    loop), failed ones included."""
    return [r for r in ctx.records if r.get("rid") != "pool"]


def failed_latency_s(ctx, r: dict) -> float:
    return ctx.end + ctx.wait_s - r["due"]


def first_token_at(r: dict) -> float | None:
    """Arrival of the first streamed piece (the finish, if every token was
    a special that streams no text)."""
    if r.get("error"):
        return None
    return r["pieces"][0][0] if r["pieces"] else r["done"]


def ttft_s(ctx, r: dict) -> float:
    t = first_token_at(r)
    return failed_latency_s(ctx, r) if t is None else t - r["due"]


def tpot_s(ctx, r: dict) -> float | None:
    """(last token - first token) / (output tokens - 1); None for a
    one-token request."""
    if r.get("error"):
        return failed_latency_s(ctx, r)
    n = r["completion_tokens"]
    if n is None or n < 2:
        return None
    last = r["pieces"][-1][0] if r["pieces"] else r["done"]
    return (last - first_token_at(r)) / (n - 1)


def tokens_in_window(ctx) -> int:
    """Output tokens received inside the window: one streamed character is
    one token (the byte tokenizer streams one character per token)."""
    return sum(n for r in requests(ctx) for t, n in r.get("pieces", [])
               if ctx.start <= t < ctx.end)
