"""Mean over the window's requests of the time the HTTP surface adds on
either side of the engine: from the client's send to the engine's arrival
stamp, and from the engine's emit of the first token to the client's
receipt of it (ms; one monotonic clock in both processes). In a traced
run, over the requests whose first token came before its profiled window."""

from h100_bench import stats


def read(ctx):
    d = [(arrival - r["sent"]) + (t - emitted) for r in stats.requests(ctx)
         if r["rid"] in ctx.engine_first and "sent" in r
         and (t := stats.first_token_at(r)) is not None and t < ctx.counted_until
         for arrival, emitted in [ctx.engine_first[r["rid"]]]]
    return sum(d) / len(d) * 1e3 if d else None
