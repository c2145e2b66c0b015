"""Mean admission wait of the window's requests, the engine's own measure
(the one x-engine-queue-ms reports) (ms)."""


def read(ctx):
    return sum(ctx.queue_ms) / len(ctx.queue_ms) if ctx.queue_ms else None
