"""KV-cache event stream: the engine's stored/removed block hashes for the
router's precise prefix scorer.

Port of ``llm_d_inference_scheduler_tpu/engine/kv_events.py``. An event is
the document ``{"event": "stored" | "removed", "engine_id", "hashes"}`` over
the prefix hash chain of ``utils/hashing.py`` (the router's hash space), and
it goes out on two legs:

- HTTP SSE through the engine server's ``GET /kv_events`` (``EventHub``: the
  engine thread pushes, the server's event loop fans out to one bounded
  queue per subscriber; the router's default transport);
- ZMQ PUB, topic-prefixed multipart ``[b"kv-events", json]``, bound lazily
  on the engine thread. This leg needs ``pyzmq``, which is imported only
  here, inside the leg: without it an engine asked for an explicit event
  port refuses to start, and one on the default port logs once that the leg
  is off and serves SSE alone.
"""

from __future__ import annotations

import asyncio
import json
import logging

log = logging.getLogger("engine.torch.kv_events")

TOPIC = b"kv-events"
QUEUE_MAX = 10_000


def zmq_available() -> bool:
    try:
        import zmq  # noqa: F401
    except ImportError:
        return False
    return True


class EventHub:
    """Thread-safe fan-out of engine events to asyncio subscriber queues
    (the engine thread pushes; the server loop streams them as SSE)."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._subscribers: set[asyncio.Queue] = set()
        self.pushed = 0       # events handed to the loop
        self.delivered = 0    # queue puts (an event counts once per subscriber)

    @property
    def subscribers(self) -> int:
        return len(self._subscribers)

    def subscribe(self) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=QUEUE_MAX)
        self._subscribers.add(q)
        return q

    def unsubscribe(self, q: asyncio.Queue) -> None:
        self._subscribers.discard(q)

    def push(self, event: dict) -> None:
        """Callable from any thread."""
        self.pushed += 1

        def _deliver():
            for q in list(self._subscribers):
                try:
                    q.put_nowait(event)
                    self.delivered += 1
                except asyncio.QueueFull:
                    pass  # slow subscriber: drop (the snapshot re-converges)

        try:
            self._loop.call_soon_threadsafe(_deliver)
        except RuntimeError:
            pass  # the server's loop is closed: nobody is listening


class KvEventPublisher:
    """Publishes one engine's events to the attached ``EventHub`` and, when
    ``zmq_port`` is set, to a ZMQ PUB socket. ZMQ sockets are single-thread
    objects, so the socket is created on the first publishing thread (the
    engine thread, through ``bind_now`` at its start)."""

    def __init__(self, engine_id: str, host: str = "127.0.0.1"):
        self.engine_id = engine_id
        self.host = host
        self.zmq_port = 0     # 0: the ZMQ leg is off
        self.hub: EventHub | None = None  # attached by the engine server
        self._sock = None
        self._failed = False

    def bind_now(self) -> None:
        """Bind the PUB socket on the calling thread (a no-op with the leg
        off); a failure turns the leg off and is logged."""
        if not self.zmq_port or self._sock is not None or self._failed:
            return
        try:
            import zmq

            sock = zmq.Context.instance().socket(zmq.PUB)
            sock.setsockopt(zmq.SNDHWM, QUEUE_MAX)
            sock.bind(f"tcp://{self.host}:{self.zmq_port}")
        except Exception:
            log.exception("kv event ZMQ bind on port %d failed; the ZMQ leg "
                          "is off", self.zmq_port)
            self._failed = True
            return
        self._sock = sock

    def publish(self, event: str, hashes: list[int]) -> None:
        if not hashes:
            return
        doc = {"event": event, "engine_id": self.engine_id, "hashes": hashes}
        if self.hub is not None:
            self.hub.push(doc)
        if not self.zmq_port or self._failed:
            return
        if self._sock is None:
            self.bind_now()
            if self._sock is None:
                return
        import zmq

        try:
            self._sock.send_multipart([TOPIC, json.dumps(doc).encode()],
                                      flags=zmq.NOBLOCK)
        except zmq.ZMQError:
            log.debug("kv event dropped (HWM)")

    def stored(self, hashes: list[int]) -> None:
        self.publish("stored", hashes)

    def removed(self, hashes: list[int]) -> None:
        self.publish("removed", hashes)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close(linger=0)
            self._sock = None
