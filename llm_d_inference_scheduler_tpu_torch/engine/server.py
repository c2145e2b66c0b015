"""OpenAI-compatible HTTP surface of the PyTorch engine, on the standard library.

Port of the generate surface of ``llm_d_inference_scheduler_tpu/engine/server.py``
with the same JSON shapes, so the router schedules onto either engine alike:

- ``POST /v1/completions`` and ``/v1/chat/completions``, plain or SSE-streamed
  (``"stream": true``), with stop strings (a stop spanning token boundaries
  is held back, never leaked) and ``usage.prompt_tokens_details``;
- ``POST /v1/responses`` (the Responses API over the chat template, plain or
  with semantic SSE events), ``POST /v1/embeddings`` (mean-pooled vectors
  from ``TorchEngine.embed``), and the token-producer's
  ``POST /v1/completions/render`` and ``/v1/chat/completions/render``;
- ``GET /v1/models``, ``/metrics`` (Prometheus text, ``jetstream:*`` names)
  and ``/health``;
- ``GET /kv_events``: the KV-cache event stream as SSE (one ``data:`` frame
  per stored/removed event, a ``: ping`` comment every second), which the
  router's precise prefix scorer subscribes to; 501 with events off;
- ``GET /debug/kv`` (the prefix-hit ring and totals) and ``GET
  /debug/traces`` (the engine's span ring: an ``engine.request`` span per
  generate request, joined to an incoming ``traceparent``, with its
  ``engine.prefill`` and ``engine.decode`` phases);
- the P/D KV handoff: ``kv_transfer_params`` relayed into the request and out
  of the response, ``GET /kv/{request_id}`` (the whole export, or with
  ``?chunk=N`` / ``?ack=1`` the chunk-streamed long-poll: 200, 202 on wait
  expiry, 204 past the last chunk, 404 unknown) and
  ``DELETE /kv/{request_id}`` (release);
- E/P/D multimodal serving, on the JAX server's wire: ``POST /v1/encode``
  runs the vision tower over a request's ``items`` and stages the rows for
  ``GET /ec/{request_id}``; a generate request naming ``ec_sources`` pulls
  them from every source at once, restores the items' global order and
  prefills with the embeddings spliced in at placeholder tokens;
- the shared-storage probe: ``cache_hit_threshold`` in a generate body,
  answered ``finish_reason: "cache_threshold"`` when the cache is too cold;
- TLS serving (``--secure-serving``: ``--cert-path`` or a self-signed
  certificate, ``--enable-cert-reload``), and the client legs' policy
  (``--client-verify``, ``--client-ca-cert``) on the ``/ec`` and ``/kv``
  pulls (``utils/tls.py``);
- the chaos shim (``--chaos``/``ENGINE_CHAOS``, ``utils/faults.py``): on
  the generate routes, before the deadline check, ``delay``, ``http503``
  (``x-removal-reason: chaos-injected``), ``reset`` and ``stall``, decided
  by request id; and the lifecycle kinds, decided once per ``host:port``:
  ``spawn_fail`` (``start`` raises before the engine starts),
  ``slow_start`` (``/health`` reports ``warming`` for ``arg`` ms) and
  ``stall_drain`` (``/metrics`` adds ``arg`` phantom running requests).

Non-streamed responses carry ``x-kv-hit-blocks`` / ``x-kv-hit-tokens`` and
``x-engine-queue-ms``, and a decode leg that pulled KV ``x-kv-pull-ms``,
``-bytes``, ``-route`` (and ``-exposed-ms`` for a chunk-streamed pull).
HTTP/1.1 with keep-alive; SSE bodies use chunked transfer encoding. The server is built on ``asyncio`` streams so that
serving needs no HTTP package beyond the standard library.

The engine behind it is ``TorchEngine`` or, with ``--backend sim``, the CPU
simulator (``engine/sim.py``); where the JAX server treats a sim
differently, so does this one: a sim's ``GET /kv/{id}`` answers 501 (it
holds no KV), and its chunk answers carry the block count without bytes.

Run: ``python -m llm_d_inference_scheduler_tpu_torch.engine.server --model llama3-8b``
(``--device cpu`` or ``--platform cpu`` to run on the CPU; ``--pp-size``,
``--tp-size`` and ``--ep-size`` shard the model over ``--devices``).
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import http.client
import json
import logging
import os
import time
import urllib.parse
import uuid
from typing import Any

import numpy as np

from ..utils.faults import FaultInjector
from ..utils.tls import TlsServing
from ..utils.tracing import tracer
from . import kv_wire
from .config import EngineConfig
from .kv_events import EventHub
from .request import EngineRequest, FinishReason, TokenEvent
from .telemetry import CONTENT_TYPE as METRICS_CONTENT_TYPE

log = logging.getLogger("engine.torch.server")

_REASONS = {200: "OK", 202: "Accepted", 204: "No Content", 400: "Bad Request",
            404: "Not Found", 405: "Method Not Allowed", 413: "Payload Too Large",
            500: "Internal Server Error", 501: "Not Implemented",
            503: "Service Unavailable", 504: "Gateway Timeout"}
MAX_BODY = 64 << 20


class HTTPError(Exception):
    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status
        self.text = text


def _first_stop_hit(text: str, stop_strings: list[str] | None) -> int | None:
    """Index of the earliest stop-string occurrence in text, or None."""
    if not stop_strings:
        return None
    hits = [h for h in (text.find(s) for s in stop_strings) if h >= 0]
    return min(hits) if hits else None


def _stop_holdback(text: str, stop_strings: list[str] | None) -> int:
    """Length of the longest text suffix that is a proper prefix of a stop
    string — held back so a stop spanning token boundaries never leaks."""
    if not stop_strings:
        return 0
    hold = 0
    for s in stop_strings:
        for k in range(min(len(s) - 1, len(text)), 0, -1):
            if text.endswith(s[:k]):
                hold = max(hold, k)
                break
    return hold


def _chat_to_prompt(messages: list[dict[str, Any]], *,
                    continue_final_message: bool = False) -> str:
    """The JAX server's minimal chat template: role-tagged lines + cue."""
    parts = []
    for m in messages:
        content = m.get("content") or ""
        if isinstance(content, list):
            content = " ".join(c.get("text", "") for c in content if isinstance(c, dict))
        parts.append(f"{m.get('role', 'user')}: {content}")
    if continue_final_message and messages and messages[-1].get("role") == "assistant":
        return "\n".join(parts)
    parts.append("assistant:")
    return "\n".join(parts)


def _responses_input_to_messages(body: dict[str, Any]) -> list[dict[str, Any]]:
    """A Responses API body as chat messages (the JAX server's mapping):
    ``instructions`` is the system turn; ``input`` is a user string or an
    array of strings and message items."""
    messages: list[dict[str, Any]] = []
    instructions = body.get("instructions")
    if isinstance(instructions, str) and instructions:
        messages.append({"role": "system", "content": instructions})
    inp = body.get("input")
    if isinstance(inp, str):
        messages.append({"role": "user", "content": inp})
    elif isinstance(inp, list):
        for item in inp:
            if isinstance(item, str):
                messages.append({"role": "user", "content": item})
            elif isinstance(item, dict) and item.get("type") in (None, "message"):
                messages.append({"role": item.get("role", "user"),
                                 "content": item.get("content") or ""})
    return messages


def _sse(doc: Any) -> bytes:
    return f"data: {json.dumps(doc)}\n\n".encode()


class _Conn:
    """One HTTP response being written on a client connection, with the
    request's path, query and (lower-cased) headers."""

    def __init__(self, writer: asyncio.StreamWriter, keep_alive: bool,
                 path: str = "", query: dict[str, str] | None = None,
                 headers: dict[str, str] | None = None):
        self.writer = writer
        self.keep_alive = keep_alive
        self.path = path
        self.query = query or {}
        self.headers = headers or {}

    def _head(self, status: int, headers: dict[str, str]) -> bytes:
        lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}"]
        headers = dict(headers)
        headers["Connection"] = "keep-alive" if self.keep_alive else "close"
        lines += [f"{k}: {v}" for k, v in headers.items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def send(self, status: int, body: bytes | tuple, content_type: str,
                   headers: dict[str, str] | None = None) -> None:
        """A response whose body is bytes or a tuple of buffers (written as
        they are, without joining them); a 204 carries no body."""
        parts = body if isinstance(body, tuple) else (body,)
        h = dict(headers or {})
        if status != 204:
            h = {"Content-Type": content_type,
                 "Content-Length": str(sum(memoryview(p).nbytes for p in parts)),
                 **h}
        self.writer.write(self._head(status, h))
        if status != 204:
            for p in parts:
                self.writer.write(p)
        await self.writer.drain()

    async def send_json(self, obj: Any, status: int = 200,
                        headers: dict[str, str] | None = None) -> None:
        await self.send(status, json.dumps(obj).encode(), "application/json",
                        headers)

    async def start_stream(self) -> None:
        self.writer.write(self._head(200, {
            "Content-Type": "text/event-stream", "Cache-Control": "no-cache",
            "Transfer-Encoding": "chunked"}))
        await self.writer.drain()

    async def write_chunk(self, data: bytes) -> None:
        if data:
            self.writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            await self.writer.drain()

    async def end_stream(self) -> None:
        self.writer.write(b"0\r\n\r\n")
        await self.writer.drain()


BACKENDS = ("torch", "sim")


def make_engine(cfg: EngineConfig):
    """The engine ``cfg.backend`` names (the JAX ``make_engine``)."""
    if cfg.backend == "sim":
        from .sim import SimEngine

        return SimEngine(cfg)
    if cfg.backend == "torch":
        from .core import TorchEngine

        return TorchEngine(cfg)
    raise ValueError(f"unknown engine backend {cfg.backend!r}: the PyTorch port "
                     f"has {', '.join(BACKENDS)} ('tpu' is the JAX package's engine)")


class EngineServer:
    """The engine's HTTP surface. ``port=0`` binds a free port (``self.port``
    holds the bound one after ``start``)."""

    def __init__(self, cfg: EngineConfig, engine=None):
        if engine is None:
            engine = make_engine(cfg)
        self.cfg = cfg
        self.engine = engine
        self.draining = False
        self.port = cfg.port
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()
        self._tls: TlsServing | None = None
        # The chaos shim; a mutable attribute, so a test can flip
        # ``chaos.enabled`` mid-run. Lifecycle kinds decide once per pod
        # identity: the same seed fails the same spawns every run.
        self.chaos = FaultInjector.from_spec(
            cfg.chaos or os.environ.get("ENGINE_CHAOS", ""), seed=cfg.chaos_seed)
        pod_id = f"{cfg.host}:{cfg.port}"

        def lifecycle(kind):
            return self.chaos.decide_lifecycle(kind, pod_id) if self.chaos else None

        self._chaos_spawn_fail = lifecycle("spawn_fail")
        self._chaos_slow_start = lifecycle("slow_start")
        self._chaos_stall_drain = lifecycle("stall_drain")
        self._ready_at_mono = 0.0  # slow_start: /health reports warming until then
        self._routes = {
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/v1/chat/completions"): self.chat_completions,
            ("POST", "/v1/responses"): self.responses,
            ("POST", "/v1/embeddings"): self.embeddings,
            ("POST", "/v1/completions/render"): self.render_completions,
            ("POST", "/v1/chat/completions/render"): self.render_chat,
            ("GET", "/v1/models"): self.models,
            ("GET", "/metrics"): self.metrics,
            ("GET", "/health"): self.health,
            ("GET", "/kv/"): self.kv_fetch,
            ("DELETE", "/kv/"): self.kv_release,
            ("GET", "/kv_events"): self.kv_events_stream,
            ("GET", "/debug/kv"): self.kv_debug,
            ("GET", "/debug/traces"): self.traces,
            ("POST", "/v1/encode"): self.encode,
            ("GET", "/ec/"): self.ec_fetch,
        }
        # E/P/D encode store: request_id -> {"embeds": f32 [rows, D] on the
        # host, "indices": global item indices}, an LRU bounded so that
        # unclaimed embeddings cannot grow host memory without limit.
        self.ec_store: collections.OrderedDict[str, dict[str, Any]] = \
            collections.OrderedDict()

    # ---- lifecycle -----------------------------------------------------

    async def start(self):
        if self._chaos_spawn_fail is not None:
            raise RuntimeError(f"chaos spawn_fail: engine {self.cfg.host}:"
                               f"{self.cfg.port} refused to start")
        if self._chaos_slow_start is not None:
            self._ready_at_mono = (time.monotonic()
                                   + self._chaos_slow_start.arg / 1000.0)
        if self.cfg.secure_serving and self._tls is None:
            # Before the engine starts: a bad cert path fails at once.
            self._tls = TlsServing(self.cfg.cert_path or None,
                                   self.cfg.enable_cert_reload)
        # The SSE hub is attached before the engine thread can publish, and
        # the listener bound first, so the engine knows the port /kv peers
        # dial (and its ZMQ event leg's default, port + 1000).
        if self.engine.kv_events is not None:
            self.engine.kv_events.hub = EventHub(asyncio.get_running_loop())
        self._server = await asyncio.start_server(
            self._client, self.cfg.host, self.cfg.port,
            ssl=self._tls.ssl_context if self._tls else None)
        self.port = self._server.sockets[0].getsockname()[1]
        self.engine.advertised_port = self.port
        try:
            await self.engine.start()
        except BaseException:
            self._server.close()
            await self._server.wait_closed()
            raise
        log.info("engine %s serving %s on %s:%d%s", self.engine.engine_id,
                 self.engine.model_name, self.cfg.host, self.port,
                 " (TLS)" if self._tls else "")

    async def stop(self):
        if self._server is not None:
            self._server.close()
        for task in list(self._conns):  # idle keep-alive connections too
            task.cancel()
        if self._server is not None:
            await self._server.wait_closed()
        await self.engine.stop()
        if self._tls is not None:
            self._tls.close()
            self._tls = None

    # ---- HTTP plumbing -------------------------------------------------

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while await self._one_request(reader, writer):
                pass
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.LimitOverrunError):
            pass  # the client went away or sent a malformed head
        finally:
            self._conns.discard(task)
            writer.close()

    async def _one_request(self, reader, writer) -> bool:
        """Serve one request; returns whether the connection stays open."""
        head = await reader.readuntil(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ", 2)
        except ValueError:
            return False
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        keep_alive = (headers.get("connection", "").lower() != "close"
                      and version == "HTTP/1.1")
        path, _, query = target.partition("?")
        conn = _Conn(writer, keep_alive, path,
                     dict(urllib.parse.parse_qsl(query, keep_blank_values=True)),
                     headers)
        try:
            n = int(headers.get("content-length") or 0)
        except ValueError:
            n = -1
        if n < 0:
            conn.keep_alive = False
            await conn.send(400, b"400: bad Content-Length", "text/plain")
            return False
        if n > MAX_BODY:
            conn.keep_alive = False
            await conn.send(413, b"request body too large", "text/plain")
            return False
        if n and headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        body = await reader.readexactly(n) if n else b""
        route = next((p for p in ("/kv/", "/ec/") if path.startswith(p)), path)
        handler = self._routes.get((method, route))
        try:
            if handler is None:
                known = any(p == route for _, p in self._routes)
                raise HTTPError(405 if known else 404,
                                f"{method} {path} not served")
            if method == "POST" and path in self.GEN_PATHS:
                if not await self._inject_fault(conn, body):
                    await self._within_deadline(handler, conn, body)
            else:
                await handler(conn, body)
        except HTTPError as e:
            await conn.send(e.status, f"{e.status}: {e.text}".encode(),
                            "text/plain; charset=utf-8")
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception:
            log.exception("handler failure on %s %s", method, path)
            conn.keep_alive = False
            await conn.send(500, b"500: internal server error",
                            "text/plain; charset=utf-8")
        return conn.keep_alive

    # ---- chaos and deadlines --------------------------------------------

    GEN_PATHS = ("/v1/completions", "/v1/chat/completions", "/v1/responses")

    @staticmethod
    def _chaos_request_id(conn: _Conn, body: bytes) -> str:
        """The fault decision's identity: ``x-request-id`` (the router
        always forwards one), else the body's ``request_id``, else a random
        id (a valid sample, not a replayable one)."""
        rid = conn.headers.get("x-request-id")
        if rid:
            return rid
        try:
            rid = json.loads(body).get("request_id")
        except Exception:
            rid = None
        return str(rid) if rid else uuid.uuid4().hex

    async def _inject_fault(self, conn: _Conn, body: bytes) -> bool:
        """The JAX server's chaos half of its generate-route middleware;
        True when the fault answered the request. ``reset`` closes the
        connection before any response byte (a pre-stream transport error,
        the retryable class); ``http503`` answers a retryable 503;
        ``delay`` sleeps ``arg`` ms and serves; ``stall`` starts an SSE
        response, writes one partial event and closes after ``arg`` ms (10
        by default)."""
        if self.chaos is None or not self.chaos.rules:
            return False
        rule = self.chaos.decide(self._chaos_request_id(conn, body))
        if rule is None:
            return False
        log.info("chaos: injecting %s for %s", rule.kind, conn.path)
        if rule.kind == "delay":
            await asyncio.sleep(rule.arg / 1000.0)
            return False
        if rule.kind == "http503":
            await conn.send_json({"error": "chaos: injected 503"}, status=503,
                                 headers={"x-removal-reason": "chaos-injected"})
            return True
        if rule.kind == "stall":
            await conn.start_stream()
            await conn.write_chunk(b'data: {"choices":[{"index":0,"text":"chaos"}]}\n\n')
            await asyncio.sleep((rule.arg or 10.0) / 1000.0)
        conn.keep_alive = False  # reset, and a stall's end: drop the connection
        conn.writer.close()
        return True

    async def _within_deadline(self, handler, conn: _Conn, body: bytes) -> None:
        """The JAX server's deadline enforcement on the generate routes: an
        ``x-request-timeout`` header (remaining seconds, stamped by the
        gateway and the sidecar) bounds the serve. A budget that does not
        parse is ignored; one <= 0 answers 504 before anything is admitted;
        a non-streaming request past its budget is cancelled (its engine
        request aborted, so the slot and blocks come back) and answered
        504; a stream's watchdog closes the connection, the only honest
        signal once the status line is on the wire, and cancels the
        handler, which aborts the engine request."""
        try:
            remaining = float(conn.headers["x-request-timeout"])
        except (KeyError, ValueError):
            return await handler(conn, body)
        if remaining <= 0:
            return await self._deadline_exceeded(conn)
        try:
            is_stream = bool(json.loads(body).get("stream"))
        except Exception:
            is_stream = False
        if is_stream:
            task = asyncio.current_task()

            def expire():
                conn.keep_alive = False
                conn.writer.close()
                task.cancel()

            watchdog = asyncio.get_running_loop().call_later(remaining, expire)
            try:
                return await handler(conn, body)
            finally:
                watchdog.cancel()
        try:
            await asyncio.wait_for(handler(conn, body), timeout=remaining)
        except asyncio.TimeoutError:
            # wait_for cancelled the handler, whose CancelledError path
            # aborted the engine request.
            await self._deadline_exceeded(conn)

    @staticmethod
    async def _deadline_exceeded(conn: _Conn) -> None:
        await conn.send_json({"error": "deadline exceeded"}, status=504,
                             headers={"x-removal-reason": "deadline-exceeded"})

    @staticmethod
    def _json_body(raw: bytes) -> dict[str, Any]:
        try:
            body = json.loads(raw or b"null")
        except ValueError:
            raise HTTPError(400, "request body must be valid JSON")
        if not isinstance(body, dict):
            raise HTTPError(400, "request body must be a JSON object")
        return body

    # ---- request plumbing ---------------------------------------------

    def _tokenize_prompt(self, prompt) -> list[int]:
        if isinstance(prompt, str):
            return self.engine.tokenizer.encode(prompt)
        if isinstance(prompt, list) and all(isinstance(t, int) for t in prompt):
            return prompt
        raise HTTPError(400, "prompt must be a string or a list of token ids")

    # ---- E/P/D multimodal ------------------------------------------------

    EC_CAPACITY = 1024       # staged encode results kept (LRU)
    EC_TIMEOUT_S = 10.0      # each /ec pull's socket timeout

    def _item_pixels(self, item: dict[str, Any], vcfg) -> np.ndarray:
        """Pixels of one multimodal item: inline ``pixels`` (H, W[, C]
        floats), zero-padded or cropped to the tower's square input; any
        other item (an image URL: the engine fetches nothing) gets seeded
        pseudo-pixels from the SHA-256 of its JSON, so two URLs give two
        embeddings."""
        px = item.get("pixels")
        if px is not None:
            try:
                arr = np.asarray(px, np.float32)
            except (TypeError, ValueError):
                raise HTTPError(400, "item pixels must be a numeric H x W [x C] array")
            if arr.ndim == 2:
                arr = arr[..., None]
            if arr.ndim != 3:
                raise HTTPError(400, "item pixels must be a numeric H x W [x C] array")
            out = np.zeros((vcfg.image_size, vcfg.image_size, vcfg.channels),
                           np.float32)
            h = min(arr.shape[0], vcfg.image_size)
            w = min(arr.shape[1], vcfg.image_size)
            c = min(arr.shape[2], vcfg.channels)
            out[:h, :w, :c] = arr[:h, :w, :c]
            return out
        digest = hashlib.sha256(json.dumps(item, sort_keys=True).encode()).digest()
        rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
        return rng.standard_normal(
            (vcfg.image_size, vcfg.image_size, vcfg.channels)).astype(np.float32)

    async def encode(self, conn: _Conn, raw: bytes) -> None:
        """E/P/D encode leg, the sidecar's fan-out target: run the vision
        tower over the request's ``items`` and stage the rows for the
        prefill and decode engines to pull from ``GET /ec/{request_id}``."""
        body = self._json_body(raw)
        rid = str(body.get("request_id") or f"enc-{uuid.uuid4().hex[:8]}")
        items = body.get("items") or []
        if not isinstance(items, list) or not all(isinstance(i, dict) for i in items):
            raise HTTPError(400, "items must be a list of objects")
        indices = body.get("item_indices")
        if not isinstance(indices, list) or len(indices) != len(items):
            indices = list(range(len(items)))
        try:
            indices = [int(i) for i in indices]
        except (TypeError, ValueError):
            raise HTTPError(400, "item_indices must be integers")
        if items:
            vcfg, _ = await asyncio.to_thread(self.engine.vision)
            pixels = np.stack([self._item_pixels(it, vcfg) for it in items])
            embeds = await asyncio.to_thread(self.engine.encode_images, pixels)
        else:
            embeds = np.zeros((0, 0), np.float32)
        self.ec_store[rid] = {"embeds": embeds, "indices": indices}
        self.ec_store.move_to_end(rid)
        while len(self.ec_store) > self.EC_CAPACITY:
            self.ec_store.popitem(last=False)
        await conn.send_json({"request_id": rid, "encoded_items": len(items),
                              "embedding_tokens": int(embeds.shape[0])})

    async def ec_fetch(self, conn: _Conn, raw: bytes) -> None:
        """A staged encode result as the JAX server sends it: JSON float
        rows, the width and the global item indices."""
        rid = urllib.parse.unquote(conn.path[len("/ec/"):])
        rec = self.ec_store.get(rid)
        if rec is None:
            raise HTTPError(404, f"no encoded embeddings for {rid}")
        embeds = rec["embeds"]
        doc = {"request_id": rid,
               "dim": int(embeds.shape[1]) if embeds.size else 0,
               "item_indices": rec["indices"],
               "embeddings": embeds.tolist()}
        # ~1.3 MB of JSON per llama3-8b image: encoded off the event loop.
        payload = await asyncio.to_thread(lambda: json.dumps(doc).encode())
        await conn.send(200, payload, "application/json")

    def _fetch_ec(self, source: str, rid: str, headers: dict[str, str]) -> bytes | None:
        """GET ``/ec/{rid}`` from one encode source (``host:port``, or a URL
        when the sidecar's encoder leg is TLS), on a worker thread; the
        body, or None after a warning. An ``https`` source follows the
        engine's client policy (skip-verify by default, or the CA bundle)."""
        base = urllib.parse.urlsplit(source if "://" in source else f"http://{source}")
        try:
            if base.scheme == "https":
                conn = http.client.HTTPSConnection(
                    base.hostname, base.port or 443, timeout=self.EC_TIMEOUT_S,
                    context=self.engine.client_tls())
            else:
                conn = http.client.HTTPConnection(base.hostname, base.port or 80,
                                                  timeout=self.EC_TIMEOUT_S)
            try:
                path = (base.path.rstrip("/") + "/ec/"
                        + urllib.parse.quote(rid, safe=""))
                conn.request("GET", path, headers=headers)
                r = conn.getresponse()
                payload = r.read()
            finally:
                conn.close()
            if r.status != 200:
                raise ValueError(f"answered {r.status}")
            return payload
        except (OSError, http.client.HTTPException, ValueError, TypeError) as e:
            log.warning("ec fetch from %s for %s failed: %s", source, rid, e)
            return None

    async def _resolve_multimodal(self, body: dict[str, Any], prompt_ids: list[int]
                                  ) -> tuple[list[int], np.ndarray | None, list[int] | None]:
        """E/P/D prefill: pull the staged encoder embeddings from every
        ``ec_sources`` entry at once, restore the items' global order from
        each source's ``item_indices`` (every item has the same row count),
        and prepend one placeholder token 0 per row (image-first layout).
        Returns (prompt, mm_embeds [M, D] or None, mm_positions or None);
        rows whose width is not the model's d_model are ignored."""
        sources = body.get("ec_sources") or []
        if not sources:
            return prompt_ids, None, None
        if not isinstance(sources, list) or not all(isinstance(h, str) for h in sources):
            raise HTTPError(400, "ec_sources must be a list of host:port strings")
        rid = str(body.get("request_id") or "")
        headers: dict[str, str] = {}
        tracer.inject_headers(headers)
        bodies = await asyncio.gather(*[
            asyncio.to_thread(self._fetch_ec, h, rid, headers) for h in sources])
        tagged = []
        for payload in bodies:
            if payload is None:
                continue
            try:
                doc = json.loads(payload)
                arr = np.asarray(doc.get("embeddings") or [], np.float32)
                indices = [int(i) for i in (doc.get("item_indices") or [0])]
            except (ValueError, TypeError, AttributeError) as e:
                log.warning("ec payload for %s unreadable: %s", rid, e)
                continue
            if arr.ndim != 2 or not arr.size:
                continue
            per = arr.shape[0] // max(len(indices), 1)
            for j, idx in enumerate(indices):
                tagged.append((idx, arr[j * per:(j + 1) * per]))
        if not tagged:
            return prompt_ids, None, None
        tagged.sort(key=lambda t: t[0])
        mm = np.concatenate([rows for _, rows in tagged], axis=0)
        if mm.shape[1] != self.engine.mcfg.d_model:
            log.warning("encoder dim %d != model d_model %d; ignoring the "
                        "multimodal embeddings", mm.shape[1], self.engine.mcfg.d_model)
            return prompt_ids, None, None
        m = mm.shape[0]
        return [0] * m + prompt_ids, mm, list(range(m))

    def _build_request(self, body: dict[str, Any], prompt_ids: list[int],
                       mm_embeds: np.ndarray | None = None,
                       mm_positions: list[int] | None = None) -> EngineRequest:
        # An over-context prompt is a client error; max_tokens that overruns
        # the context is clamped (finish_reason "length"), as the JAX server.
        if len(prompt_ids) + 1 > self.cfg.max_model_len:
            raise HTTPError(
                400, f"prompt is {len(prompt_ids)} tokens; this engine's "
                     f"maximum context length is {self.cfg.max_model_len} "
                     "(including at least one generated token)")
        ktp = body.get("kv_transfer_params")
        if ktp is not None and not isinstance(ktp, dict):
            raise HTTPError(400, "kv_transfer_params must be a JSON object")
        try:
            return EngineRequest(
                request_id=str(body.get("request_id") or f"req-{uuid.uuid4().hex[:12]}"),
                prompt_token_ids=prompt_ids,
                max_tokens=int(body.get("max_tokens") or 16),
                # OpenAI default: temperature 1.0 when absent (0 = greedy).
                temperature=(1.0 if body.get("temperature") is None
                             else float(body["temperature"])),
                top_k=int(body.get("top_k") or 0),
                top_p=float(body.get("top_p") if body.get("top_p") is not None else 1.0),
                stream=bool(body.get("stream", False)),
                stop_token_ids=tuple(int(t) for t in (body.get("stop_token_ids") or ())),
                ignore_eos=bool(body.get("ignore_eos", False)),
                cache_hit_threshold=(float(body["cache_hit_threshold"])
                                     if body.get("cache_hit_threshold") is not None
                                     else None),
                kv_transfer_params=ktp,
                mm_embeds=mm_embeds,
                mm_positions=mm_positions,
            )
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"invalid sampling/limit parameter: {e}")

    @staticmethod
    def _stop_strings(body: dict[str, Any]) -> list[str]:
        stop = body.get("stop")
        if stop is None:
            return []
        return [stop] if isinstance(stop, str) else [s for s in stop if isinstance(s, str)]

    def _kv_hit_usage(self, req: EngineRequest) -> dict[str, int] | None:
        rec = self.engine.kv_hits.get(req.request_id)
        return None if rec is None else {"cached_tokens": rec["hit_tokens"]}

    def _response_headers(self, req: EngineRequest) -> dict[str, str]:
        """x-kv-hit-* (engine-confirmed prefix hit), x-engine-queue-ms
        (admission wait) and, for a decode leg that pulled KV, x-kv-pull-*
        (the fetch thread's measurement), popped once per request."""
        out = {}
        if (req.kv_transfer_params or {}).get("remote_host") is not None:
            stats = self.engine.kv_import_stats.pop(req.request_id, None)
            if stats:
                out["x-kv-pull-ms"] = f"{stats['ms']:.2f}"
                out["x-kv-pull-bytes"] = str(stats["bytes"])
                out["x-kv-pull-route"] = stats["route"]
                if stats.get("exposed_ms") is not None:
                    out["x-kv-pull-exposed-ms"] = f"{stats['exposed_ms']:.2f}"
        rec = self.engine.kv_hits.pop(req.request_id)
        if rec is not None:
            out["x-kv-hit-blocks"] = str(rec["hit_blocks"])
            out["x-kv-hit-tokens"] = str(rec["hit_tokens"])
        ms = self.engine.queue_waits.pop(req.request_id, None)
        if ms is not None:
            out["x-engine-queue-ms"] = f"{ms:.2f}"
        return out

    @staticmethod
    def _mark_first_token(timing: dict[str, float], ev: TokenEvent) -> None:
        """Stamp the first token-bearing event's arrival for phase spans."""
        if ev.token_id is not None and "first_token_at" not in timing:
            timing["first_token_at"] = time.monotonic()

    def _request_span(self, conn: _Conn):
        """The engine's server span, joined to the caller's W3C trace
        context when the gateway or sidecar propagated one."""
        return tracer.span_from_headers("engine.request", conn.headers,
                                        path=conn.path,
                                        engine_id=self.engine.engine_id)

    @staticmethod
    def _record_phase_spans(t_submit: float, timing: dict[str, float]) -> None:
        """Prefill (submit to first token: queue + prefill) and decode (first
        token to finish) phase spans under the live engine.request span."""
        first = timing.get("first_token_at")
        if first is None:
            return
        done = time.monotonic()
        tracer.record("engine.prefill", t_submit, first)
        if done > first:
            tracer.record("engine.decode", first, done)

    async def _collect(self, req: EngineRequest, out: asyncio.Queue,
                       stop_strings: list[str],
                       timing: dict[str, float]) -> dict[str, Any]:
        acc = ""
        n_completion, n_prompt = 0, len(req.prompt_token_ids)
        finish = FinishReason.LENGTH
        kv_params = None
        while True:
            ev: TokenEvent = await out.get()
            self._mark_first_token(timing, ev)
            if ev.token_id is not None:
                acc += ev.text
                hit = _first_stop_hit(acc, stop_strings)
                if hit is not None:
                    acc = acc[:hit]
                    finish = FinishReason.STOP
                    self.engine.abort(req.request_id)
                    n_completion = max(n_completion, ev.completion_tokens)
                    break
            n_completion = max(n_completion, ev.completion_tokens)
            if ev.finish_reason is not None:
                finish = ev.finish_reason
                kv_params = ev.kv_transfer_params
                break
        resp: dict[str, Any] = {
            "id": req.request_id,
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.engine.model_name,
            "choices": [{"index": 0, "text": acc,
                         "finish_reason": finish.value}],
            "usage": {"prompt_tokens": n_prompt,
                      "completion_tokens": n_completion,
                      "total_tokens": n_prompt + n_completion},
        }
        details = self._kv_hit_usage(req)
        if details is not None:
            resp["usage"]["prompt_tokens_details"] = details
        if kv_params is not None:
            resp["kv_transfer_params"] = kv_params
        return resp

    async def _stream(self, conn: _Conn, req: EngineRequest, out: asyncio.Queue,
                      chat: bool, stop_strings: list[str],
                      timing: dict[str, float]) -> None:
        await conn.start_stream()
        created = int(time.time())
        obj = "chat.completion.chunk" if chat else "text_completion"
        n_prompt = len(req.prompt_token_ids)

        async def write_piece(piece: str):
            if not piece:
                return
            delta = ({"delta": {"content": piece}, "index": 0, "finish_reason": None}
                     if chat else
                     {"text": piece, "index": 0, "finish_reason": None})
            chunk = {"id": req.request_id, "object": obj, "created": created,
                     "model": self.engine.model_name, "choices": [delta]}
            await conn.write_chunk(_sse(chunk))

        total = ""       # all generated text so far
        emitted = 0      # prefix of `total` already written
        while True:
            ev: TokenEvent = await out.get()
            self._mark_first_token(timing, ev)
            # Coalesce the awaited event with any queued burst (a decode
            # chunk emits K tokens at once): one SSE delta per drain.
            fin: TokenEvent | None = None
            last_tok: TokenEvent | None = None
            hit: int | None = None
            while True:
                if ev.token_id is not None:
                    total += ev.text
                    last_tok = ev
                    if stop_strings:
                        hit = _first_stop_hit(total, stop_strings)
                        if hit is not None:
                            break
                if ev.finish_reason is not None:
                    fin = ev
                    break
                try:
                    ev = out.get_nowait()
                except asyncio.QueueEmpty:
                    break
            if last_tok is not None:
                if hit is not None:
                    await write_piece(total[emitted:hit])
                    emitted = hit
                    self.engine.abort(req.request_id)
                    fin = TokenEvent(request_id=req.request_id, token_id=None,
                                     finish_reason=FinishReason.STOP,
                                     prompt_tokens=n_prompt,
                                     completion_tokens=last_tok.completion_tokens)
                else:
                    safe = len(total) - _stop_holdback(total, stop_strings)
                    if safe > emitted:
                        await write_piece(total[emitted:safe])
                        emitted = safe
            ev = fin if fin is not None else ev
            if ev.finish_reason is not None:
                if ev.finish_reason != FinishReason.STOP and emitted < len(total):
                    await write_piece(total[emitted:])  # flush holdback
                    emitted = len(total)
                prompt_tokens = ev.prompt_tokens or n_prompt
                final_choice = ({"delta": {}, "index": 0,
                                 "finish_reason": ev.finish_reason.value}
                                if chat else
                                {"text": "", "index": 0,
                                 "finish_reason": ev.finish_reason.value})
                usage = {"prompt_tokens": prompt_tokens,
                         "completion_tokens": ev.completion_tokens,
                         "total_tokens": prompt_tokens + ev.completion_tokens}
                details = self._kv_hit_usage(req)
                if details is not None:
                    usage["prompt_tokens_details"] = details
                chunk = {"id": req.request_id, "object": obj, "created": created,
                         "model": self.engine.model_name,
                         "choices": [final_choice], "usage": usage}
                await conn.write_chunk(_sse(chunk))
                await conn.write_chunk(b"data: [DONE]\n\n")
                break
        await conn.end_stream()
        # Streams sent their headers before admission: drop the per-request
        # records the non-streamed headers would have popped.
        self._response_headers(req)

    async def _run_request(self, span, body: dict[str, Any],
                           prompt_ids: list[int], stream_fn,
                           multimodal: bool = False) -> tuple[EngineRequest, dict | None]:
        """Submit one generate request inside its engine.request span and
        either stream it with ``stream_fn(req, out, timing)`` (returns
        (req, None)) or collect it (returns (req, the completion dict)).
        With ``multimodal`` the body's ``ec_sources`` are resolved first."""
        mm = mm_pos = None
        if multimodal:
            prompt_ids, mm, mm_pos = await self._resolve_multimodal(body, prompt_ids)
        req = self._build_request(body, prompt_ids, mm, mm_pos)
        span.set_attribute("request_id", req.request_id)
        timing: dict[str, float] = {}
        t0 = time.monotonic()
        out = self.engine.submit(req)
        try:
            if req.stream:
                await stream_fn(req, out, timing)
                resp = None
            else:
                resp = await self._collect(req, out, self._stop_strings(body),
                                           timing)
        except (asyncio.CancelledError, ConnectionError):
            self.engine.abort(req.request_id)  # client went away: stop decoding
            raise
        self._record_phase_spans(t0, timing)
        return req, resp

    async def _generate(self, conn: _Conn, body: dict[str, Any],
                        prompt_ids: list[int], chat: bool) -> None:
        stops = self._stop_strings(body)
        with self._request_span(conn) as span:
            req, resp = await self._run_request(
                span, body, prompt_ids,
                lambda req, out, timing: self._stream(conn, req, out, chat,
                                                      stops, timing),
                multimodal=True)
        if resp is None:
            return
        if chat:
            resp["object"] = "chat.completion"
            text = resp["choices"][0].pop("text")
            resp["choices"][0]["message"] = {"role": "assistant", "content": text}
        await conn.send_json(resp, headers=self._response_headers(req))

    # ---- handlers ------------------------------------------------------

    async def completions(self, conn: _Conn, raw: bytes) -> None:
        body = self._json_body(raw)
        await self._generate(conn, body, self._tokenize_prompt(body.get("prompt", "")),
                             chat=False)

    async def chat_completions(self, conn: _Conn, raw: bytes) -> None:
        body = self._json_body(raw)
        prompt = _chat_to_prompt(
            body.get("messages", []),
            continue_final_message=bool(body.get("continue_final_message")))
        await self._generate(conn, body, self.engine.tokenizer.encode(prompt),
                             chat=True)

    async def responses(self, conn: _Conn, raw: bytes) -> None:
        """OpenAI Responses API: ``instructions`` + ``input`` through the chat
        template, ``max_output_tokens`` for ``max_tokens``, the P/D
        ``kv_transfer_params`` relay, and a Responses-shaped reply (or, with
        ``stream``, ``response.output_text.delta`` ... ``response.completed``
        events)."""
        body = self._json_body(raw)
        prompt_ids = self.engine.tokenizer.encode(
            _chat_to_prompt(_responses_input_to_messages(body)))
        gen_body = dict(body)
        if body.get("max_output_tokens") is not None:
            gen_body["max_tokens"] = body["max_output_tokens"]
        gen_body.pop("stop", None)  # the Responses API has no stop strings
        with self._request_span(conn) as span:
            req, resp = await self._run_request(
                span, gen_body, prompt_ids,
                lambda req, out, timing: self._stream_responses(conn, req, out,
                                                                timing))
        # No x-kv-* / queue headers on this surface (as the JAX server):
        # drop the per-request records they would have popped.
        self._response_headers(req)
        if resp is None:
            return
        usage = resp["usage"]
        finish = resp["choices"][0]["finish_reason"]
        wrapped: dict[str, Any] = {
            "id": f"resp_{req.request_id}",
            "object": "response",
            "created_at": resp["created"],
            "status": ("incomplete" if finish in ("length", "cache_threshold")
                       else "completed"),
            "model": self.engine.model_name,
            "output": [{
                "type": "message", "id": f"msg_{req.request_id}",
                "status": "completed", "role": "assistant",
                "content": [{"type": "output_text", "annotations": [],
                             "text": resp["choices"][0]["text"]}],
            }],
            "usage": {"input_tokens": usage["prompt_tokens"],
                      "output_tokens": usage["completion_tokens"],
                      "total_tokens": usage["total_tokens"]},
        }
        if wrapped["status"] == "incomplete":
            # The sidecar's shared-storage probe reads the truncation cause
            # from here (a Responses body has no choices[].finish_reason).
            wrapped["incomplete_details"] = {
                "reason": "max_output_tokens" if finish == "length" else finish}
        if "kv_transfer_params" in resp:
            wrapped["kv_transfer_params"] = resp["kv_transfer_params"]
        await conn.send_json(wrapped)

    async def _stream_responses(self, conn: _Conn, req: EngineRequest,
                                out: asyncio.Queue,
                                timing: dict[str, float]) -> None:
        await conn.start_stream()
        n_prompt = len(req.prompt_token_ids)
        while True:
            ev: TokenEvent = await out.get()
            self._mark_first_token(timing, ev)
            if ev.token_id is not None and ev.text:
                await conn.write_chunk(_sse({"type": "response.output_text.delta",
                                             "delta": ev.text}))
            if ev.finish_reason is not None:
                prompt_tokens = ev.prompt_tokens or n_prompt
                status = ("incomplete" if ev.finish_reason == FinishReason.LENGTH
                          else "completed")
                await conn.write_chunk(_sse({"type": "response.completed", "response": {
                    "id": f"resp_{req.request_id}", "object": "response",
                    "status": status, "model": self.engine.model_name,
                    "usage": {"input_tokens": prompt_tokens,
                              "output_tokens": ev.completion_tokens,
                              "total_tokens": prompt_tokens + ev.completion_tokens}}}))
                await conn.write_chunk(b"data: [DONE]\n\n")
                break
        await conn.end_stream()

    async def embeddings(self, conn: _Conn, raw: bytes) -> None:
        """OpenAI /v1/embeddings: one mean-pooled final-hidden-state vector
        per input (a string, a list of strings, token ids, or a list of
        token-id lists), computed on the engine thread."""
        body = self._json_body(raw)
        raw_input = body.get("input")
        if raw_input is None or raw_input == [] or raw_input == "":
            raise HTTPError(400, "'input' must be a non-empty string, list, "
                                 "or token ids")
        if isinstance(raw_input, str) or (isinstance(raw_input, list) and all(
                isinstance(t, int) for t in raw_input)):
            items = [raw_input]
        elif isinstance(raw_input, list):
            items = raw_input
        else:
            raise HTTPError(400, "'input' must be a string, a list of "
                                 "strings, or token ids")
        prompts = []
        for i, item in enumerate(items):
            if item == "" or item == []:
                raise HTTPError(400, f"input {i} is empty")
            ids = self._tokenize_prompt(item)
            if len(ids) > self.cfg.max_model_len:
                raise HTTPError(400, f"input {i} is {len(ids)} tokens; maximum "
                                     f"context length is {self.cfg.max_model_len}")
            prompts.append(ids)
        loop = asyncio.get_running_loop()
        data = []
        for i, ids in enumerate(prompts):
            try:
                vec = await loop.run_in_executor(None, self.engine.embed, ids)
            except ValueError as e:
                raise HTTPError(501, str(e))
            data.append({"object": "embedding", "index": i,
                         "embedding": vec.tolist()})
        total = sum(len(ids) for ids in prompts)
        await conn.send_json({
            "object": "list", "data": data, "model": self.engine.model_name,
            "usage": {"prompt_tokens": total, "total_tokens": total}})

    async def render_completions(self, conn: _Conn, raw: bytes) -> None:
        body = self._json_body(raw)
        ids = self._tokenize_prompt(body.get("prompt", ""))
        await conn.send_json({"token_ids": ids, "count": len(ids)})

    async def render_chat(self, conn: _Conn, raw: bytes) -> None:
        body = self._json_body(raw)
        rendered = _chat_to_prompt(
            body.get("messages", []),
            continue_final_message=bool(body.get("continue_final_message")))
        ids = self.engine.tokenizer.encode(rendered)
        await conn.send_json({"token_ids": ids, "count": len(ids),
                              "rendered": rendered})

    async def models(self, conn: _Conn, raw: bytes) -> None:
        await conn.send_json({"object": "list", "data": [{
            "id": self.engine.model_name, "object": "model",
            "owned_by": "llm-d-inference-scheduler-tpu",
        }]})

    async def metrics(self, conn: _Conn, raw: bytes) -> None:
        body = self.engine.telemetry.render()
        if self._chaos_stall_drain is not None:
            # Phantom in-flight work in the exposition only: a drain never
            # sees the pod empty (the engine itself is idle).
            phantom = max(1.0, self._chaos_stall_drain.arg or 1.0)
            lines = []
            for line in body.decode().splitlines():
                if line.startswith("jetstream:num_requests_running "):
                    val = float(line.rsplit(" ", 1)[1])
                    line = f"jetstream:num_requests_running {val + phantom}"
                lines.append(line)
            body = ("\n".join(lines) + "\n").encode()
        await conn.send(200, body, METRICS_CONTENT_TYPE)

    async def health(self, conn: _Conn, raw: bytes) -> None:
        warming = self.engine.warming or time.monotonic() < self._ready_at_mono
        status = ("failed" if self.engine.failure is not None
                  else "degraded" if getattr(self.engine, "dist_degraded", False)
                  else "draining" if self.draining
                  else "warming" if warming else "ok")
        await conn.send_json({"status": status,
                              "engine_id": self.engine.engine_id,
                              "model": self.engine.model_name,
                              "role": self.cfg.role},
                             status=200 if status == "ok" else 503)

    async def traces(self, conn: _Conn, raw: bytes) -> None:
        """The engine's span ring; the gateway's /debug/traces?merge=1
        merges it with its own by span_id."""
        await conn.send_json({"service": "engine",
                              "engine_id": self.engine.engine_id,
                              "spans": tracer.snapshot()})

    async def kv_debug(self, conn: _Conn, raw: bytes) -> None:
        """The engine half of the router's /debug/kv: each prefill
        admission's engine-confirmed prefix hit, newest first (``?n=``,
        default 64), and the running admitted/hit token totals."""
        try:
            n = max(1, int(conn.query.get("n", "64")))
        except ValueError:
            n = 64
        hits = self.engine.kv_hits
        ring = list(hits.ring)
        totals = dict(hits.totals)
        if totals.get("prefill_tokens"):
            totals["actual_hit_ratio"] = round(
                totals.get("prefix_hit_tokens", 0) / totals["prefill_tokens"], 4)
        await conn.send_json({
            "engine_id": self.engine.engine_id,
            "block_size": self.engine.mcfg.kv_block_size,
            "count": len(ring),
            "totals": totals,
            "recent": ring[-n:][::-1],
        })

    # ---- KV events ------------------------------------------------------

    # The router's subscriber reads with a 5 s timeout: a comment line every
    # second keeps an idle stream alive.
    KV_EVENTS_PING_S = 1.0

    async def kv_events_stream(self, conn: _Conn, raw: bytes) -> None:
        """SSE stream of the engine's KV events; each queued burst goes out
        as one chunk of ``data:`` frames. The subscriber's queue leaves the
        hub when the client goes or the server stops."""
        pub = self.engine.kv_events
        if pub is None or pub.hub is None:
            raise HTTPError(501, "kv events disabled on this engine")
        q = pub.hub.subscribe()
        try:
            await conn.start_stream()
            while True:
                try:
                    doc = await asyncio.wait_for(q.get(), timeout=self.KV_EVENTS_PING_S)
                except asyncio.TimeoutError:
                    await conn.write_chunk(b": ping\n\n")
                    continue
                frames = [_sse(doc)]
                while not q.empty():
                    frames.append(_sse(q.get_nowait()))
                await conn.write_chunk(b"".join(frames))
        finally:
            pub.hub.unsubscribe(q)

    # ---- KV handoff (P/D disaggregation) --------------------------------

    # Long-poll bound of the /kv chunk surface: a decode peer waits for
    # chunk N at most this long per request, then gets a 202 and polls again.
    KV_CHUNK_WAIT_CAP_MS = 5000.0

    @staticmethod
    def _kv_chunk_headers(rec: dict) -> dict[str, str]:
        """Staging progress of the chunk-streamed protocol. A serial export
        carries no chunk fields: it reads complete with zero chunks, which
        steers a chunked puller to the full GET."""
        h = {"x-kv-chunks-staged": str(int(rec.get("chunks_staged", 0))),
             "x-kv-blocks-staged": str(int(rec.get("blocks_staged",
                                                   rec.get("num_blocks") or 0))),
             "x-kv-complete": "1" if rec.get("complete", True) else "0"}
        if rec.get("seq_len") is not None:
            h["x-kv-seq-len"] = str(rec["seq_len"])
        if rec.get("first_token") is not None:
            h["x-kv-first-token"] = str(rec["first_token"])
        return h

    async def kv_fetch(self, conn: _Conn, raw: bytes) -> None:
        """An export's KV: K then V, each [L, n_blocks, block, Hkv, Dh] in the
        pages' dtype, with geometry headers. ``?chunk=N`` serves staged chunk
        N of a chunk-streamed export (204 once complete and N is past the
        last); ``?ack=1`` answers 200 as soon as any chunk is staged or the
        export completed. Each waits up to ``wait_ms`` (capped), then 202."""
        rid = urllib.parse.unquote(conn.path[len("/kv/"):])
        q = conn.query
        try:
            chunk = int(q["chunk"]) if "chunk" in q else None
            wait_ms = min(float(q.get("wait_ms") or 0), self.KV_CHUNK_WAIT_CAP_MS)
        except ValueError:
            raise HTTPError(400, "chunk and wait_ms must be numbers")
        ack = q.get("ack") == "1"
        deadline = time.monotonic() + wait_ms / 1e3
        while True:
            rec = self.engine.get_kv_export(rid)
            ready = False
            if rec is not None:
                staged = int(rec.get("chunks_staged", 0))
                complete = bool(rec.get("complete", True))
                if ack:
                    ready = staged > 0 or complete
                elif chunk is not None:
                    ready = chunk < staged or complete
                else:
                    ready = complete
            if ready or time.monotonic() >= deadline:
                break
            await asyncio.sleep(0.002)
        if rec is None:
            raise HTTPError(404, f"no kv export for {rid}")
        headers = self._kv_chunk_headers(rec)
        octets = "application/octet-stream"
        if not ready:  # the wait expired mid-stream: the caller polls again
            await conn.send(202, b"", octets, headers)
        elif ack:
            await conn.send(200, b"", octets, headers)
        elif chunk is not None:
            if chunk >= int(rec.get("chunks_staged", 0)):
                await conn.send(204, b"", octets, headers)
                return
            headers.update({"x-kv-chunk": str(chunk),
                            "x-kv-chunk-blocks": str(int(rec["chunk_blocks"][chunk]))})
            if "chunk_data" not in rec:  # a sim prices the pull: no bytes
                await conn.send(200, b"", octets, headers)
                return
            k, v = rec["chunk_data"][chunk]
            headers.update({"x-kv-chunk-shape": json.dumps(list(k.shape)),
                            "x-kv-dtype": kv_wire.dtype_name(k.dtype)})
            await conn.send(200, (kv_wire.tensor_bytes(k), kv_wire.tensor_bytes(v)),
                            octets, headers)
        elif "tuid" in rec and "k" not in rec:
            raise HTTPError(404, "a multi-process engine serves its KV over "
                                 "its shard wires only")
        elif "k" not in rec:
            raise HTTPError(501, "sim engine holds no real KV")
        else:
            k, v = rec["k"], rec["v"]
            await conn.send(200, (kv_wire.tensor_bytes(k), kv_wire.tensor_bytes(v)),
                            octets, {
                                "x-kv-seq-len": str(rec["seq_len"]),
                                "x-kv-num-blocks": str(k.shape[1]),
                                "x-kv-real-blocks": str(rec.get("num_blocks", k.shape[1])),
                                "x-kv-dtype": kv_wire.dtype_name(k.dtype),
                                "x-kv-shape": json.dumps(list(k.shape)),
                                "x-kv-first-token": str(rec.get("first_token")),
                            })

    async def kv_release(self, conn: _Conn, raw: bytes) -> None:
        """Drop an export once pulled (``?consumed=device`` after a device
        wire pull, as the JAX server's)."""
        rid = urllib.parse.unquote(conn.path[len("/kv/"):])
        self.engine.release_kv_export(rid, consumed=conn.query.get("consumed") or "host")
        await conn.send_json({"released": rid})


async def run_server(cfg: EngineConfig, drain_timeout_s: float = 30.0):
    """Serve until SIGTERM/SIGINT, then drain: readiness flips 503,
    in-flight requests finish (bounded by ``drain_timeout_s``), then stop.
    An engine that stopped on its own (a failed warm-up) stops the server
    with the engine's error."""
    import signal

    server = EngineServer(cfg)
    await server.start()
    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop_ev.set)
        except (NotImplementedError, RuntimeError):
            pass
    try:
        while not stop_ev.is_set():
            if server.engine.failure is not None:
                raise RuntimeError("the engine stopped: its warm-up failed") \
                    from server.engine.failure
            try:
                await asyncio.wait_for(stop_ev.wait(), timeout=0.5)
            except asyncio.TimeoutError:
                pass
        server.draining = True
        deadline = loop.time() + drain_timeout_s
        while loop.time() < deadline and not server.engine.idle():
            await asyncio.sleep(0.25)
    except asyncio.CancelledError:
        pass
    finally:
        await server.stop()


# --platform as a torch device; "tpu" (the JAX package's) is refused.
_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def parse_config(argv: list[str] | None = None) -> tuple[EngineConfig, float]:
    """The engine config and drain timeout of a command line."""
    import argparse

    p = argparse.ArgumentParser(description="PyTorch engine server (OpenAI surface)")
    p.add_argument("--model", default="tiny",
                   help="registry name, or a directory the port's converter "
                        "wrote (model_config.json + model.safetensors)")
    p.add_argument("--backend", default="torch",
                   help="the engine: torch (the default) or sim (the CPU "
                        "simulator, which runs no model)")
    p.add_argument("--platform", default=None,
                   help="cpu runs the engine on the CPU (as --device cpu), "
                        "gpu or cuda on the card; a sim runs nothing on any "
                        "device with either")
    p.add_argument("--checkpoint", default="",
                   help="converted directory whose weights to load for --model")
    p.add_argument("--role", default="both",
                   choices=("both", "prefill", "decode", "encode"),
                   help="P/D role reported on /health")
    p.add_argument("--warmup", action="store_true",
                   help="build the kernels and run each path once before "
                        "/health reports ok")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--port", type=int, default=8200)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--decode-chunk", type=int, default=8,
                   help="decode steps fused per device dispatch")
    p.add_argument("--prefill-batch", type=int, default=1,
                   help="same-bucket prompts fused per prefill dispatch")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="incremental prefill window in tokens (0 = whole prompt)")
    p.add_argument("--kv-events-port", type=int, default=-1,
                   help="KV event stream: ZMQ PUB port (needs pyzmq; SSE on "
                        "/kv_events either way); -1 = --port + 1000, 0 = off")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain ops on the CPU")
    p.add_argument("--tp-size", type=int, default=1,
                   help="tensor-parallel degree: shard params + KV pages over "
                        "this many ranks")
    p.add_argument("--ep-size", type=int, default=1,
                   help="expert-parallel degree for MoE models (composes "
                        "with --tp-size)")
    p.add_argument("--pp-size", type=int, default=1,
                   help="pipeline-parallel stages (stage-ring serving; "
                        "composes with --tp-size/--ep-size)")
    p.add_argument("--devices", default="",
                   help="the device of each pp*tp*ep rank, comma-separated "
                        "in rank order (may repeat one device); default: the "
                        "first pp*tp*ep CUDA devices, or the CPU with "
                        "--device cpu")
    p.add_argument("--dtype", default=None,
                   help="parameter/KV dtype (default: the model config's)")
    p.add_argument("--drain-timeout", type=float, default=30.0)
    p.add_argument("--secure-serving", action="store_true",
                   help="serve over TLS (self-signed, which needs the "
                        "'cryptography' package, unless --cert-path names "
                        "tls.crt/tls.key)")
    p.add_argument("--cert-path", default="",
                   help="directory holding tls.crt + tls.key")
    p.add_argument("--enable-cert-reload", action="store_true",
                   help="re-read --cert-path when it changes (cert-manager "
                        "rotation)")
    p.add_argument("--chaos", default="",
                   help="deterministic fault injection on the generate "
                        "routes: comma-separated kind:pct[:arg] with kind in "
                        "reset|http503|delay|stall (arg = ms) or the "
                        "lifecycle kinds spawn_fail|slow_start|stall_drain; "
                        "also via the ENGINE_CHAOS env var; empty disables")
    p.add_argument("--chaos-seed", type=int, default=0,
                   help="seed folded into the fault-decision hash")
    p.add_argument("--client-verify", action="store_true",
                   help="verify TLS on the engine's outbound legs (ec/kv "
                        "pulls) with the system trust store instead of the "
                        "pod-local skip-verify default")
    p.add_argument("--client-ca-cert", default="",
                   help="CA bundle for the outbound legs (implies "
                        "verification against this bundle)")
    p.add_argument("--dist-coordinator", default="",
                   help="host:port of the engine group's rendezvous store "
                        "(process 0 hosts it): enables multi-process serving "
                        "(engine/multihost.py), one engine over every "
                        "process's ranks")
    p.add_argument("--dist-num-processes", type=int, default=1)
    p.add_argument("--dist-process-id", type=int, default=0)
    p.add_argument("--dist-instr-port", type=int, default=8790)
    p.add_argument("--dist-instr-host", default="",
                   help="instruction-channel address: leader bind / follower "
                        "dial; defaults to --host")
    args = p.parse_args(argv)
    if args.backend not in BACKENDS:
        p.error(f"--backend {args.backend}: the PyTorch port has "
                f"{' and '.join(BACKENDS)} ('tpu' is the JAX package's engine)")
    device = args.device
    if args.platform is not None:
        if args.platform not in _PLATFORMS:
            p.error(f"--platform {args.platform}: the PyTorch port runs on "
                    f"{', '.join(_PLATFORMS)}")
        device = _PLATFORMS[args.platform]
    if args.pp_size > 1 and args.backend == "torch":
        from ..models.configs import get_config
        from ..parallel.pp_serve import validate_pp

        try:
            validate_pp(get_config(args.model), args.pp_size, args.tp_size,
                        args.ep_size)
        except ValueError as e:
            p.error(str(e))
    cfg = EngineConfig(model=args.model, served_model_name=args.served_model_name,
                       backend=args.backend,
                       checkpoint_path=args.checkpoint, port=args.port,
                       host=args.host, max_batch=args.max_batch,
                       max_model_len=args.max_model_len,
                       decode_chunk=args.decode_chunk,
                       prefill_batch=args.prefill_batch,
                       prefill_chunk=args.prefill_chunk,
                       kv_events_port=args.kv_events_port, seed=args.seed,
                       role=args.role, warmup=args.warmup,
                       device=device, dtype=args.dtype,
                       tp_size=args.tp_size, ep_size=args.ep_size,
                       pp_size=args.pp_size,
                       devices=args.devices,
                       secure_serving=args.secure_serving,
                       cert_path=args.cert_path,
                       enable_cert_reload=args.enable_cert_reload,
                       chaos=args.chaos, chaos_seed=args.chaos_seed,
                       client_insecure_skip_verify=not (
                           args.client_verify or args.client_ca_cert),
                       client_ca_cert_path=args.client_ca_cert,
                       dist_coordinator=args.dist_coordinator,
                       dist_num_processes=args.dist_num_processes,
                       dist_process_id=args.dist_process_id,
                       dist_instr_port=args.dist_instr_port,
                       dist_instr_host=args.dist_instr_host)
    return cfg, args.drain_timeout


def main(argv: list[str] | None = None):
    cfg, drain_timeout_s = parse_config(argv)
    logging.basicConfig(level=logging.INFO)
    if cfg.dist and cfg.dist_process_id > 0:
        # A follower: no HTTP surface. Build the engine (its ranks' weights,
        # the group, the instruction channel) and replay the leader's device
        # ops until it stops; LeaderLost or a failed op exits nonzero.
        from .core import TorchEngine
        from .multihost import run_follower

        engine = TorchEngine(cfg)
        try:
            run_follower(engine)
        finally:
            engine.close()
        return
    asyncio.run(run_server(cfg, drain_timeout_s=drain_timeout_s))


if __name__ == "__main__":
    main()
