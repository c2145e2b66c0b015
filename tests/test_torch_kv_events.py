"""PyTorch port, KV-cache events: the port engine's stored/removed stream
against the JAX engine's, its SSE and ZMQ legs, and the late-joiner snapshot.

Both engines serve TINY in f32 on the CPU with the same weights (JAX
``init_params`` carried over by ``params_from_numpy``). Each engine's
publisher is tapped, so every event it publishes (the 1 s snapshot
included) is recorded; the sets of ``stored`` and of ``removed`` hashes must
be equal between the engines for the same requests:

- prefix caching off (``removed`` when a slot frees its blocks);
- prefix caching on with a page pool too small to keep the parked blocks
  (``removed`` at LRU eviction);
- a serial P/D import from a port exporter into a port and a JAX decode
  engine.
"""

import asyncio
import dataclasses
import http.client
import json
import logging
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import zmq

from _net import free_port
from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine import EngineRequest as JaxRequest
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu.engine.kv_events import (
    KvEventPublisher as JaxKvEventPublisher)
from llm_d_inference_scheduler_tpu.engine.server import EngineServer as JaxEngineServer
from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu_torch.engine import kv_events
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy
from llm_d_inference_scheduler_tpu_torch.utils.hashing import chain_block_hashes

BLOCK = 16


def _prompt(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [1] + [int(t) for t in rng.integers(3, 450, size=n - 1)]


def _wait_for(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _tap(engine) -> list[tuple[str, list[int]]]:
    """Record every event the engine's publisher publishes."""
    events: list[tuple[str, list[int]]] = []
    pub = engine.kv_events
    publish = pub.publish

    def tap(event, hashes):
        if hashes:
            events.append((event, list(hashes)))
        publish(event, hashes)

    pub.publish = tap
    return events


def _hash_sets(events) -> tuple[set[int], set[int]]:
    stored = {h for e, hs in events if e == "stored" for h in hs}
    removed = {h for e, hs in events if e == "removed" for h in hs}
    return stored, removed


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    model_dir = tmp_path_factory.mktemp("tiny_f32")
    fields = dataclasses.asdict(jax_configs.TINY) | {"dtype": "float32"}
    (model_dir / "model_config.json").write_text(json.dumps(fields))
    jparams = jax_llama.init_params(jax_configs.get_config(str(model_dir)),
                                    jax.random.key(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return str(model_dir), jparams, tparams


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield loop
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)


# ---- the same requests through both engines --------------------------------

PROMPTS = {name: _prompt(i, n) for i, (name, n) in enumerate(
    [("a", 49), ("b", 41), ("c", 21), ("d", 57), ("e", 49)])}


async def _generate(engine, make_req, rid, prompt, max_tokens=4):
    out = engine.submit(make_req(request_id=rid, prompt_token_ids=list(prompt),
                                 max_tokens=max_tokens, temperature=0.0,
                                 ignore_eos=True))
    while True:
        ev = await asyncio.wait_for(out.get(), timeout=120)
        if ev.finish_reason is not None:
            return


async def _scenario(engine, make_req):
    # Two concurrent, then one after another: with a small pool the later
    # ones evict the parked blocks of the earlier; "a" again re-uses or
    # recomputes its blocks.
    await asyncio.gather(_generate(engine, make_req, "a", PROMPTS["a"]),
                         _generate(engine, make_req, "c", PROMPTS["c"]))
    for name in ("b", "d", "e", "a"):
        await _generate(engine, make_req, f"{name}2", PROMPTS[name])


def _run(engine, make_req):
    events = _tap(engine)

    async def body():
        await engine.start()
        try:
            await _scenario(engine, make_req)
        finally:
            await engine.stop()

    asyncio.run(body())
    return events


@pytest.mark.parametrize("caching,blocks", [(False, 0), (True, 9)],
                         ids=["caching-off", "caching-on-evicting"])
def test_stored_and_removed_sets_match_jax_engine(f32, caching, blocks):
    model, jparams, tparams = f32
    common = dict(model=model, max_batch=2, max_model_len=128, decode_chunk=4,
                  enable_prefix_caching=caching, hbm_kv_blocks=blocks)
    jax_eng = TpuEngine(JaxEngineConfig(**common, kv_events_port=free_port(),
                                        kv_transfer="host"), params=jparams)
    port_eng = TorchEngine(EngineConfig(**common, device="cpu"), params=tparams)
    jax_events = _run(jax_eng, JaxRequest)
    port_events = _run(port_eng, EngineRequest)

    stored, removed = _hash_sets(port_events)
    assert (stored, removed) == _hash_sets(jax_events)
    every = {h for p in PROMPTS.values()
             for h in chain_block_hashes(model, p, "", BLOCK)}
    assert stored == every
    if caching:
        # The pool (8 usable blocks) cannot park all 12 prompt blocks.
        assert removed and removed < stored
    else:
        assert removed == stored  # every slot's blocks freed at its finish


# ---- P/D import ---------------------------------------------------------------


def _post(port, path, body, timeout=60):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _start(loop, server):
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(120)
    return server


def _stop(loop, server):
    asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)


def test_pd_import_events_match_jax_engine(loop, f32):
    """A serial handoff of the same prompt from a port exporter into a port
    and a JAX decode engine (prefix caching off on both): each publishes
    the imported blocks as stored, then removed when the slot finishes."""
    model, jparams, tparams = f32
    common = dict(model=model, max_batch=2, max_model_len=256, decode_chunk=4,
                  enable_prefix_caching=False)
    port_cfg = EngineConfig(**common, device="cpu", port=0)
    exporter = EngineServer(port_cfg, engine=TorchEngine(port_cfg, params=tparams))
    port_d = EngineServer(port_cfg, engine=TorchEngine(port_cfg, params=tparams))
    jax_cfg = JaxEngineConfig(**common, port=free_port(),
                              kv_events_port=free_port(), kv_transfer="host")
    jax_d = JaxEngineServer(jax_cfg, engine=TpuEngine(jax_cfg, params=jparams))
    taps = {"port": _tap(port_d.engine), "jax": _tap(jax_d.engine)}
    servers = [_start(loop, s) for s in (exporter, port_d, jax_d)]
    prompt = _prompt(42, 70)
    try:
        for name, importer in (("port", port_d), ("jax", jax_d)):
            r1 = _post(exporter.port, "/v1/completions", {
                "prompt": prompt, "max_tokens": 1, "temperature": 0,
                "kv_transfer_params": {"do_remote_decode": True}})
            ktp = r1["kv_transfer_params"]
            port = getattr(importer, "port", None) or importer.cfg.port
            r2 = _post(port, "/v1/completions", {
                "prompt": prompt, "max_tokens": 4, "temperature": 0,
                "ignore_eos": True, "kv_transfer_params": ktp})
            assert r2["choices"][0]["finish_reason"] == "length"
        # The decode legs imported (no local prefill on either engine).
        assert port_d.engine.telemetry.prompt_tokens.value == 0
    finally:
        for s in servers:
            _stop(loop, s)
    expect = set(chain_block_hashes(model, prompt, "", BLOCK))
    assert len(expect) == 4
    assert _hash_sets(taps["port"]) == _hash_sets(taps["jax"]) == (expect, expect)


# ---- SSE: late joiner, stop with a subscriber, events off --------------------


class _SseReader:
    """A raw http.client subscriber of /kv_events on a thread of its own,
    recording (receipt time, event document) per data frame."""

    def __init__(self, port: int):
        self.events: list[tuple[float, dict]] = []
        self.pings = 0
        self.status = None
        self.done = threading.Event()
        self._conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        try:
            self._conn.request("GET", "/kv_events")
            r = self._conn.getresponse()
            self.status = r.status
            while True:
                line = r.fp.readline()
                if not line:
                    return  # the server closed the stream
                if line.startswith(b"data: "):
                    self.events.append((time.monotonic(), json.loads(line[6:])))
                elif line.startswith(b": ping"):
                    self.pings += 1
        except OSError:
            pass
        finally:
            self.done.set()

    def stored(self) -> set[int]:
        return {h for _, e in self.events if e["event"] == "stored"
                for h in e["hashes"]}

    def close(self):
        if self._conn.sock is not None:  # ends the reader's blocking read
            self._conn.sock.shutdown(socket.SHUT_RDWR)
        self._thread.join(10)
        assert not self._thread.is_alive()
        self._conn.close()


@pytest.fixture
def tiny_server(loop):
    srv = _start(loop, EngineServer(EngineConfig(
        model="tiny", device="cpu", dtype="float32", port=0, max_batch=2,
        max_model_len=128, decode_chunk=4)))
    yield srv
    if srv._server is not None and srv._server.is_serving():
        _stop(loop, srv)


def test_late_subscriber_learns_the_cache_from_the_snapshot(tiny_server):
    srv = tiny_server
    prompt = _prompt(7, 40)
    _post(srv.port, "/v1/completions", {"prompt": prompt, "max_tokens": 2,
                                        "temperature": 0})
    _wait_for(srv.engine.idle, 30, "the engine to go idle")
    cached = set(srv.engine.allocator.cached_hashes())
    assert cached == set(chain_block_hashes("tiny", prompt, "", BLOCK))
    reader = _SseReader(srv.port)
    try:
        _wait_for(lambda: cached <= reader.stored(), 2.0,
                  "the snapshot to reach a subscriber that joined late")
        assert reader.status == 200
        assert all(e["engine_id"] == srv.engine.engine_id for _, e in reader.events)
    finally:
        reader.close()


def test_stop_with_an_open_subscriber(loop, tiny_server):
    srv = tiny_server
    reader = _SseReader(srv.port)
    hub = srv.engine.kv_events.hub
    _wait_for(lambda: hub.subscribers == 1, 10, "the subscriber")
    _wait_for(lambda: reader.pings >= 1, 5, "a heartbeat on the idle stream")
    t0 = time.monotonic()
    _stop(loop, srv)
    assert time.monotonic() - t0 < 1.0
    assert hub.subscribers == 0
    assert reader.done.wait(5), "the stream stayed open after stop()"
    reader.close()


def test_events_off_answers_501(loop):
    srv = _start(loop, EngineServer(EngineConfig(
        model="tiny", device="cpu", port=0, max_model_len=64, kv_events_port=0)))
    try:
        assert srv.engine.kv_events is None
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/kv_events", timeout=10)
        assert e.value.code == 501
    finally:
        _stop(loop, srv)


def test_event_hub_counts_and_drops_for_a_full_queue():
    async def body():
        hub = kv_events.EventHub(asyncio.get_running_loop())
        fast, slow = hub.subscribe(), hub.subscribe()
        for i in range(kv_events.QUEUE_MAX + 5):
            hub.push({"i": i})
            if i % 1000 == 999:
                await asyncio.sleep(0)  # the loop delivers the pushes so far
                while not fast.empty():
                    fast.get_nowait()
        await asyncio.sleep(0)
        assert hub.pushed == kv_events.QUEUE_MAX + 5
        assert slow.qsize() == kv_events.QUEUE_MAX  # the rest were dropped
        assert hub.delivered == kv_events.QUEUE_MAX + 5 + kv_events.QUEUE_MAX
        hub.unsubscribe(slow)
        hub.unsubscribe(fast)
        assert hub.subscribers == 0

    asyncio.run(body())


# ---- ZMQ leg -------------------------------------------------------------------


def _recv(sock, deadline_s: float) -> list[bytes]:
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        try:
            return sock.recv_multipart()
        except zmq.Again:
            continue
    raise AssertionError("no ZMQ message")


def test_zmq_leg_is_the_jax_wire(loop):
    """An explicit kv_events_port publishes the JAX publisher's multipart
    frames: the same topic and, for the same document, the same bytes."""
    zport, jport = free_port(), free_port()
    srv = _start(loop, EngineServer(EngineConfig(
        model="tiny", device="cpu", port=0, max_model_len=128,
        kv_events_port=zport)))
    ctx = zmq.Context.instance()
    subs = []
    for p in (zport, jport):
        sock = ctx.socket(zmq.SUB)
        sock.setsockopt(zmq.SUBSCRIBE, b"kv-events")
        sock.setsockopt(zmq.RCVTIMEO, 200)
        sock.connect(f"tcp://127.0.0.1:{p}")
        subs.append(sock)
    jax_pub = JaxKvEventPublisher(jport, srv.engine.engine_id)
    try:
        prompt = _prompt(9, 33)
        _post(srv.port, "/v1/completions", {"prompt": prompt, "max_tokens": 2,
                                            "temperature": 0})
        # The 1 s snapshot re-sends the cache, so a slow-joining SUB still
        # gets a frame.
        topic, payload = _recv(subs[0], 10)
        doc = json.loads(payload)
        assert topic == b"kv-events" and doc["event"] == "stored"
        assert set(chain_block_hashes("tiny", prompt, "", BLOCK)) <= set(doc["hashes"])
        jax_pub.bind_now()
        deadline = time.monotonic() + 10
        while True:  # PUB drops frames until the SUB's handshake is done
            jax_pub.publish(doc["event"], doc["hashes"])
            try:
                assert subs[1].recv_multipart() == [topic, payload]
                break
            except zmq.Again:
                assert time.monotonic() < deadline
    finally:
        for sock in subs:
            sock.close(linger=0)
        jax_pub.close()
        _stop(loop, srv)


def test_without_pyzmq(loop, monkeypatch, caplog):
    """No pyzmq: an explicit event port refuses to start; the default port
    logs that the ZMQ leg is off, once, and SSE still serves the events."""
    monkeypatch.setitem(sys.modules, "zmq", None)  # import zmq -> ImportError
    assert not kv_events.zmq_available()
    eng = TorchEngine(EngineConfig(model="tiny", device="cpu", max_model_len=64,
                                   kv_events_port=free_port()))
    with pytest.raises(RuntimeError, match="pyzmq"):
        asyncio.run(eng.start())
    assert eng._thread is None
    with caplog.at_level(logging.WARNING, logger="engine.torch"):
        srv = _start(loop, EngineServer(EngineConfig(
            model="tiny", device="cpu", port=0, max_model_len=64)))
    try:
        said = [r for r in caplog.records if "pyzmq" in r.getMessage()]
        assert len(said) == 1 and said[0].levelno == logging.WARNING
        assert srv.engine.kv_events.zmq_port == 0
        reader = _SseReader(srv.port)
        prompt = _prompt(11, 20)
        _post(srv.port, "/v1/completions", {"prompt": prompt, "max_tokens": 2,
                                            "temperature": 0})
        want = set(chain_block_hashes("tiny", prompt, "", BLOCK))
        _wait_for(lambda: want <= reader.stored(), 5, "events over SSE")
        reader.close()
    finally:
        _stop(loop, srv)
