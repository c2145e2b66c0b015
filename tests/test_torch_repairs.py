"""PyTorch port: the role flag, directory models, the shared-storage probe
and warm-up, held against the JAX package on the CPU.

- ``--role`` reaches ``/health`` as on the JAX server; the manifests'
  engine flags (``--role=decode --warmup``) start a port engine;
- a checkpoint directory without ``params`` is refused, not served with
  random weights;
- ``cache_hit_threshold``: a cold probe ends with ``cache_threshold``
  before any block is allocated, a warm one answers tokens, with the JAX
  engine's verdicts on the same input; the router's shared-storage
  connector in front of port engines (port analogue of
  ``tests/test_e2e_disagg.py::test_shared_storage_connector``) gives the
  JAX pair's tokens;
- ``--warmup`` holds ``/health`` at 503 ``warming`` until warm and changes
  no greedy token; a failed warm-up stops the engine and the server;
- ``x-request-timeout`` on the generate routes, against the JAX server on
  the same request: a budget <= 0 answers 504 with ``x-removal-reason:
  deadline-exceeded`` before admission, an expired non-streaming budget
  answers 504 and aborts the engine request (its blocks come back), a
  stream's watchdog closes the connection before ``[DONE]``;
- ``EngineConfig.engine_id``: a port engine and a port sim built with one
  report it on ``/health`` and in their KV-event documents, as the JAX
  sim does on the same config.
"""

import asyncio
import dataclasses
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from _net import free_port
from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine import EngineRequest as JaxRequest
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu.engine.server import EngineServer as JaxEngineServer
from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu.router.sidecar import Sidecar, SidecarConfig
from llm_d_inference_scheduler_tpu_torch.engine import server as server_mod
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy

PROMPT = [1] + list(range(50, 98))          # 49 tokens, 3 full blocks
HALF = PROMPT[:17] + list(range(200, 232))  # shares PROMPT's first block only


def _request(port, path, body=None, headers=None, timeout=90):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"content-type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw.startswith(b"{") else raw


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield loop
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)


def _run(loop, coro, timeout=120):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


def _port_of(srv):
    return srv.port if isinstance(srv, EngineServer) else srv.cfg.port


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    """TINY in f32 (a model_config.json directory) and its JAX weights in
    both stacks."""
    d = tmp_path_factory.mktemp("tiny_f32")
    fields = dataclasses.asdict(jax_configs.TINY) | {"dtype": "float32"}
    (d / "model_config.json").write_text(json.dumps(fields))
    jparams = jax_llama.init_params(jax_configs.get_config(str(d)), jax.random.key(4))
    return str(d), jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


# ---- role ------------------------------------------------------------------------


def test_role_flag_reaches_health_as_on_the_jax_server(loop):
    cfg, _ = server_mod.parse_config(["--model=tiny", "--device=cpu", "--port=0",
                                      "--kv-events-port=0", "--role=decode"])
    port_srv = EngineServer(cfg)
    jax_srv = JaxEngineServer(JaxEngineConfig(backend="sim", model="tiny",
                                              port=free_port(), role="decode"))
    for s in (port_srv, jax_srv):
        _run(loop, s.start())
    try:
        docs = [_request(_port_of(s), "/health") for s in (port_srv, jax_srv)]
        assert docs[0][0] == docs[1][0] == 200
        assert docs[0][1]["role"] == docs[1][1]["role"] == "decode"
        assert server_mod.parse_config(["--device=cpu"])[0].role == "both"
    finally:
        for s in (port_srv, jax_srv):
            _run(loop, s.stop(), 60)
    with pytest.raises(SystemExit):
        server_mod.parse_config(["--role=bogus"])
    # The port has the torch engine and the simulator; the JAX package's
    # "tpu" engine is refused.
    assert server_mod.parse_config(["--backend=sim"])[0].backend == "sim"
    with pytest.raises(SystemExit):
        server_mod.parse_config(["--backend=tpu"])


# ---- directory models ------------------------------------------------------------


def test_directory_model_needs_params(f32):
    model, _, tparams = f32
    with pytest.raises(ValueError, match="loads no checkpoint"):
        TorchEngine(EngineConfig(model=model, device="cpu"))
    with pytest.raises(ValueError, match="loads no checkpoint"):
        EngineServer(EngineConfig(model=model, device="cpu"))
    eng = TorchEngine(EngineConfig(model=model, device="cpu"), params=tparams)
    assert eng.params is tparams
    TorchEngine(EngineConfig(model="tiny", device="cpu"))  # a registry name draws


# ---- the shared-storage probe ------------------------------------------------------


def test_cache_threshold_probe_matches_jax(f32):
    """Cold probe, a partly warm probe (one of three blocks) and a warm one
    at threshold 0.5; a threshold of 0 always passes."""
    model, jparams, tparams = f32
    common = dict(model=model, max_batch=2, max_model_len=128, decode_chunk=4)

    async def run(engine, make_req):
        await engine.start()
        try:
            async def ask(rid, prompt, thr, max_tokens=1):
                free = engine.allocator.free_blocks
                q = engine.submit(make_req(request_id=rid, prompt_token_ids=prompt,
                                           max_tokens=max_tokens, temperature=0.0,
                                           ignore_eos=True, cache_hit_threshold=thr))
                toks = []
                while True:
                    ev = await asyncio.wait_for(q.get(), 120)
                    if ev.token_id is not None:
                        toks.append(ev.token_id)
                    if ev.finish_reason is not None:
                        return (ev.finish_reason.value, toks, ev.cached_tokens,
                                engine.allocator.free_blocks - free)

            out = [await ask("cold", PROMPT, 0.5),
                   await ask("zero", HALF, 0.0, 4)]  # caches HALF's blocks
            out.append(await ask("part", PROMPT, 0.5))
            out.append(await ask("fill", PROMPT, None, 4))
            out.append(await ask("warm", PROMPT, 0.5))
            return out
        finally:
            await engine.stop()

    ref = asyncio.run(run(TpuEngine(JaxEngineConfig(**common, kv_events_port=0,
                                                    kv_transfer="host"),
                                    params=jparams), JaxRequest))
    got = asyncio.run(run(TorchEngine(EngineConfig(**common, device="cpu", port=0),
                                      params=tparams), EngineRequest))
    assert got == ref
    reasons = [r[0] for r in got]
    assert reasons == ["cache_threshold", "length", "cache_threshold", "length", "length"]
    # No block moved for a refused probe; the partly warm one saw one block.
    assert got[0][1:] == ([], 0, 0) and got[2][1:] == ([], 16, 0)
    assert len(got[4][1]) == 1


def test_probe_surfaces_on_completions_responses_and_metrics(loop):
    srv = EngineServer(EngineConfig(model="tiny", device="cpu", port=0,
                                    kv_events_port=0, max_model_len=128))
    _run(loop, srv.start())
    try:
        body = {"prompt": PROMPT, "max_tokens": 1, "cache_hit_threshold": 0.5}
        status, doc = _request(srv.port, "/v1/completions", body)
        assert status == 200 and doc["choices"][0]["finish_reason"] == "cache_threshold"
        assert doc["usage"]["completion_tokens"] == 0
        status, doc = _request(srv.port, "/v1/responses", {
            "input": "a cold shared-storage probe " * 2,
            "max_output_tokens": 1, "cache_hit_threshold": 0.5})
        assert doc["status"] == "incomplete"
        assert doc["incomplete_details"] == {"reason": "cache_threshold"}
        status, doc = _request(srv.port, "/v1/completions", {
            "prompt": PROMPT, "cache_hit_threshold": "high"})
        assert status == 400
        text = srv.engine.telemetry.render().decode()
        assert 'finished_reason="cache_threshold"} 2' in text
        assert srv.engine.kv_hits.totals.get("prefill_tokens", 0) == 0
    finally:
        _run(loop, srv.stop(), 60)


def _prompt_tokens(srv) -> float:
    for line in srv.engine.telemetry.render().decode().splitlines():
        if line.startswith("jetstream:prompt_tokens_total "):
            return float(line.split()[-1])
    return 0.0


def test_shared_storage_connector_in_front_of_port_engines(loop, f32):
    """Decode-first probe: cold -> cache_threshold -> remote prefill ->
    retry, with the JAX pair's tokens; warm -> served locally."""
    model, jparams, tparams = f32
    common = dict(model=model, max_batch=4, max_model_len=256)
    pairs = {}
    for stack in ("port", "jax"):
        if stack == "port":
            mk = [EngineServer(c, engine=TorchEngine(c, params=tparams)) for c in (
                EngineConfig(**common, device="cpu", port=0, role=r)
                for r in ("decode", "prefill"))]
        else:
            mk = [JaxEngineServer(c, engine=TpuEngine(c, params=jparams)) for c in (
                JaxEngineConfig(**common, port=free_port(), role=r,
                                kv_events_port=0, kv_transfer="host")
                for r in ("decode", "prefill"))]
        for s in mk:
            _run(loop, s.start())
        dec, pre = mk
        sc = Sidecar(SidecarConfig(port=free_port(),
                                   decoder_url=f"http://127.0.0.1:{_port_of(dec)}",
                                   connector="shared-storage", cache_hit_threshold=0.5))
        _run(loop, sc.start())
        pairs[stack] = (dec, pre, sc)
    try:
        texts = {}
        for stack, (dec, pre, sc) in pairs.items():
            hdr = {"x-prefiller-host-port": f"127.0.0.1:{_port_of(pre)}"}
            body = {"prompt": PROMPT, "max_tokens": 4, "ignore_eos": True,
                    "temperature": 0}
            before = _prompt_tokens(pre)
            status, doc = _request(sc.cfg.port, "/v1/completions", body, hdr)
            assert status == 200
            texts[stack] = doc["choices"][0]["text"]
            assert _prompt_tokens(pre) > before  # the prefill leg ran remotely
            mid = _prompt_tokens(pre)
            status, doc = _request(sc.cfg.port, "/v1/completions", body, hdr)
            assert status == 200 and doc["choices"][0]["text"]
            assert _prompt_tokens(pre) == mid  # warm: served by the decode engine
        assert texts["port"] == texts["jax"] and texts["port"]
    finally:
        for dec, pre, sc in pairs.values():
            _run(loop, sc.stop(), 60)
            for s in (pre, dec):
                _run(loop, s.stop(), 60)


# ---- warm-up ------------------------------------------------------------------------


def _gate_warmup(engine):
    """Hold the engine's warm-up until the returned event is set; the list
    records each finished warm-up."""
    gate, done = threading.Event(), []
    warmup = engine._warmup

    def held():
        assert gate.wait(60)
        warmup()
        done.append(True)

    engine._warmup = held
    return gate, done


def test_warmup_holds_health_until_warm_and_keeps_tokens(loop):
    """The manifests' flags (less --tp-size and --checkpoint): 503 warming,
    a request queued meanwhile, then 200 ok with role decode; greedy tokens
    equal an engine without warm-up's."""
    cfg, _ = server_mod.parse_config(["--model=tiny", "--port=0", "--host=127.0.0.1",
                                      "--role=decode", "--warmup", "--device=cpu",
                                      "--prefill-chunk=32", "--kv-events-port=0",
                                      "--max-batch=4"])
    assert cfg.role == "decode" and cfg.warmup
    warm = EngineServer(cfg)
    gate, done = _gate_warmup(warm.engine)
    cold = EngineServer(dataclasses.replace(cfg, warmup=False))
    for s in (warm, cold):
        _run(loop, s.start())
    try:
        status, doc = _request(warm.port, "/health")
        assert (status, doc["status"], doc["role"]) == (503, "warming", "decode")
        assert _request(cold.port, "/health")[1]["status"] == "ok"
        body = {"prompt": PROMPT, "max_tokens": 6, "temperature": 0, "ignore_eos": True}
        pending = asyncio.run_coroutine_threadsafe(
            asyncio.to_thread(_request, warm.port, "/v1/completions", body), loop)
        time.sleep(0.2)
        assert not pending.done()  # nothing is admitted while warming
        gate.set()
        deadline = time.monotonic() + 30
        while _request(warm.port, "/health")[0] != 200:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert done and _request(warm.port, "/health")[1]["role"] == "decode"
        got = pending.result(60)[1]["choices"][0]["text"]
        assert got == _request(cold.port, "/v1/completions", body)[1]["choices"][0]["text"]
        # The trial runs leave no trace in the engine's counters.
        assert warm.engine.decode_steps == cold.engine.decode_steps
        assert (warm.engine.telemetry.prefill_step.count
                == cold.engine.telemetry.prefill_step.count)
    finally:
        for s in (warm, cold):
            _run(loop, s.stop(), 60)


def test_encode_warmup_builds_the_tower():
    eng = TorchEngine(EngineConfig(model="tiny", device="cpu", role="encode",
                                   warmup=True, kv_events_port=0))
    assert eng.warming
    asyncio.run(eng.start())
    try:
        deadline = time.monotonic() + 30
        while eng.warming:
            assert time.monotonic() < deadline and eng.failure is None
            time.sleep(0.01)
        assert eng._vision is not None
    finally:
        asyncio.run(eng.stop())


def test_failed_warmup_stops_engine_and_server(loop, monkeypatch):
    def broken(self):
        raise RuntimeError("kernel build failed: nvcc exit 1")

    monkeypatch.setattr(TorchEngine, "_warmup", broken)
    cfg = EngineConfig(model="tiny", device="cpu", port=0, kv_events_port=0,
                       warmup=True)
    srv = EngineServer(cfg)
    _run(loop, srv.start())
    try:
        deadline = time.monotonic() + 30
        while srv.engine.failure is None:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        status, doc = _request(srv.port, "/health")
        assert (status, doc["status"]) == (503, "failed")
        srv.engine._thread.join(10)
        assert not srv.engine._thread.is_alive()
    finally:
        _run(loop, srv.stop(), 60)
    with pytest.raises(RuntimeError, match="warm-up failed"):
        asyncio.run(asyncio.wait_for(server_mod.run_server(cfg), 30))


# ---- deadlines ----------------------------------------------------------------------

GEN_BODIES = {
    "/v1/completions": {"prompt": "a deadline drill"},
    "/v1/chat/completions": {"messages": [{"role": "user", "content": "a deadline drill"}]},
    "/v1/responses": {"input": "a deadline drill"},
}


def _raw(port, path, body, headers, timeout=60):
    """(status, lower-cased headers, body bytes) of one POST; for an SSE
    body read until the server closes, with ``IncompleteRead`` taken as
    the close (the watchdog's cut of a chunked body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body).encode(),
                     {"content-type": "application/json", **headers})
        r = conn.getresponse()
        try:
            data = r.read()
        except http.client.IncompleteRead as e:
            data = e.partial
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data
    finally:
        conn.close()


@pytest.fixture(scope="module")
def deadline_pair(loop):
    """A port server whose decode chunks are slowed to ~50 ms each and a
    JAX sim server at 20 ms a token: 200 tokens outlast every budget below
    on both."""
    port_srv = EngineServer(EngineConfig(model="tiny", device="cpu", port=0,
                                         kv_events_port=0, max_model_len=256))
    chunk = port_srv.engine._decode_chunk

    def slow(*a, **kw):
        time.sleep(0.05)
        return chunk(*a, **kw)

    port_srv.engine._decode_chunk = slow
    jax_srv = JaxEngineServer(JaxEngineConfig(backend="sim", model="tiny",
                                              port=free_port(),
                                              sim_decode_ms_per_token=20.0))
    for s in (port_srv, jax_srv):
        _run(loop, s.start())
    yield port_srv, jax_srv
    for s in (port_srv, jax_srv):
        _run(loop, s.stop(), 60)


def _blocks_back(engine, timeout=10.0):
    """Wait until no slot is live and every usable block is reusable."""
    deadline = time.monotonic() + timeout
    while True:
        free = getattr(engine.allocator, "reusable_blocks", engine.allocator.free_blocks)
        if free == engine.n_blocks - 1 and not any(engine.slots):
            return
        assert time.monotonic() < deadline, (free, engine.n_blocks)
        time.sleep(0.01)


def _aborts(engine) -> str:
    return next((line for line in engine.telemetry.render().decode().splitlines()
                 if 'finished_reason="abort"' in line and "_total" in line), "")


@pytest.mark.parametrize("path", sorted(GEN_BODIES))
def test_zero_budget_is_504_before_admission_as_on_the_jax_server(deadline_pair, path):
    port_srv, jax_srv = deadline_pair
    body = {**GEN_BODIES[path], "max_tokens": 4, "temperature": 0}
    prompts_before = _prompt_tokens(port_srv)
    for budget in ("0", "-1.5"):
        got = [_raw(_port_of(s), path, body, {"x-request-timeout": budget})
               for s in (port_srv, jax_srv)]
        for status, headers, data in got:
            assert status == 504, (path, budget, status, data)
            assert headers["x-removal-reason"] == "deadline-exceeded"
            assert json.loads(data) == {"error": "deadline exceeded"}
    assert _prompt_tokens(port_srv) == prompts_before  # nothing was admitted
    # A budget that does not parse is ignored, on both servers.
    for s in (port_srv, jax_srv):
        assert _raw(_port_of(s), path, body, {"x-request-timeout": "soon"})[0] == 200


def test_expired_budget_is_504_and_aborts_the_engine_request(deadline_pair):
    port_srv, jax_srv = deadline_pair
    body = {"prompt": "a long answer, please", "max_tokens": 200,
            "ignore_eos": True, "temperature": 0}
    aborts = _aborts(port_srv.engine)
    for s in (port_srv, jax_srv):
        t0 = time.monotonic()
        status, headers, data = _raw(_port_of(s), "/v1/completions", body,
                                     {"x-request-timeout": "0.3"})
        assert (status, headers["x-removal-reason"]) == (504, "deadline-exceeded")
        assert json.loads(data) == {"error": "deadline exceeded"}
        assert time.monotonic() - t0 < 1.0  # answered at the budget, not the end
    _blocks_back(port_srv.engine)
    assert _aborts(port_srv.engine) != aborts  # the engine counted the abort
    # A budget that suffices changes nothing.
    status, _, data = _raw(port_srv.port, "/v1/completions",
                           {**body, "max_tokens": 4}, {"x-request-timeout": "30"})
    assert status == 200 and json.loads(data)["usage"]["completion_tokens"] == 4


def test_stream_watchdog_closes_the_connection(deadline_pair):
    port_srv, jax_srv = deadline_pair
    body = {"prompt": "a long streamed answer", "max_tokens": 200,
            "ignore_eos": True, "temperature": 0, "stream": True}
    for s in (port_srv, jax_srv):
        t0 = time.monotonic()
        status, headers, data = _raw(_port_of(s), "/v1/completions", body,
                                     {"x-request-timeout": "0.4"})
        assert status == 200 and headers["content-type"].startswith("text/event-stream")
        assert b"data: " in data and b"[DONE]" not in data  # cut mid-stream
        assert time.monotonic() - t0 < 2.0
    _blocks_back(port_srv.engine)
    # The same stream with room to finish ends with [DONE].
    status, _, data = _raw(port_srv.port, "/v1/completions", {**body, "max_tokens": 4},
                           {"x-request-timeout": "30"})
    assert status == 200 and data.rstrip().endswith(b"data: [DONE]")


# ---- engine_id -------------------------------------------------------------------


def test_configured_engine_id_reaches_health_and_kv_events(loop):
    servers = {
        "port": EngineServer(EngineConfig(model="tiny", device="cpu", port=0,
                                          max_model_len=128, engine_id="pod-a")),
        "port-sim": EngineServer(EngineConfig(backend="sim", model="tiny", port=0,
                                              engine_id="pod-a")),
        "jax-sim": JaxEngineServer(JaxEngineConfig(backend="sim", model="tiny",
                                                   port=free_port(), engine_id="pod-a")),
    }
    docs: dict[str, list[dict]] = {name: [] for name in servers}
    for name, srv in servers.items():
        _run(loop, srv.start())
        hub = srv.engine.kv_events.hub
        push = hub.push
        hub.push = lambda doc, push=push, seen=docs[name]: (seen.append(doc), push(doc))
    try:
        for name, srv in servers.items():
            port = _port_of(srv)
            status, health = _request(port, "/health")
            assert status == 200 and health["engine_id"] == "pod-a", (name, health)
            status, _ = _request(port, "/v1/completions", {
                "prompt": PROMPT, "max_tokens": 2, "temperature": 0})
            assert status == 200, name
            deadline = time.monotonic() + 10
            while not any(d["event"] == "stored" for d in docs[name]):
                assert time.monotonic() < deadline, f"no stored event from {name}"
                time.sleep(0.01)
            assert {d["engine_id"] for d in docs[name]} == {"pod-a"}, name
        # Left empty, each engine still mints its own prefixed id.
        assert EngineConfig().engine_id == ""
    finally:
        for srv in servers.values():
            _run(loop, srv.stop(), 60)
