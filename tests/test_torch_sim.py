"""PyTorch port, the CPU simulator (``--backend sim``) and ``--platform``.

Port analogues of the JAX package's sim tests, with the port's sim server in
place of the JAX one and the same asserts: the OpenAI surface
(``tests/test_engine.py:92``), the sidecar's chunked decode and DP-rank
listeners over two sims (``tests/test_e2e_disagg.py:287``), the E/P/D
fan-out through the gateway and sidecar onto sim encode, prefill and decode
pods (``tests/test_e2e_epd.py:52``) and the prefix-hit accounting with
``/debug/kv`` (``tests/test_kvobs.py:207``). Then the two sims side by side
on the same requests: statuses, JSON fields, the ``x-`` header names and the
``/metrics`` names are equal (timings are not compared), including the P/D
legs, the priced serial and chunk-streamed pulls in both directions, the
501 of ``GET /kv`` and the E/P/D routes. In-process servers on free ports,
no subprocess.
"""

import asyncio
import json
import threading
import urllib.error
import urllib.request

import httpx
import numpy as np
import pytest

from _net import free_port
from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine.server import EngineServer as JaxEngineServer
from llm_d_inference_scheduler_tpu.router.gateway import build_gateway
from llm_d_inference_scheduler_tpu.router.sidecar import Sidecar, SidecarConfig
from llm_d_inference_scheduler_tpu_torch import ops
from llm_d_inference_scheduler_tpu_torch.engine import server as server_mod
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
from llm_d_inference_scheduler_tpu_torch.engine.sim import SimEngine
from llm_d_inference_scheduler_tpu_torch.models.configs import TINY
from llm_d_inference_scheduler_tpu_torch.models.vision import VIT_TINY


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


def _sim(loop, port=0, **kw):
    srv = EngineServer(EngineConfig(backend="sim", model="tiny", port=port, **kw))
    _run(loop, srv.start())
    return srv


def _jax_sim(loop, port=None, **kw):
    srv = JaxEngineServer(JaxEngineConfig(backend="sim", model="tiny",
                                          port=port or free_port(), **kw))
    _run(loop, srv.start())
    return srv


def _port(srv) -> int:
    return srv.port if isinstance(srv, EngineServer) else srv.cfg.port


def _stop(loop, *servers):
    for s in servers:
        _run(loop, s.stop(), 60)


def _call(port, path, body=None, method=None, timeout=60):
    """(status, lower-cased headers, body bytes)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, {k.lower(): v for k, v in r.headers.items()}, r.read()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read()


# ---- analogues of the JAX sim tests ----------------------------------------------


def test_sim_server_openai_surface(loop):
    """``tests/test_engine.py:92`` on the port's sim server."""
    server = _sim(loop, max_batch=4, max_model_len=128)

    async def body():
        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{server.port}") as c:
            r = await c.post("/v1/completions",
                             json={"model": "tiny", "prompt": "hello", "max_tokens": 4})
            assert r.status_code == 200
            body_ = r.json()
            assert body_["choices"][0]["finish_reason"] == "length"
            assert body_["usage"]["completion_tokens"] == 4

            r = await c.post("/v1/chat/completions", json={
                "model": "tiny",
                "messages": [{"role": "user", "content": "hi"}], "max_tokens": 3})
            assert r.json()["choices"][0]["message"]["role"] == "assistant"

            r = await c.get("/v1/models")
            assert r.json()["data"][0]["id"] == "tiny"

            r = await c.post("/v1/completions/render", json={"prompt": "abc"})
            assert len(r.json()["token_ids"]) == 4  # BOS + 3 bytes

            r = await c.get("/metrics")
            for name in ("jetstream:num_requests_waiting",
                         "jetstream:num_requests_running",
                         "jetstream:kv_cache_usage_perc",
                         "jetstream:cache_config_info",
                         "jetstream:lora_requests_info"):
                assert name in r.text, f"missing metric {name}"

            async with c.stream("POST", "/v1/completions",
                                json={"prompt": "s", "max_tokens": 3,
                                      "stream": True}) as r:
                chunks = [line[6:] async for line in r.aiter_lines()
                          if line.startswith("data: ")]
                assert chunks[-1] == "[DONE]"
                assert len(chunks) >= 4  # 3 tokens + final + DONE

    try:
        _run(loop, body())
    finally:
        _stop(loop, server)


def test_sidecar_chunked_decode_and_dp_ranks(loop):
    """``tests/test_e2e_disagg.py:287``: the sidecar's chunked decode
    reassembles the text over two port sims as DP ranks, and its rank-1
    listener reaches the second."""
    dec, sc_port = free_port(span=2), free_port(span=2)
    e0, e1 = _sim(loop, port=dec), _sim(loop, port=dec + 1)
    sc = Sidecar(SidecarConfig(port=sc_port, decoder_url=f"http://127.0.0.1:{dec}",
                               decode_chunk_size=3, data_parallel_size=2))
    _run(loop, sc.start())

    async def body():
        async with httpx.AsyncClient(timeout=60) as c:
            r = await c.post(f"http://127.0.0.1:{sc_port}/v1/completions",
                             json={"prompt": "x", "max_tokens": 8})
            assert r.status_code == 200
            doc = r.json()
            assert doc["usage"]["completion_tokens"] == 8
            assert len(doc["choices"][0]["text"]) == 8
            r = await c.post(f"http://127.0.0.1:{sc_port + 1}/v1/completions",
                             json={"prompt": "x", "max_tokens": 2})
            assert r.status_code == 200

    try:
        before = e1.engine.telemetry.request_success.labels(finished_reason="length").value
        _run(loop, body())
        assert e1.engine.telemetry.request_success.labels(
            finished_reason="length").value == before + 1
    finally:
        _run(loop, sc.stop(), 60)
        _stop(loop, e1, e0)


EPD_CFG = """
pool:
  endpoints:
    - {{address: 127.0.0.1, port: {sc}, labels: {{llm-d.ai/role: decode}}}}
    - {{address: 127.0.0.1, port: {pre}, labels: {{llm-d.ai/role: prefill}}}}
    - {{address: 127.0.0.1, port: {enc}, labels: {{llm-d.ai/role: encode}}}}
plugins:
  - {{type: decode-filter}}
  - {{type: prefill-filter}}
  - {{type: encode-filter}}
  - {{type: queue-scorer}}
  - {{type: approx-prefix-cache-producer}}
  - {{type: prefix-cache-scorer}}
  - type: disagg-profile-handler
    parameters:
      pdDecider:
        type: prefix-based-pd-decider
        parameters: {{thresholdTokens: 16}}
      encodeDecider: always-disagg-multimodal-decider
schedulingProfiles:
  - name: decode
    plugins:
      - {{pluginRef: decode-filter}}
      - {{pluginRef: queue-scorer}}
  - name: prefill
    plugins:
      - {{pluginRef: prefill-filter}}
      - {{pluginRef: queue-scorer}}
  - name: encode
    plugins:
      - {{pluginRef: encode-filter}}
      - {{pluginRef: queue-scorer}}
"""


def test_epd_encode_fanout(loop):
    """``tests/test_e2e_epd.py:52`` with port sims as the decode, prefill
    and encode pods behind the router's gateway and sidecar."""
    dec, pre, enc = (_sim(loop, role=r) for r in ("decode", "prefill", "encode"))
    sc_port, gw_port = free_port(), free_port()
    sc = Sidecar(SidecarConfig(port=sc_port, decoder_url=f"http://127.0.0.1:{dec.port}",
                               ssrf_allowlist=[f"127.0.0.1:{pre.port}",
                                               f"127.0.0.1:{enc.port}"]))
    _run(loop, sc.start())
    gw = build_gateway(EPD_CFG.format(sc=sc_port, pre=pre.port, enc=enc.port),
                       port=gw_port, poll_interval=0.02)
    _run(loop, gw.start(), 60)

    async def body():
        long_text = "describe this image in detail please " * 4
        async with httpx.AsyncClient(timeout=60) as c:
            r = await c.post(f"http://127.0.0.1:{gw_port}/v1/chat/completions", json={
                "model": "tiny", "max_tokens": 3,
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": long_text},
                    {"type": "image_url", "image_url": {"url": "http://x/cat.png"}},
                    {"type": "image_url", "image_url": {"url": "http://x/dog.png"}},
                ]}]})
            assert r.status_code == 200
            assert len(enc.ec_store) == 1
            (rec,) = enc.ec_store.values()
            assert rec["embeds"].shape == (2 * VIT_TINY.n_patches, TINY.d_model)
            assert rec["indices"] == [0, 1]
            m = await c.get(f"http://127.0.0.1:{gw_port}/metrics")
            assert 'decision_type="encode-prefill-decode"' in m.text
            before = list(enc.ec_store)
            r = await c.post(f"http://127.0.0.1:{gw_port}/v1/chat/completions", json={
                "model": "tiny", "max_tokens": 2,
                "messages": [{"role": "user", "content": "plain text"}]})
            assert r.status_code == 200
            assert list(enc.ec_store) == before

    try:
        _run(loop, body())
    finally:
        _run(loop, gw.stop(), 60)
        _run(loop, sc.stop(), 60)
        _stop(loop, dec, pre, enc)


def test_engine_hit_accounting_and_debug_kv(loop):
    """``tests/test_kvobs.py:207`` on the port's sim server."""
    srv = _sim(loop, max_batch=4)
    base = f"http://127.0.0.1:{srv.port}"

    async def body():
        async with httpx.AsyncClient(timeout=30) as c:
            prompt = "the shared system preamble " * 8
            r1 = await c.post(f"{base}/v1/completions", json={"prompt": prompt,
                                                              "max_tokens": 2})
            assert r1.headers["x-kv-hit-tokens"] == "0"
            assert r1.json()["usage"]["prompt_tokens_details"] == {"cached_tokens": 0}
            r2 = await c.post(f"{base}/v1/completions", json={"prompt": prompt,
                                                              "max_tokens": 2})
            warm = int(r2.headers["x-kv-hit-tokens"])
            assert warm > 0
            assert int(r2.headers["x-kv-hit-blocks"]) == warm // 16
            usage = None
            async with c.stream("POST", f"{base}/v1/completions",
                                json={"prompt": prompt, "max_tokens": 2,
                                      "stream": True}) as r3:
                async for line in r3.aiter_lines():
                    if line.startswith("data: ") and '"usage"' in line:
                        usage = json.loads(line[6:])["usage"]
            assert usage["prompt_tokens_details"]["cached_tokens"] > 0
            dbg = (await c.get(f"{base}/debug/kv")).json()
            assert dbg["count"] == 3
            assert dbg["totals"]["prefix_hit_tokens"] > 0
            assert 0 < dbg["totals"]["actual_hit_ratio"] < 1
            assert dbg["recent"][0]["hit_tokens"] > 0
            m = (await c.get(f"{base}/metrics")).text
            assert "jetstream:prefill_tokens_total" in m
            assert "jetstream:prefix_hit_tokens_total" in m

    try:
        _run(loop, body())
    finally:
        _stop(loop, srv)


# ---- the two sims side by side -------------------------------------------------------


def _fields(doc):
    """A JSON document's field structure: keys (nested), list element
    structure, not values."""
    if isinstance(doc, dict):
        return {k: _fields(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_fields(doc[0])] if doc else []
    return None


def _shape(status, headers, raw):
    """(status, JSON fields or the SSE frames' fields, sorted x- header
    names)."""
    names = sorted(k for k in headers if k.startswith("x-"))
    text = raw.decode(errors="replace")
    if headers.get("content-type", "").startswith("text/event-stream"):
        frames = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
        return status, [f if f == "[DONE]" else _fields(json.loads(f)) for f in frames], names
    try:
        return status, _fields(json.loads(text)), names
    except ValueError:
        return status, None, names


def _metric_names(port):
    text = _call(port, "/metrics")[2].decode()
    return {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
            if ln and not ln.startswith("#")}


REQUESTS = [
    ("POST", "/v1/completions", {"prompt": "hello sim", "max_tokens": 4}),
    ("POST", "/v1/completions", {"prompt": "hello sim", "max_tokens": 4}),  # warm
    ("POST", "/v1/completions", {"prompt": "stream me", "max_tokens": 3, "stream": True}),
    ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                      "max_tokens": 3}),
    ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                      "max_tokens": 2, "stream": True}),
    ("POST", "/v1/responses", {"input": "hi there", "max_output_tokens": 3}),
    ("POST", "/v1/embeddings", {"input": ["one", "two"]}),
    ("POST", "/v1/completions/render", {"prompt": "abc"}),
    ("POST", "/v1/chat/completions/render", {"messages": [{"role": "user",
                                                           "content": "abc"}]}),
    ("GET", "/v1/models", None),
    ("GET", "/health", None),
    ("GET", "/debug/kv?n=2", None),
    ("POST", "/v1/encode", {"request_id": "enc-1", "items": [
        {"type": "image_url", "image_url": {"url": "http://x/a.png"}},
        {"type": "image_url", "pixels": [[[0.5] * 3] * 4] * 4}]}),
    ("GET", "/ec/enc-1", None),
    ("GET", "/ec/missing", None),
    ("GET", "/kv/missing", None),
    ("POST", "/v1/completions", {"prompt": "x" * 40, "max_tokens": 1,
                                 "request_id": "pd-1",
                                 "kv_transfer_params": {"do_remote_decode": True}}),
    ("GET", "/kv/pd-1?chunk=0", None),
    ("GET", "/kv/pd-1?ack=1", None),
    ("GET", "/kv/pd-1", None),
    ("DELETE", "/kv/pd-1", None),
    ("POST", "/v1/completions", {"prompt": "", "max_tokens": 2, "bogus": 1}),
]


def test_port_sim_answers_as_the_jax_sim(loop):
    """The same requests to both sims: equal statuses, JSON fields and x-
    header names, and the same /metrics names."""
    port, jax = _sim(loop, max_batch=4), _jax_sim(loop, max_batch=4)
    try:
        got = {}
        for key, srv in (("port", port), ("jax", jax)):
            got[key] = [_shape(*_call(_port(srv), path, body, method))
                        for method, path, body in REQUESTS]
        for req, mine, ref in zip(REQUESTS, got["port"], got["jax"]):
            assert mine[0] == ref[0], (req, mine, ref)
            if ref[1] is not None:
                assert mine[1] == ref[1], (req, mine, ref)
            assert mine[2] == ref[2], (req, mine, ref)
        assert got["port"][REQUESTS.index(("GET", "/kv/pd-1", None))][0] == 501
        assert _metric_names(_port(port)) == _metric_names(_port(jax))
        assert port.engine.idle()
    finally:
        _stop(loop, port, jax)


@pytest.mark.parametrize("stream", [False, True], ids=["serial", "chunked"])
def test_sim_pd_legs_across_the_two_sims(loop, stream):
    """A P/D handoff between sims, each way between the port's and the JAX
    one: the decode leg prices the pull (serial: remote_block_ids; chunked:
    long-polls the prefill sim's /kv chunks) and answers the same statuses,
    fields and x- headers as a JAX decode sim pulling from the same kind of
    exporter."""
    # A prefill window, so the chunked export stages several chunks.
    pre = {"port": _sim(loop, prefill_chunk=16), "jax": _jax_sim(loop, prefill_chunk=16)}
    dec = {"port": _sim(loop), "jax": _jax_sim(loop)}
    try:
        prompt = "a long shared prompt for the prefill leg " * 3
        shapes = {}
        for p_key in ("port", "jax"):
            for d_key in ("port", "jax"):
                rid = f"{p_key}-{d_key}"
                ktp = {"do_remote_decode": True, **({"stream_chunks": True} if stream else {})}
                status, _, raw = _call(_port(pre[p_key]), "/v1/completions", {
                    "prompt": prompt, "max_tokens": 1, "request_id": rid,
                    "kv_transfer_params": ktp})
                assert status == 200
                remote = json.loads(raw)["kv_transfer_params"]
                if stream:
                    remote["stream_chunks"] = True
                shape = _shape(*_call(_port(dec[d_key]), "/v1/completions", {
                    "prompt": prompt, "max_tokens": 4, "request_id": f"d-{rid}",
                    "kv_transfer_params": remote}))
                assert "x-kv-pull-route" in shape[2], shape
                shapes[rid] = shape
        assert shapes["port-port"] == shapes["jax-port"] == shapes["port-jax"] \
            == shapes["jax-jax"]
        for srv in dec.values():  # no hit on an import leg
            assert srv.engine.kv_hits.ring == type(srv.engine.kv_hits.ring)()
        if stream:
            for srv in pre.values():
                assert not srv.engine.kv_exports  # each decode leg released its export
    finally:
        _stop(loop, *pre.values(), *dec.values())


# ---- entry points ----------------------------------------------------------------------


def test_backend_and_platform_flags(loop):
    """``--backend sim --platform cpu`` serves from the parser with no
    kernel launch; the port refuses the JAX "tpu" backend and platform;
    ``--platform gpu`` and ``cuda`` mean the card."""
    cfg, _ = server_mod.parse_config(["--backend", "sim", "--platform", "cpu",
                                      "--port", "0", "--model", "tiny"])
    assert (cfg.backend, cfg.device) == ("sim", "cpu")
    for platform in ("gpu", "cuda"):
        assert server_mod.parse_config(["--platform", platform])[0].device == "cuda"
    assert server_mod.parse_config(["--platform", "cpu"])[0].device == "cpu"
    for refused in (["--backend", "tpu"], ["--platform", "tpu"], ["--backend", "vllm"]):
        with pytest.raises(SystemExit):
            server_mod.parse_config(refused)
    with pytest.raises(ValueError, match="unknown engine backend 'tpu'"):
        server_mod.make_engine(EngineConfig(backend="tpu"))
    srv = EngineServer(cfg)
    assert isinstance(srv.engine, SimEngine)
    _run(loop, srv.start())
    try:
        ops.reset_kernel_launches()
        status, _, raw = _call(srv.port, "/v1/completions", {"prompt": "hi",
                                                             "max_tokens": 3})
        assert status == 200 and json.loads(raw)["choices"][0]["text"]
        status, _, raw = _call(srv.port, "/health")
        assert status == 200 and json.loads(raw)["status"] == "ok"
        assert all(n == 0 for n in ops.kernel_launches().values())
    finally:
        _stop(loop, srv)


def test_sim_events_and_embeddings(loop):
    """The sim's SSE-only KV events reach a /kv_events subscriber (stored
    for the served prompt's blocks), and its embeddings are the JAX sim's
    deterministic unit vectors."""
    srv = _sim(loop)
    jax = _jax_sim(loop)
    try:
        async def subscribe():
            async with httpx.AsyncClient(timeout=10) as c:
                async with c.stream("GET", f"http://127.0.0.1:{srv.port}/kv_events") as r:
                    assert r.status_code == 200
                    post = asyncio.create_task(c.post(
                        f"http://127.0.0.1:{srv.port}/v1/completions",
                        json={"prompt": "z" * 40, "max_tokens": 1}))
                    async for line in r.aiter_lines():
                        if line.startswith("data: "):
                            doc = json.loads(line[6:])
                            if doc["event"] == "stored" and doc["hashes"]:
                                await post
                                return doc

        doc = _run(loop, subscribe())
        assert doc["engine_id"] == srv.engine.engine_id and len(doc["hashes"]) == 2
        body = {"input": [[1, 2, 3], "text"]}
        mine = json.loads(_call(srv.port, "/v1/embeddings", body)[2])
        ref = json.loads(_call(_port(jax), "/v1/embeddings", body)[2])
        for a, b in zip(mine["data"], ref["data"]):
            np.testing.assert_allclose(a["embedding"], b["embedding"], rtol=1e-6)
    finally:
        _stop(loop, srv, jax)
