"""PyTorch port, the router-facing engine surface: render, embeddings,
responses, /debug/kv and /debug/traces, and the router's own token producer
and precise prefix scorer in front of port engines.

In-process servers on free ports, TINY (and tiny-moe) on the CPU. Where the
JAX package is the reference, both stacks get the same inputs: render
bodies against the JAX server (``backend="sim"``, the same byte
tokenizer), ``embed`` against ``TpuEngine.embed`` on the same f32 weights
(``params_from_numpy``), with ``rtol = atol = 1e-4`` as the port's other
f32 hidden-state comparisons (the two sum in other orders).
"""

import asyncio
import dataclasses
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
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu.engine.server import EngineServer as JaxEngineServer
from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu.router import tracing as router_tracing
from llm_d_inference_scheduler_tpu.router.gateway import build_gateway
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy
from llm_d_inference_scheduler_tpu_torch.utils import tracing
from llm_d_inference_scheduler_tpu_torch.utils.hashing import chain_block_hashes

TOL = dict(rtol=1e-4, atol=1e-4)


def _request(port, path, body=None, headers=None, timeout=60, method=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"content-type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, {k.lower(): v for k, v in r.headers.items()}, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read().decode()


def _json(port, path, body=None, headers=None):
    status, hdrs, text = _request(port, path, body, headers)
    assert status == 200, text[:300]
    return hdrs, json.loads(text)


def _sse_docs(text: str) -> list[dict]:
    events = [line[6:] for line in text.splitlines() if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield loop
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)


def _start(loop, server):
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(120)
    return server


def _stop(loop, server):
    asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)


def _port_server(loop, **kw):
    cfg = EngineConfig(**{"model": "tiny", "device": "cpu", "dtype": "float32",
                          "port": 0, "max_batch": 2, "max_model_len": 256,
                          "decode_chunk": 4, **kw})
    return _start(loop, EngineServer(cfg))


@pytest.fixture(scope="module")
def server(loop):
    srv = _port_server(loop, max_model_len=64)
    yield srv
    _stop(loop, srv)


# ---- render ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_sim(loop):
    cfg = JaxEngineConfig(backend="sim", model="tiny", port=free_port(),
                          kv_events_port=0)
    srv = _start(loop, JaxEngineServer(cfg))
    yield cfg.port
    _stop(loop, srv)


@pytest.mark.parametrize("path,body", [
    ("/v1/completions/render", {"prompt": "hello wörld, render me"}),
    ("/v1/completions/render", {"prompt": [1, 5, 9, 300]}),
    ("/v1/completions/render", {}),
    ("/v1/chat/completions/render", {"messages": [
        {"role": "system", "content": "sys"},
        {"role": "user", "content": [{"type": "text", "text": "a"},
                                     {"type": "text", "text": "b"}]}]}),
    ("/v1/chat/completions/render", {"continue_final_message": True, "messages": [
        {"role": "user", "content": "q"}, {"role": "assistant", "content": "par"}]}),
], ids=["text", "ids", "empty", "chat", "chat-continue"])
def test_render_bodies_equal_the_jax_server(server, jax_sim, path, body):
    _, mine = _json(server.port, path, body)
    _, ref = _json(jax_sim, path, body)
    assert mine == ref
    assert mine["count"] == len(mine["token_ids"])


# ---- embeddings ---------------------------------------------------------------


def _f32_dir(tmp_path_factory, base):
    d = tmp_path_factory.mktemp(f"{base.name}_f32")
    (d / "model_config.json").write_text(json.dumps(
        dataclasses.asdict(base) | {"dtype": "float32"}))
    return str(d)


EMBED_PROMPTS = [[1, 5, 9, 13], [1, 5, 9, 14], list(range(3, 3 + 17)),
                 [1] + list(range(40, 100))]


@pytest.fixture(scope="module")
def embeddings(tmp_path_factory):
    """embed() of EMBED_PROMPTS through the JAX engine and the port engine
    (tiny: dense FFN; tiny-moe: the grouped path, K2's plain version here,
    and the dense-over-experts FFN) on the same weights."""
    out = {}
    for base, impls in ((jax_configs.TINY, ("dense",)),
                        (jax_configs.TINY_MOE, ("grouped", "dense"))):
        model = _f32_dir(tmp_path_factory, base)
        jparams = jax_llama.init_params(jax_configs.get_config(model),
                                        jax.random.key(13))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        common = dict(model=model, max_batch=2, max_model_len=128)

        async def run(engine):
            await engine.start()
            try:
                return [np.asarray(engine.embed(p)) for p in EMBED_PROMPTS] \
                    + [np.asarray(engine.embed(EMBED_PROMPTS[0]))]
            finally:
                await engine.stop()

        ref = asyncio.run(run(TpuEngine(JaxEngineConfig(
            **common, kv_events_port=0, kv_transfer="host"), params=jparams)))
        for impl in impls:
            eng = TorchEngine(EngineConfig(**common, device="cpu",
                                           grouped_moe=impl == "grouped"),
                              params=tparams)
            assert eng.mcfg.moe_impl == impl or not base.n_experts
            out[f"{base.name}-{impl}"] = (asyncio.run(run(eng)), ref)
    return out


@pytest.mark.parametrize("case", ["tiny-dense", "tiny-moe-grouped", "tiny-moe-dense"])
def test_embed_matches_jax_engine(embeddings, case):
    mine, ref = embeddings[case]
    for got, want in zip(mine, ref):
        assert got.shape == want.shape == (128,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(mine[0], mine[-1])  # deterministic
    assert not np.allclose(mine[0], mine[1])          # another prompt, another vector


def test_http_embeddings_endpoint(server):
    _, doc = _json(server.port, "/v1/embeddings",
                   {"model": "tiny", "input": ["hello", "world"]})
    assert doc["object"] == "list" and [d["index"] for d in doc["data"]] == [0, 1]
    assert len(doc["data"][0]["embedding"]) == 128
    assert doc["model"] == "tiny"
    n = len(server.engine.tokenizer.encode("hello")) * 2
    assert doc["usage"] == {"prompt_tokens": n, "total_tokens": n}
    vec = server.engine.embed(server.engine.tokenizer.encode("world"))
    np.testing.assert_array_equal(np.asarray(doc["data"][1]["embedding"],
                                             np.float32), vec)
    for body, count in (({"input": [3, 4, 5]}, 1),
                        ({"input": [[3, 4, 5], [6, 7]]}, 2)):
        _, doc = _json(server.port, "/v1/embeddings", body)
        assert len(doc["data"]) == count
    status, _, _ = _request(server.port, "/v1/embeddings", {"input": "x" * 100})
    assert status == 400  # over the 64-token context


@pytest.mark.parametrize("body", [{"input": []}, {"input": ""},
                                  {"input": ["ok", ""]}, {}, {"input": 7},
                                  {"input": [["a"]]}],
                         ids=["empty-list", "empty-str", "empty-item", "none",
                              "number", "nested-str"])
def test_embeddings_bad_input_rejected(server, body):
    status, _, _ = _request(server.port, "/v1/embeddings", body)
    assert status == 400


# ---- responses ------------------------------------------------------------------


def test_responses_match_chat(server):
    messages = [{"role": "system", "content": "sys"},
                {"role": "user", "content": "tell me"}]
    _, chat = _json(server.port, "/v1/chat/completions", {
        "messages": messages, "max_tokens": 5, "temperature": 0, "ignore_eos": True})
    text = chat["choices"][0]["message"]["content"]
    body = {"input": "tell me", "instructions": "sys", "max_output_tokens": 5,
            "temperature": 0, "ignore_eos": True}
    _, doc = _json(server.port, "/v1/responses", body)
    assert doc["object"] == "response" and doc["model"] == "tiny"
    msg = doc["output"][0]
    assert msg["type"] == "message" and msg["role"] == "assistant"
    assert msg["content"][0]["text"] == text
    u = doc["usage"]
    assert u["output_tokens"] == 5
    assert u["input_tokens"] == chat["usage"]["prompt_tokens"]
    assert u["total_tokens"] == u["input_tokens"] + u["output_tokens"]
    assert doc["status"] == "incomplete"
    assert doc["incomplete_details"] == {"reason": "max_output_tokens"}

    # The item-array input renders to the same prompt.
    _, items = _json(server.port, "/v1/responses", body | {"input": [
        {"type": "message", "role": "user", "content": "tell me"}]})
    assert items["output"][0]["content"][0]["text"] == text

    status, _, raw = _request(server.port, "/v1/responses", body | {"stream": True})
    assert status == 200
    docs = _sse_docs(raw)
    deltas = [d["delta"] for d in docs if d["type"] == "response.output_text.delta"]
    assert "".join(deltas) == text
    done = docs[-1]
    assert done["type"] == "response.completed"
    assert done["response"]["status"] == "incomplete"
    assert done["response"]["usage"] == u


def test_responses_relays_kv_transfer_params(server):
    _, doc = _json(server.port, "/v1/responses", {
        "input": "hand me off", "max_output_tokens": 4, "temperature": 0,
        "kv_transfer_params": {"do_remote_decode": True}})
    ktp = doc["kv_transfer_params"]
    assert ktp["remote_port"] == server.port and ktp["remote_num_blocks"] >= 1
    assert doc["usage"]["output_tokens"] == 1  # the prefill leg's one token
    rid = ktp["remote_request_id"]
    assert server.engine.get_kv_export(rid) is not None
    status, _, _ = _request(server.port, f"/kv/{rid}", method="DELETE")
    assert status == 200 and server.engine.get_kv_export(rid) is None


# ---- /debug/kv ------------------------------------------------------------------


def test_engine_hit_accounting_and_debug_kv(loop):
    srv = _port_server(loop)
    try:
        prompt = "the shared system preamble " * 8
        h1, r1 = _json(srv.port, "/v1/completions", {"prompt": prompt, "max_tokens": 2})
        assert h1["x-kv-hit-tokens"] == "0"
        assert r1["usage"]["prompt_tokens_details"] == {"cached_tokens": 0}
        h2, _ = _json(srv.port, "/v1/completions", {"prompt": prompt, "max_tokens": 2})
        warm = int(h2["x-kv-hit-tokens"])
        assert warm > 0 and int(h2["x-kv-hit-blocks"]) == warm // 16
        status, _, raw = _request(srv.port, "/v1/completions", {
            "prompt": prompt, "max_tokens": 2, "stream": True})
        usage = [d["usage"] for d in _sse_docs(raw) if "usage" in d][0]
        assert usage["prompt_tokens_details"]["cached_tokens"] > 0
        _, dbg = _json(srv.port, "/debug/kv")
        assert dbg["count"] == 3 and dbg["block_size"] == 16
        assert dbg["engine_id"] == srv.engine.engine_id
        assert dbg["totals"]["prefix_hit_tokens"] > 0
        assert 0 < dbg["totals"]["actual_hit_ratio"] < 1
        assert dbg["recent"][0]["hit_tokens"] > 0
        assert dbg["recent"][-1]["hit_tokens"] == 0
        _, one = _json(srv.port, "/debug/kv?n=1")
        assert len(one["recent"]) == 1
    finally:
        _stop(loop, srv)


# ---- /debug/traces -------------------------------------------------------------


def test_debug_traces_join_the_incoming_traceparent(server, monkeypatch):
    monkeypatch.setattr(tracing.tracer, "enabled", True)
    trace_id, parent = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
    for path, body in (("/v1/completions", {"prompt": "trace me", "max_tokens": 3}),
                       ("/v1/chat/completions", {"messages": [
                           {"role": "user", "content": "trace"}], "max_tokens": 3}),
                       ("/v1/responses", {"input": "trace", "max_output_tokens": 3,
                                          "stream": True})):
        status, _, _ = _request(server.port, path, body, headers={
            "traceparent": f"00-{trace_id}-{parent}-01"})
        assert status == 200
    _, doc = _json(server.port, "/debug/traces")
    assert doc["service"] == "engine" and doc["engine_id"] == server.engine.engine_id
    mine = [s for s in doc["spans"] if s["trace_id"] == trace_id]
    roots = [s for s in mine if s["name"] == "engine.request"]
    assert [s["attributes"]["path"] for s in roots] == [
        "/v1/completions", "/v1/chat/completions", "/v1/responses"]
    assert all(s["parent_id"] == parent for s in roots)
    for root in roots:
        phases = {s["name"] for s in mine if s["parent_id"] == root["span_id"]}
        assert phases == {"engine.prefill", "engine.decode"}
    # A sampled-out caller (flags 00) leaves no span; a malformed header
    # starts a fresh root.
    n = len(tracing.tracer.snapshot())
    _request(server.port, "/v1/completions", {"prompt": "x", "max_tokens": 1},
             headers={"traceparent": f"00-{trace_id}-{parent}-00"})
    assert len(tracing.tracer.snapshot()) == n
    assert tracing.parse_traceparent("00-xyz-00f067aa0ba902b7-01") is None


# ---- the router in front of port engines ----------------------------------------


def test_router_precise_scorer_and_token_producer_over_port_engines(loop, monkeypatch):
    """The router's unchanged token producer tokenizes through a port
    engine's render route; its precise prefix scorer fills its index from
    the port engines' /kv_events and steers a repeat prompt to the warm
    pod; /debug/traces?merge=1 joins the engine's spans to the gateway's."""
    monkeypatch.setattr(router_tracing.tracer, "enabled", True)
    monkeypatch.setattr(router_tracing.tracer, "sample_ratio", 1.0)
    monkeypatch.setattr(tracing.tracer, "enabled", True)
    servers = [_port_server(loop) for _ in range(2)]
    renders = []
    for s in servers:
        for key in (("POST", "/v1/completions/render"),
                    ("POST", "/v1/chat/completions/render")):
            handler = s._routes[key]

            async def counted(conn, raw, handler=handler, port=s.port):
                renders.append((port, conn.path))
                await handler(conn, raw)

            s._routes[key] = counted
    pods = [f"127.0.0.1:{s.port}" for s in servers]
    gw_port = free_port()
    cfg = f"""
plugins:
  - {{type: token-producer}}
  - {{type: precise-prefix-cache-scorer}}
  - {{type: queue-scorer}}
schedulingProfiles:
  - name: default
    plugins:
      - {{pluginRef: precise-prefix-cache-scorer, weight: 3}}
      - {{pluginRef: queue-scorer}}
pool:
  endpoints:
    - {{address: 127.0.0.1, port: {servers[0].port}}}
    - {{address: 127.0.0.1, port: {servers[1].port}}}
"""
    gw = build_gateway(cfg, port=gw_port, poll_interval=0.02)
    asyncio.run_coroutine_threadsafe(gw.start(), loop).result(60)
    try:
        scorer = gw.cfg.plugins_by_name["precise-prefix-cache-scorer"]
        producer = gw.cfg.plugins_by_name["token-producer"]
        prompt = "warm cache target prompt " * 8
        ids = servers[0].engine.tokenizer.encode(prompt)
        chain = chain_block_hashes("tiny", ids, "", 16)
        body = {"model": "tiny", "prompt": prompt, "max_tokens": 3, "temperature": 0}
        h1, _ = _json(gw_port, "/v1/completions", body)
        first = h1["x-gateway-destination-endpoint-served"]
        other = [p for p in pods if p != first][0]
        assert renders and renders[0][1] == "/v1/completions/render"
        assert list(producer._cache.values()) == [ids]
        deadline = time.monotonic() + 10
        while scorer.index.pod_block_count(first) < len(chain):
            assert time.monotonic() < deadline, "no kv events reached the index"
            time.sleep(0.02)
        assert scorer.index.pod_block_count(other) == 0
        for _ in range(2):
            h, _ = _json(gw_port, "/v1/completions", body)
            assert h["x-gateway-destination-endpoint-served"] == first
        # Chat goes through the chat render route.
        _json(gw_port, "/v1/chat/completions", {
            "model": "tiny", "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 2})
        assert "/v1/chat/completions/render" in {p for _, p in renders}

        _, merged = _json(gw_port, "/debug/traces?merge=1")
        spans = merged["spans"]
        gw_roots = {s["trace_id"] for s in spans if s["name"] == "gateway.request"}
        joined = [s for s in spans if s["name"] == "engine.request"
                  and s["trace_id"] in gw_roots]
        assert len(joined) == 4  # three completions and the chat
        ids = {s["span_id"] for s in spans}
        assert all(s["parent_id"] in ids for s in joined)
    finally:
        asyncio.run_coroutine_threadsafe(gw.stop(), loop).result(60)
        for s in servers:
            _stop(loop, s)
