"""PyTorch port, E/P/D multimodal serving against the JAX package.

TINY in f32 on the CPU, in-process servers on free ports, the router's
unchanged gateway and sidecar:

- the engine: a request carrying encoder embeddings gives the JAX
  ``TpuEngine``'s greedy tokens on the same weights, prefills whole even
  with ``prefill_chunk``, and commits no prefix hash and publishes no
  ``stored`` event;
- port analogues of ``tests/test_e2e_epd.py``: the encode fan-out through
  the gateway and the sidecar onto port encode, prefill and decode engines
  (the E/P/D tokens equal a monolithic port engine's given the same
  ``ec_sources``), embeddings that steer the output, and the items' order
  kept across two encoders;
- across the wire with JAX engines: a JAX encode worker feeding a port
  decode engine and a port encode worker feeding a JAX decode engine
  resolve the same rows in the same order, and the two servers send the
  same ``/v1/encode`` and ``/ec`` bytes for the same staged rows.
"""

import asyncio
import dataclasses
import json
import threading
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
from llm_d_inference_scheduler_tpu.router.gateway import build_gateway
from llm_d_inference_scheduler_tpu.router.sidecar import Sidecar, SidecarConfig
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy
from llm_d_inference_scheduler_tpu_torch.models.vision import VIT_TINY

D = jax_configs.TINY.d_model


def _request(port, path, body=None, headers=None, timeout=90):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"content-type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _json(port, path, body=None, headers=None):
    status, raw = _request(port, path, body, headers)
    assert status == 200, raw[:300]
    return json.loads(raw)


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


def _port_server(loop, **kw):
    cfg = EngineConfig(**{"model": "tiny", "device": "cpu", "dtype": "float32",
                          "port": 0, "max_batch": 4, "max_model_len": 256,
                          "decode_chunk": 4, "kv_events_port": 0, **kw})
    srv = EngineServer(cfg)
    _run(loop, srv.start())
    return srv


def _jax_server(loop, **kw):
    cfg = JaxEngineConfig(**{"model": "tiny", "port": free_port(),
                             "kv_events_port": 0, **kw})
    srv = JaxEngineServer(cfg)
    _run(loop, srv.start())
    return srv


def _stop(loop, *servers):
    for s in servers:
        _run(loop, s.stop(), 60)


def _image(seed):
    return {"type": "image_url", "pixels": [[[float(seed)] * 3] * 4] * 4}


# ---- the engine -----------------------------------------------------------


def test_multimodal_engine_matches_jax_and_bypasses_cache_and_events(tmp_path):
    """M = 32 encoder rows + a 20-token text, greedy, with prefill_chunk=32
    on both engines: equal tokens; the port prefills it in one dispatch,
    commits no hash and publishes nothing, where a text prompt does both."""
    fields = dataclasses.asdict(jax_configs.TINY) | {"dtype": "float32"}
    (tmp_path / "model_config.json").write_text(json.dumps(fields))
    model = str(tmp_path)
    jparams = jax_llama.init_params(jax_configs.get_config(model), jax.random.key(9))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(3)
    M = 32
    mm = rng.standard_normal((M, D)).astype(np.float32)
    text = [int(t) for t in rng.integers(3, 450, size=20)]
    common = dict(model=model, max_batch=2, max_model_len=128, decode_chunk=4,
                  prefill_chunk=32)

    async def run(engine, make_req):
        await engine.start()
        try:
            out = {}
            for rid, prompt, kw in (("mm", [0] * M + text,
                                     {"mm_embeds": mm, "mm_positions": list(range(M))}),
                                    ("text", [0] * M + text, {})):
                q = engine.submit(make_req(request_id=rid, prompt_token_ids=prompt,
                                           max_tokens=8, temperature=0.0,
                                           ignore_eos=True, **kw))
                toks = []
                while True:
                    ev = await asyncio.wait_for(q.get(), 120)
                    if ev.token_id is not None:
                        toks.append(ev.token_id)
                    if ev.finish_reason is not None:
                        break
                out[rid] = toks
                if rid == "mm":
                    out["hashes_after_mm"] = list(
                        getattr(engine.allocator, "cached_hashes", list)())
            return out
        finally:
            await engine.stop()

    ref = asyncio.run(run(TpuEngine(JaxEngineConfig(**common, kv_events_port=0,
                                                    kv_transfer="host"),
                                    params=jparams), JaxRequest))
    eng = TorchEngine(EngineConfig(**common, device="cpu", port=0), params=tparams)
    published, prefills = [], []
    publish, run_prefill = eng._publish, eng._run_prefill
    # The prefill and eviction events (the 1 s snapshot goes round this).
    eng._publish = lambda ev, hashes: (hashes and published.append((ev, list(hashes))),
                                       publish(ev, hashes))
    eng._run_prefill = lambda req, *a: (prefills.append(req.request_id),
                                        run_prefill(req, *a))[1]
    got = asyncio.run(run(eng, EngineRequest))
    assert got["mm"] == ref["mm"] and len(got["mm"]) == 8
    assert got["text"] == ref["text"]
    assert got["mm"] != got["text"]  # the embeddings steered the output
    assert got["hashes_after_mm"] == []
    # One whole-prompt dispatch for the 52-token multimodal prompt; the text
    # prompt takes two windows of 32.
    assert prefills == ["mm", "text", "text"]
    assert [ev for ev, _ in published] == ["stored"]
    assert len(published[0][1]) == (M + len(text)) // 16


# ---- servers: port analogues of tests/test_e2e_epd.py -----------------------


def test_epd_fanout_through_gateway_and_sidecar(loop):
    dec = _port_server(loop, role="decode")
    pre = _port_server(loop, role="prefill")
    enc = _port_server(loop, role="encode")
    sc_port, gw_port = free_port(), free_port()
    sc = Sidecar(SidecarConfig(port=sc_port, decoder_url=f"http://127.0.0.1:{dec.port}",
                               ssrf_allowlist=[f"127.0.0.1:{pre.port}",
                                               f"127.0.0.1:{enc.port}"]))
    _run(loop, sc.start())
    cfg = f"""
pool:
  endpoints:
    - {{address: 127.0.0.1, port: {sc_port}, labels: {{llm-d.ai/role: decode}}}}
    - {{address: 127.0.0.1, port: {pre.port}, labels: {{llm-d.ai/role: prefill}}}}
    - {{address: 127.0.0.1, port: {enc.port}, labels: {{llm-d.ai/role: encode}}}}
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
    gw = build_gateway(cfg, port=gw_port, poll_interval=0.02)
    _run(loop, gw.start(), 60)
    try:
        messages = [{"role": "user", "content": [
            {"type": "text", "text": "describe this image in detail please " * 4},
            {"type": "image_url", "image_url": {"url": "http://x/cat.png"}},
            {"type": "image_url", "image_url": {"url": "http://x/dog.png"}}]}]
        body = {"model": "tiny", "max_tokens": 5, "temperature": 0,
                "ignore_eos": True, "request_id": "epd-1", "messages": messages}
        doc = _json(gw_port, "/v1/chat/completions", body)
        # The encoder was primed with both items: one staged entry of
        # 2 x n_patches rows, projected into the served model's d_model.
        assert list(enc.ec_store) == ["epd-1"]
        rec = enc.ec_store["epd-1"]
        assert rec["embeds"].shape == (2 * VIT_TINY.n_patches, D)
        assert rec["indices"] == [0, 1]
        assert _json(enc.port, "/health")["role"] == "encode"
        metrics = _request(gw_port, "/metrics")[1].decode()
        assert 'decision_type="encode-prefill-decode"' in metrics
        # The prefill leg ran the multimodal prefill (placeholders + text)
        # and the decode leg imported its KV: the same tokens as one port
        # engine given the same ec_sources.
        assert pre.engine.telemetry.prompt_tokens.value >= 2 * VIT_TINY.n_patches
        mono = _json(pre.port, "/v1/chat/completions",
                     {**body, "ec_sources": [f"127.0.0.1:{enc.port}"]})
        text = doc["choices"][0]["message"]["content"]
        assert text == mono["choices"][0]["message"]["content"] and text
        assert doc["usage"]["prompt_tokens"] == mono["usage"]["prompt_tokens"]

        # A text-only request: no encode stage.
        _json(gw_port, "/v1/chat/completions", {
            "model": "tiny", "max_tokens": 2,
            "messages": [{"role": "user", "content": "plain text"}]})
        assert list(enc.ec_store) == ["epd-1"]
    finally:
        _run(loop, gw.stop(), 60)
        _run(loop, sc.stop(), 60)
        _stop(loop, dec, pre, enc)


def test_epd_embeddings_reach_prefill_and_change_output(loop):
    dec = _port_server(loop)
    enc = _port_server(loop, role="encode")
    sc = Sidecar(SidecarConfig(port=free_port(),
                               decoder_url=f"http://127.0.0.1:{dec.port}"))
    _run(loop, sc.start())
    try:
        def ask(content, encoders=True):
            headers = {"x-encoder-hosts-ports": f"127.0.0.1:{enc.port}"} if encoders else {}
            doc = _json(sc.cfg.port, "/v1/chat/completions", {
                "model": "tiny", "max_tokens": 6, "temperature": 0,
                "ignore_eos": True,
                "messages": [{"role": "user", "content": content}]}, headers)
            return doc["choices"][0]["message"]["content"]

        a = ask([{"type": "text", "text": "what is this?"}, _image(1.0)])
        b = ask([{"type": "text", "text": "what is this?"}, _image(-3.0)])
        plain = ask("what is this?", encoders=False)
        assert a and b
        assert a != b and a != plain and b != plain
    finally:
        _run(loop, sc.stop(), 60)
        _stop(loop, dec, enc)


def test_epd_item_order_preserved_across_hosts(loop):
    dec = _port_server(loop)
    enc_a = _port_server(loop, role="encode")
    enc_b = _port_server(loop, role="encode", seed=1)
    sc = Sidecar(SidecarConfig(port=free_port(),
                               decoder_url=f"http://127.0.0.1:{dec.port}"))
    _run(loop, sc.start())
    try:
        rid = "order-test-1"
        sources = [f"127.0.0.1:{enc_a.port}", f"127.0.0.1:{enc_b.port}"]
        _json(sc.cfg.port, "/v1/chat/completions", {
            "model": "tiny", "max_tokens": 3, "temperature": 0, "ignore_eos": True,
            "request_id": rid,
            "messages": [{"role": "user", "content": [{"type": "text", "text": "see"}]
                          + [_image(s) for s in (1.0, 2.0, 3.0)]}]},
            {"x-encoder-hosts-ports": ",".join(sources)})
        rec_a, rec_b = enc_a.ec_store[rid], enc_b.ec_store[rid]
        assert rec_a["indices"] == [0, 2] and rec_b["indices"] == [1]
        prompt, mm, pos = _run(loop, dec._resolve_multimodal(
            {"request_id": rid, "ec_sources": sources}, [5, 6]))
        per = rec_a["embeds"].shape[0] // 2
        expected = np.concatenate([rec_a["embeds"][:per], rec_b["embeds"],
                                   rec_a["embeds"][per:]])
        np.testing.assert_array_equal(mm, expected)
        assert pos == list(range(mm.shape[0]))
        assert prompt == [0] * mm.shape[0] + [5, 6]
        # A source that is down is skipped with a warning; a width other
        # than d_model is ignored.
        dead = f"127.0.0.1:{free_port()}"
        _, mm2, _ = _run(loop, dec._resolve_multimodal(
            {"request_id": rid, "ec_sources": [dead, sources[1]]}, [5]))
        np.testing.assert_array_equal(mm2, rec_b["embeds"])
        enc_b.ec_store["narrow"] = {"embeds": np.ones((16, D // 2), np.float32),
                                    "indices": [0]}
        assert _run(loop, dec._resolve_multimodal(
            {"request_id": "narrow", "ec_sources": sources[1:]}, [5]))[1:] == (None, None)
    finally:
        _run(loop, sc.stop(), 60)
        _stop(loop, dec, enc_a, enc_b)


# ---- across the wire with JAX engines -----------------------------------------


def test_jax_and_port_encoders_and_decoders_interoperate(loop):
    """A JAX sim encoder and a port encoder (items 0, 2 and 1): the port and
    the JAX decode engines resolve the same rows in the same order and
    serve the request; for the same staged rows both encoders send the
    same bytes."""
    jenc = _jax_server(loop, backend="sim", role="encode")
    penc = _port_server(loop, role="encode")
    jdec = _jax_server(loop, max_batch=2, max_model_len=128)
    pdec = _port_server(loop, max_model_len=128)
    try:
        rid = "wire-1"
        items = [_image(s) for s in (0.5, -1.0, 2.0)]
        for srv, idx in ((jenc, [0, 2]), (penc, [1])):
            port = srv.port if isinstance(srv, EngineServer) else srv.cfg.port
            doc = _json(port, "/v1/encode", {"request_id": rid,
                                             "items": [items[i] for i in idx],
                                             "item_indices": idx})
            assert doc == {"request_id": rid, "encoded_items": len(idx),
                           "embedding_tokens": len(idx) * VIT_TINY.n_patches}
        sources = [f"127.0.0.1:{jenc.cfg.port}", f"127.0.0.1:{penc.port}"]
        body = {"request_id": rid, "ec_sources": sources}
        p_prompt, p_mm, p_pos = _run(loop, pdec._resolve_multimodal(body, [7]))
        j_prompt, j_mm, j_pos = _run(loop, jdec._resolve_multimodal(body, [7]))
        assert p_mm.shape == j_mm.shape == (3 * VIT_TINY.n_patches, D)
        np.testing.assert_array_equal(p_mm, j_mm)
        assert (p_prompt, p_pos) == (j_prompt, j_pos)
        per = VIT_TINY.n_patches
        j_rows, p_rows = jenc.ec_store[rid]["embeds"], penc.ec_store[rid]["embeds"]
        np.testing.assert_array_equal(p_mm, np.concatenate(
            [j_rows[:per], p_rows, j_rows[per:]]))
        # Each decode engine serves the request from the other stack's rows.
        req = {"prompt": [7, 8, 9], "max_tokens": 3, "temperature": 0,
               "ignore_eos": True, **body}
        for port in (pdec.port, jdec.cfg.port):
            doc = _json(port, "/v1/completions", req)
            assert doc["usage"]["prompt_tokens"] == 3 * per + 3
            assert doc["usage"]["completion_tokens"] == 3
        # The /ec wire, byte for byte, for the same staged rows.
        penc.ec_store["same"] = dict(jenc.ec_store[rid])
        jenc.ec_store["same"] = dict(jenc.ec_store[rid])
        assert (_request(penc.port, "/ec/same")[1]
                == _request(jenc.cfg.port, "/ec/same")[1])
        assert _request(penc.port, "/ec/unknown")[0] == 404
    finally:
        _stop(loop, jenc, penc, jdec, pdec)


def test_encode_rejects_bad_items(loop):
    enc = _port_server(loop, role="encode")
    try:
        for body in ({"items": "not a list"}, {"items": [{"pixels": "x"}]},
                     {"items": [{"pixels": [1.0, 2.0]}]}):
            assert _request(enc.port, "/v1/encode", body)[0] == 400
        assert _request(enc.port, "/v1/completions", {
            "prompt": "hi", "ec_sources": "127.0.0.1:1"})[0] == 400
        # An empty item list stages an empty entry, as the JAX server does.
        assert _json(enc.port, "/v1/encode", {"request_id": "e", "items": []}) == {
            "request_id": "e", "encoded_items": 0, "embedding_tokens": 0}
    finally:
        _stop(loop, enc)
