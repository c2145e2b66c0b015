"""PyTorch port, P/D KV handoff: the /kv wire between port and JAX engines.

In-process servers on free ports, TINY in f32 on the CPU (a
model_config.json with dtype float32), the same weights in both stacks
(JAX ``init_params`` carried over by ``params_from_numpy``), greedy tokens:

- serial (2-phase) and chunk-streamed (pipelined) handoffs port->port,
  JAX->port and port->JAX, each token-equal to monolithic serving;
- bf16: the port's export bytes and ``x-kv-dtype`` are the JAX server's for
  the same page values, and a JAX bf16 payload imports into the port;
- a tiny-moe handoff with ``grouped_moe=True`` (K2's plain version here);
- every pull failure falls back to local prefill with the same tokens;
- the TTL sweep, ``DELETE`` release and the drain gate (``idle()``);
- the router's real ``Sidecar`` in front of two port engines.
"""

import asyncio
import collections
import concurrent.futures
import dataclasses
import http.server
import json
import threading
import time
import urllib.error
import urllib.request
import uuid

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _net import free_port
from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu.engine.server import EngineServer as JaxEngineServer
from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu.router.sidecar import Sidecar, SidecarConfig
from llm_d_inference_scheduler_tpu_torch.engine import core as torch_core
from llm_d_inference_scheduler_tpu_torch.engine import kv_wire
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy

MAX_TOKENS = 6
CHUNK = 32  # prefill_chunk of every engine here: ~100-token prompts stream 4 chunks
COMMON = dict(max_batch=4, max_model_len=256, decode_chunk=4, prefill_chunk=CHUNK)


def _prompt(seed: int, n: int = 100) -> list[int]:
    """A prompt of n tokens whose first block differs per seed (no prefix
    hit between two cases)."""
    rng = np.random.default_rng(seed)
    return [1] + [int(t) for t in rng.integers(3, 450, size=n - 1)]


def _model_dir(tmp_path_factory, base, dtype):
    d = tmp_path_factory.mktemp(f"{base.name}_{dtype}")
    fields = dataclasses.asdict(base) | {"dtype": dtype}
    (d / "model_config.json").write_text(json.dumps(fields))
    return str(d)


# ---- HTTP helpers (the test thread is a client of the background loop) ----


def _request(port, path, body=None, method=None, timeout=60):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, {k.lower(): v for k, v in r.headers.items()}, r.read()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read()


def _complete(port, prompt, max_tokens=MAX_TOKENS, rid=None, ktp=None):
    body = {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0,
            "ignore_eos": True, "request_id": rid or f"r-{uuid.uuid4().hex[:8]}"}
    if ktp is not None:
        body["kv_transfer_params"] = ktp
    status, headers, raw = _request(port, "/v1/completions", body)
    assert status == 200, raw[:300]
    return headers, json.loads(raw)


class Node:
    """One engine behind its server on the shared loop, with a tap of the
    token ids it emits per request."""

    def __init__(self, loop, server):
        self.loop, self.server, self.engine = loop, server, server.engine
        self.tokens: dict[str, list[int]] = collections.defaultdict(list)
        emit = self.engine._emit

        def tap(slot, ev):
            if ev.token_id is not None:
                self.tokens[ev.request_id].append(ev.token_id)
            emit(slot, ev)

        self.engine._emit = tap
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(120)
        self.port = getattr(server, "port", None) or server.cfg.port

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(60)


def _port_node(loop, model, params, **kw):
    cfg = EngineConfig(model=model, device="cpu", port=0, **{**COMMON, **kw})
    return Node(loop, EngineServer(cfg, engine=TorchEngine(cfg, params=params)))


def _jax_node(loop, model, params, **kw):
    cfg = JaxEngineConfig(model=model, port=free_port(), kv_events_port=0,
                          kv_transfer="host", **{**COMMON, **kw})
    return Node(loop, JaxEngineServer(cfg, engine=TpuEngine(cfg, params=params)))


def _mono(node, prompt, max_tokens=MAX_TOKENS):
    rid = f"mono-{uuid.uuid4().hex[:8]}"
    _complete(node.port, prompt, max_tokens, rid=rid)
    return node.tokens[rid]


def _handoff(exporter, importer, prompt, *, chunked, max_tokens=MAX_TOKENS):
    """Drive one handoff as the sidecar does; returns (decode tokens,
    decode response headers, the exporter's kv_transfer_params or None)."""
    rid = f"d-{uuid.uuid4().hex[:8]}"
    if not chunked:
        _, r1 = _complete(exporter.port, prompt, 1,
                          ktp={"do_remote_decode": True})
        assert r1["choices"][0]["finish_reason"] == "length"
        ktp = r1["kv_transfer_params"]
        headers, _ = _complete(importer.port, prompt, max_tokens, rid=rid, ktp=ktp)
        return importer.tokens[rid], headers, ktp
    pre_rid = f"pd-{uuid.uuid4().hex[:8]}"
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        prefill = ex.submit(_complete, exporter.port, prompt, 1, rid=pre_rid,
                            ktp={"do_remote_decode": True, "stream_chunks": True})
        deadline = time.monotonic() + 60
        while True:  # the sidecar's first-chunk ack (404 until the record exists)
            status, _, _ = _request(exporter.port, f"/kv/{pre_rid}?ack=1&wait_ms=200")
            if status == 200:
                break
            assert status in (202, 404) and time.monotonic() < deadline
        headers, _ = _complete(importer.port, prompt, max_tokens, rid=rid, ktp={
            "remote_host": "127.0.0.1", "remote_port": exporter.port,
            "remote_request_id": pre_rid, "stream_chunks": True,
            "remote_scheme": "http"})
        prefill.result(60)
    return importer.tokens[rid], headers, None


def _count_released_chunks(node):
    """Record each export's staged chunk count when its importer releases
    it (the record is gone afterwards)."""
    seen = {}
    release = node.engine.release_kv_export

    def tap(rid, **kw):
        rec = node.engine.get_kv_export(rid)
        if rec is not None:
            seen[rid] = rec.get("chunks_staged", 0)
        release(rid, **kw)

    node.engine.release_kv_export = tap
    return seen


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield loop
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    model = _model_dir(tmp_path_factory, jax_configs.TINY, "float32")
    jparams = jax_llama.init_params(jax_configs.get_config(model), jax.random.key(5))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return model, jparams, tparams


@pytest.fixture(scope="module")
def nodes(loop, f32):
    """The JAX engine (prefix caching off, so its monolithic references and
    exports never share blocks), a port exporter, importer and monolith."""
    model, jparams, tparams = f32
    out = {"jax": _jax_node(loop, model, jparams, enable_prefix_caching=False),
           "port_p": _port_node(loop, model, tparams),
           "port_d": _port_node(loop, model, tparams),
           "port_m": _port_node(loop, model, tparams)}
    yield out
    for n in out.values():
        n.stop()


@pytest.mark.parametrize("chunked", [False, True], ids=["serial", "chunked"])
@pytest.mark.parametrize("exp,imp", [("port_p", "port_d"), ("jax", "port_d"),
                                     ("port_p", "jax")],
                         ids=["port-port", "jax-port", "port-jax"])
def test_handoff_token_equal_to_monolithic(nodes, exp, imp, chunked):
    seed = ["port_p port_d", "jax port_d", "port_p jax"].index(f"{exp} {imp}")
    # The JAX importer joins streamed chunks' bytes whole ([L, n, ...] after
    # [L, m, ...]), which is the [L, n + m, ...] payload only for one chunk
    # (or one layer): into the JAX engine, a one-window prompt streams one.
    one_chunk = chunked and imp == "jax"
    prompt = _prompt(10 * seed + chunked, CHUNK - 2 if one_chunk else 100)
    mono = _mono(nodes["port_m"], prompt)
    assert mono == _mono(nodes["jax"], prompt)
    assert len(mono) == MAX_TOKENS
    released = _count_released_chunks(nodes[exp])
    toks, headers, ktp = _handoff(nodes[exp], nodes[imp], prompt, chunked=chunked)
    assert toks == mono
    assert int(headers["x-kv-pull-bytes"]) > 0 and float(headers["x-kv-pull-ms"]) >= 0
    if chunked:
        assert headers["x-kv-pull-route"] == "host-chunked"
        assert float(headers["x-kv-pull-exposed-ms"]) <= float(headers["x-kv-pull-ms"])
        n_chunks = max(released.values())
        assert (n_chunks == 1) if one_chunk else (n_chunks >= 3)
    else:
        assert headers["x-kv-pull-route"] == "host"
        assert ktp["remote_seq_len"] == len(prompt)
        assert ktp["remote_port"] == nodes[exp].port
    # export released after pull; nothing left in flight on either side
    assert not nodes[exp].engine.kv_exports
    assert nodes[exp].engine.idle() and nodes[imp].engine.idle()


# ---- bf16: bytes on the wire ---------------------------------------------


def _as_numpy_bf16(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def test_bf16_wire_bytes_match_jax_server(loop, tmp_path_factory):
    """The port exporter's /kv bodies and headers (full and per chunk) equal
    what the JAX server sends for the same page values; and a payload the
    JAX engine exported in bf16 lands in the port's pages bit for bit."""
    model = _model_dir(tmp_path_factory, jax_configs.TINY, "bfloat16")
    jparams = jax_llama.init_params(jax_configs.get_config(model), jax.random.key(6))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jax_node = _jax_node(loop, model, jparams, prefill_chunk=0)
    port_p = _port_node(loop, model, tparams)
    port_d = _port_node(loop, model, tparams)
    try:
        # Port export, chunk-streamed: keep the record (no importer pulls it).
        prompt = _prompt(40)
        rid = "bf16-port"
        _complete(port_p.port, prompt, 1, rid=rid,
                  ktp={"do_remote_decode": True, "stream_chunks": True})
        rec = port_p.engine.get_kv_export(rid)
        assert rec["k"].dtype == torch.bfloat16 and rec["chunks_staged"] >= 3
        # The same page values as a JAX export record, served by the JAX server.
        jax_node.engine.kv_exports[rid] = {
            "k": jnp.asarray(_as_numpy_bf16(rec["k"])),
            "v": jnp.asarray(_as_numpy_bf16(rec["v"])),
            "chunk_data": [(_as_numpy_bf16(k), _as_numpy_bf16(v))
                           for k, v in rec["chunk_data"]],
            **{key: rec[key] for key in ("chunk_blocks", "chunks_staged",
                                         "blocks_staged", "complete", "seq_len",
                                         "num_blocks", "first_token", "created")}}
        paths = [f"/kv/{rid}"] + [f"/kv/{rid}?chunk={i}"
                                  for i in range(rec["chunks_staged"] + 1)]
        for path in paths:
            ps, ph, pbody = _request(port_p.port, path)
            js, jh, jbody = _request(jax_node.port, path)
            assert (ps, pbody) == (js, jbody), path
            kv = lambda h: {k: v for k, v in h.items() if k.startswith("x-kv-")}
            assert kv(ph) == kv(jh), path
            if ps == 200:
                assert ph["x-kv-dtype"] == "bfloat16"
        assert ps == 204  # past the last chunk
        jax_node.engine.kv_exports.pop(rid)

        # JAX bf16 export -> port import: the pages hold the payload exactly.
        prompt = _prompt(41, 40)
        _, r1 = _complete(jax_node.port, prompt, 1, ktp={"do_remote_decode": True})
        ktp = r1["kv_transfer_params"]
        _, r1_headers, payload = _request(jax_node.port,
                                          f"/kv/{ktp['remote_request_id']}")
        assert r1_headers["x-kv-dtype"] == "bfloat16"
        landed = {}
        import_into = port_d.engine._import_into_slot

        def tap(idx, pi, blocks):
            import_into(idx, pi, blocks)
            ids = torch.tensor(blocks[: ktp["remote_num_blocks"]])
            landed["k"] = port_d.engine.k_pages[:, ids].clone()
            landed["v"] = port_d.engine.v_pages[:, ids].clone()

        port_d.engine._import_into_slot = tap
        headers, resp = _complete(port_d.port, prompt, 4, ktp=ktp)
        assert headers["x-kv-pull-route"] == "host"
        assert resp["usage"]["completion_tokens"] == 4
        assert not jax_node.engine.kv_exports  # released after the pull
        n = len(payload) // 2
        nb = ktp["remote_num_blocks"]
        k_j, v_j = (np.frombuffer(payload[i * n:(i + 1) * n], ml_dtypes.bfloat16)
                    for i in (0, 1))
        shape = json.loads(r1_headers["x-kv-shape"])
        k_j = k_j.reshape(shape)[:, :nb]
        v_j = v_j.reshape(shape)[:, :nb]
        assert np.array_equal(_as_numpy_bf16(landed["k"]).view(np.int16),
                              k_j.view(np.int16))
        assert np.array_equal(_as_numpy_bf16(landed["v"]).view(np.int16),
                              v_j.view(np.int16))
    finally:
        for n in (jax_node, port_p, port_d):
            n.stop()


def test_kv_wire_codec_round_trip():
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                        (torch.float16, "float16")):
        k = torch.randn(2, 3, 16, 2, 8).to(dtype)
        v = torch.randn(2, 3, 16, 2, 8).to(dtype)
        payload = bytes(kv_wire.tensor_bytes(k)) + bytes(kv_wire.tensor_bytes(v))
        assert kv_wire.dtype_name(dtype) == name
        k2, v2 = kv_wire.decode_kv(payload, kv_wire.dtype_from_name(name), tuple(k.shape))
        assert torch.equal(k, k2) and torch.equal(v, v2)
        np_dtype = ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)
        assert bytes(kv_wire.tensor_bytes(k[:, 1:])) == np.ascontiguousarray(
            k[:, 1:].view(torch.int16).numpy().view(np_dtype)
            if name == "bfloat16" else k[:, 1:].numpy()).tobytes()
        with pytest.raises(ValueError, match="payload size"):
            kv_wire.decode_kv(payload[:-2], dtype, tuple(k.shape))


# ---- MoE ----------------------------------------------------------------


def test_moe_grouped_chunked_handoff(loop, tmp_path_factory):
    model = _model_dir(tmp_path_factory, jax_configs.TINY_MOE, "float32")
    jparams = jax_llama.init_params(jax_configs.get_config(model), jax.random.key(7))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    p, d, m = (_port_node(loop, model, tparams, grouped_moe=True) for _ in range(3))
    try:
        assert p.engine.mcfg.moe_impl == "grouped"
        prompt = _prompt(50, 80)
        toks, headers, _ = _handoff(p, d, prompt, chunked=True)
        assert headers["x-kv-pull-route"] == "host-chunked"
        assert toks == _mono(m, prompt) and len(toks) == MAX_TOKENS
    finally:
        for n in (p, d, m):
            n.stop()


# ---- failures fall back to local prefill -------------------------------------


class _FakeExporter:
    """A /kv server that answers from a script, to break the protocol on
    purpose: ``script(path) -> (status, headers, body)``."""

    def __init__(self, script):
        fake = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _answer(self):
                fake.paths.append(f"{self.command} {self.path}")
                status, headers, body = script(self.path)
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                if status != 204:
                    self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if status != 204:
                    self.wfile.write(body)

            do_GET = do_DELETE = _answer

        self.paths: list[str] = []
        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


TINY = jax_configs.TINY
L, BLOCK, HKV, DH = TINY.n_layers, TINY.kv_block_size, TINY.n_kv_heads, TINY.head_dim


def _geometry(prompt, *, hkv=HKV):
    nb = -(-len(prompt) // BLOCK)
    shape = [L, nb, BLOCK, hkv, DH]
    n = int(np.prod(shape)) * 4
    headers = {"x-kv-shape": json.dumps(shape), "x-kv-seq-len": str(len(prompt)),
               "x-kv-dtype": "float32", "x-kv-real-blocks": str(nb),
               "x-kv-num-blocks": str(nb), "x-kv-first-token": "7"}
    return headers, bytes(2 * n)


def _script(case, prompt):
    full_headers, payload = _geometry(prompt)
    chunk_headers = {"x-kv-chunk": "0", "x-kv-chunk-blocks": "2",
                     "x-kv-chunk-shape": json.dumps([L, 2, BLOCK, HKV, DH]),
                     "x-kv-dtype": "float32", "x-kv-chunks-staged": "1",
                     "x-kv-blocks-staged": "2", "x-kv-complete": "0"}

    def script(path):
        if path.startswith("/kv/") and "chunk=" not in path:
            if case == "geometry":
                h, body = _geometry(prompt, hkv=HKV + 2)
                return 200, h, body
            if case == "short-payload":
                return 200, full_headers, payload[:-64]
            return 404, {}, b"no kv export"
        if case == "stalled":
            return 202, {**chunk_headers, "x-kv-chunks-staged": "0"}, b""
        if "chunk=0" in path:  # 404-mid-stream: one chunk, then the record is gone
            return 200, chunk_headers, bytes(2 * L * 2 * BLOCK * HKV * DH * 4)
        return 404, {}, b"no kv export"

    return script


FAILURES = ["404-mid-stream", "geometry", "short-payload", "stalled", "https"]


@pytest.mark.parametrize("case", FAILURES)
def test_failed_pull_falls_back_to_local_prefill(nodes, monkeypatch, case):
    d = nodes["port_d"]
    prompt = _prompt(60 + FAILURES.index(case))
    mono = _mono(nodes["port_m"], prompt)
    fake = _FakeExporter(_script(case, prompt))
    monkeypatch.setattr(d.engine, "KV_CHUNK_STREAM_TIMEOUT_S", 0.5)
    try:
        ktp = {"remote_host": "127.0.0.1", "remote_port": fake.port,
               "remote_request_id": "gone", "remote_scheme": "http"}
        if case in ("404-mid-stream", "stalled"):
            ktp["stream_chunks"] = True
        else:
            ktp.update(remote_num_blocks=7, remote_seq_len=len(prompt),
                       remote_first_token=7)
        if case == "https":
            ktp["remote_scheme"] = "https"
        rid = f"fb-{case}"
        headers, resp = _complete(d.port, prompt, rid=rid, ktp=ktp)
        assert d.tokens[rid] == mono
        assert resp["usage"]["prompt_tokens_details"]["cached_tokens"] == 0
        # Only the geometry case completes its pull (counted, then released);
        # the others fail inside it. An https exporter is never dialled.
        pulled = case == "geometry"
        assert ("x-kv-pull-route" in headers) == pulled
        assert any(p.startswith("DELETE") for p in fake.paths) == pulled
        assert bool(fake.paths) == (case != "https")
        assert d.engine.idle()
    finally:
        fake.close()


# ---- lifecycle: TTL, release, drain gate -----------------------------------


def test_export_ttl_release_and_drain_gate(nodes, monkeypatch):
    p, d = nodes["port_p"], nodes["port_d"]
    # DELETE releases; the record then 404s.
    _, r1 = _complete(p.port, _prompt(70, 40), 1, ktp={"do_remote_decode": True})
    rid = r1["kv_transfer_params"]["remote_request_id"]
    assert not p.engine.idle()  # an export is held for a decode peer
    status, _, _ = _request(p.port, f"/kv/{rid}?chunk=5&wait_ms=20")
    assert status == 204  # serial export: complete with zero chunks
    status, _, body = _request(p.port, f"/kv/{rid}?consumed=host", method="DELETE")
    assert status == 200 and json.loads(body) == {"released": rid}
    assert _request(p.port, f"/kv/{rid}?wait_ms=30")[0] == 404
    assert p.engine.idle()

    # An unclaimed export expires after the TTL, on an otherwise idle engine.
    monkeypatch.setattr(torch_core, "KV_EXPORT_TTL_S", 0.3)
    _complete(p.port, _prompt(71, 40), 1, ktp={"do_remote_decode": True})
    assert p.engine.kv_exports and not p.engine.idle()
    deadline = time.monotonic() + 10
    while p.engine.kv_exports and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not p.engine.kv_exports and p.engine.idle()

    # A pull in flight holds the importer's gate closed until it resolves.
    gate = threading.Event()

    def script(path):
        gate.wait(10)
        return 404, {}, b"gone"

    fake = _FakeExporter(script)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(_complete, d.port, _prompt(72, 40), 3, ktp={
                "remote_host": "127.0.0.1", "remote_port": fake.port,
                "remote_request_id": "held", "stream_chunks": True})
            deadline = time.monotonic() + 10
            while not fake.paths and time.monotonic() < deadline:
                time.sleep(0.01)
            assert fake.paths and not d.engine.idle()
            gate.set()
            fut.result(60)
        assert d.engine.idle()
    finally:
        gate.set()
        fake.close()


def test_kv_routes_answer_bad_input(nodes):
    p = nodes["port_p"]
    t0 = time.monotonic()
    assert _request(p.port, "/kv/nope?chunk=0&wait_ms=50")[0] == 404
    assert time.monotonic() - t0 >= 0.05  # the wait ran before the 404
    assert _request(p.port, "/kv/nope?chunk=x")[0] == 400
    assert _request(p.port, "/kv/nope", method="PUT")[0] == 405
    status, _, body = _request(p.port, "/v1/completions", {
        "prompt": [1, 5, 6], "kv_transfer_params": "do_remote_decode"})
    assert status == 400 and b"kv_transfer_params" in body


# ---- the router's sidecar in front of two port engines ----------------------


def test_sidecar_pipelined_and_serial_arms_in_front_of_port_engines(loop, nodes):
    p, d, m = nodes["port_p"], nodes["port_d"], nodes["port_m"]
    sidecars = {}
    # Pipelined first: its prefill must run cold to stream several chunks
    # (the serial arm then prefix-hits on the prefill engine).
    for arm, pipelined in (("pipelined", True), ("serial", False)):
        sc = Sidecar(SidecarConfig(port=free_port(),
                                   decoder_url=f"http://127.0.0.1:{d.port}",
                                   ssrf_allowlist=[f"127.0.0.1:{p.port}"],
                                   pipeline_enabled=pipelined))
        asyncio.run_coroutine_threadsafe(sc.start(), loop).result(30)
        sidecars[arm] = sc
    try:
        released = _count_released_chunks(p)
        for i, prompt in enumerate((_prompt(80), _prompt(81))):
            mono = _mono(m, prompt)
            heads = {}
            for arm, sc in sidecars.items():
                rid = f"sc-{arm}-{i}"
                status, heads[arm], raw = _sidecar_post(sc, p, prompt, rid)
                assert status == 200, raw[:300]
                assert d.tokens[rid] == mono
            assert "x-kv-transfer-exposed-ms" not in heads["serial"]
            assert (float(heads["pipelined"]["x-kv-transfer-exposed-ms"])
                    <= float(heads["pipelined"]["x-kv-transfer-ms"]))
        assert max(released.values()) >= 3  # the pipelined arm streamed chunks
        assert not p.engine.kv_exports and d.engine.idle()
    finally:
        for sc in sidecars.values():
            asyncio.run_coroutine_threadsafe(sc.stop(), loop).result(30)


def _sidecar_post(sc, prefill, prompt, rid):
    data = json.dumps({"prompt": prompt, "max_tokens": MAX_TOKENS, "temperature": 0,
                       "ignore_eos": True, "request_id": rid}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{sc.cfg.port}/v1/completions", data=data,
        headers={"content-type": "application/json",
                 "x-prefiller-host-port": f"127.0.0.1:{prefill.port}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, {k.lower(): v for k, v in r.headers.items()}, r.read()
