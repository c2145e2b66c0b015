"""PyTorch port, TLS serving and the TLS client legs.

In-process servers (TINY on the CPU), certificates minted in the test with
the ``cryptography`` package (skipped without it, as ``tests/test_tls.py``
is):

- the port's self-signed certificate has the JAX one's shape;
- ``--secure-serving --cert-path`` serves https (with ``--tp-size 2`` too,
  from the server's own parser), a bad path fails before the engine starts,
  a self-signed engine serves without a path, and a rotated certificate
  reaches new connections (``--enable-cert-reload``);
- the router's unchanged gateway routes to a TLS port engine;
- a decode engine pulls ``/kv`` from an ``https`` prefill engine, with
  skip-verify and with ``--client-ca-cert`` (tokens equal to monolithic
  serving), and falls back to local prefill when the certificate does not
  verify; an ``https`` ``/ec`` source is pulled under the same policy;
- ``client_verify`` gives the JAX version's policy as an ``SSLContext``.
"""

import asyncio
import json
import ssl
import threading
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest

from _net import free_port
from llm_d_inference_scheduler_tpu.router import tlsutil as jax_tls
from llm_d_inference_scheduler_tpu.router.gateway import build_gateway
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer, parse_config
from llm_d_inference_scheduler_tpu_torch.utils import tls

PROMPT = [1] + list(range(40, 100))   # 61 tokens: 3 full blocks


def _cert_dir(path, cn="engine-one"):
    pytest.importorskip("cryptography")
    path.mkdir(parents=True, exist_ok=True)
    crt, key = tls.create_self_signed_cert(common_name=cn)
    (path / "tls.crt").write_bytes(crt)
    (path / "tls.key").write_bytes(key)
    return path


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


def _server(loop, argv=()):
    """A port server from the parser's config (CPU, free port), started."""
    cfg, _ = parse_config(["--device", "cpu", "--port", "0", "--max-batch", "4",
                           "--max-model-len", "128", "--decode-chunk", "4",
                           "--kv-events-port", "0", *argv])
    srv = EngineServer(cfg)
    _run(loop, srv.start())
    return srv


def _call(url, body=None, context=None, timeout=60):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data,
                                 headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout, context=context) as r:
            return r.status, {k.lower(): v for k, v in r.headers.items()}, r.read()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read()


def _trust(cert_dir):
    return ssl.create_default_context(cafile=str(cert_dir / "tls.crt"))


def _tap(engine):
    tokens: dict[str, list[int]] = {}
    emit = engine._emit

    def tap(slot, ev):
        if ev.token_id is not None:
            tokens.setdefault(ev.request_id, []).append(ev.token_id)
        emit(slot, ev)

    engine._emit = tap
    return tokens


# ---- certificates and the client policy --------------------------------------


def test_self_signed_certificate_shape():
    pytest.importorskip("cryptography")
    from cryptography import x509
    from cryptography.x509.oid import ExtendedKeyUsageOID

    cert_pem, key_pem = tls.create_self_signed_cert()
    cert = x509.load_pem_x509_certificate(cert_pem)
    ref = x509.load_pem_x509_certificate(jax_tls.create_self_signed_cert()[0])
    assert cert.subject == ref.subject
    eku = cert.extensions.get_extension_for_class(x509.ExtendedKeyUsage)
    assert ExtendedKeyUsageOID.SERVER_AUTH in eku.value
    ku = cert.extensions.get_extension_for_class(x509.KeyUsage).value
    assert ku.digital_signature and ku.key_encipherment
    assert (cert.not_valid_after_utc - cert.not_valid_before_utc).days >= 3649
    san = cert.extensions.get_extension_for_class(x509.SubjectAlternativeName).value
    assert san.get_values_for_type(x509.DNSName) == \
        ref.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value.get_values_for_type(x509.DNSName)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(*_write_pair(cert_pem, key_pem))


def _write_pair(cert_pem, key_pem):
    import tempfile

    d = tempfile.mkdtemp()
    crt, key = f"{d}/tls.crt", f"{d}/tls.key"
    open(crt, "wb").write(cert_pem)
    open(key, "wb").write(key_pem)
    return crt, key


def test_client_verify_policy_equals_the_jax_one(tmp_path):
    ca = _cert_dir(tmp_path / "ca") / "tls.crt"
    skip = tls.client_verify(True)
    assert (skip.verify_mode, skip.check_hostname) == (ssl.CERT_NONE, False)
    ref = jax_tls.client_verify(True)
    assert (ref.verify_mode, ref.check_hostname) == (ssl.CERT_NONE, False)
    # A CA bundle takes precedence over skip-verify, in both.
    for mine, theirs in ((tls.client_verify(True, str(ca)), jax_tls.client_verify(True, str(ca))),
                         (tls.client_verify(False, str(ca)), jax_tls.client_verify(False, str(ca)))):
        assert (mine.verify_mode, mine.check_hostname) == \
               (theirs.verify_mode, theirs.check_hostname) == (ssl.CERT_REQUIRED, True)
    stock = tls.client_verify(False)
    assert jax_tls.client_verify(False) is True  # httpx's stock verification
    assert (stock.verify_mode, stock.check_hostname) == (ssl.CERT_REQUIRED, True)


def test_self_signed_without_cryptography_names_cert_path(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_crypto(name, *a, **kw):
        if name.startswith("cryptography"):
            raise ImportError("no cryptography here")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_crypto)
    with pytest.raises(RuntimeError, match="--cert-path"):
        tls.TlsServing(None)


# ---- serving -------------------------------------------------------------------


def test_parser_starts_a_tp2_tls_engine_and_a_decode_engine(loop, tmp_path):
    """The chart's arguments: ``--tp-size=2 --secure-serving --cert-path``
    and ``--tp-size=1 --role=decode --warmup`` both start and answer
    /health; the TLS engine serves https only."""
    certs = _cert_dir(tmp_path / "certs")
    srv = _server(loop, ["--model", "tiny", "--tp-size=2", "--secure-serving",
                         "--cert-path", str(certs)])
    dec = _server(loop, ["--model", "tiny", "--tp-size=1", "--role=decode", "--warmup"])
    try:
        assert srv.engine.layout.tp == 2 and dec.engine.layout is None
        base = f"https://127.0.0.1:{srv.port}"
        status, _, raw = _call(base + "/health", context=_trust(certs))
        assert (status, json.loads(raw)["status"]) == (200, "ok")
        status, _, raw = _call(base + "/v1/completions", {
            "prompt": "hello", "max_tokens": 4, "temperature": 0}, context=_trust(certs))
        assert status == 200 and json.loads(raw)["choices"][0]["text"]
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            _call(f"http://127.0.0.1:{srv.port}/health", timeout=5)
        for _ in range(200):
            status, _, raw = _call(f"http://127.0.0.1:{dec.port}/health")
            if status == 200:
                break
            threading.Event().wait(0.05)
        assert json.loads(raw) | {"engine_id": None} == {
            "status": "ok", "engine_id": None, "model": "tiny", "role": "decode"}
    finally:
        _run(loop, srv.stop())
        _run(loop, dec.stop())


def test_bad_cert_path_fails_before_the_engine_starts(loop, tmp_path):
    cfg, _ = parse_config(["--device", "cpu", "--port", "0", "--secure-serving",
                           "--cert-path", str(tmp_path / "missing")])
    srv = EngineServer(cfg)
    started = []
    srv.engine.start = lambda: started.append(1)
    with pytest.raises(OSError):
        _run(loop, srv.start())
    assert not started and srv._server is None


def test_self_signed_serving(loop):
    pytest.importorskip("cryptography")
    srv = _server(loop, ["--secure-serving"])
    try:
        status, _, _ = _call(f"https://127.0.0.1:{srv.port}/health",
                             context=tls.client_verify(True))
        assert status == 200
    finally:
        _run(loop, srv.stop())


def test_cert_reload(loop, tmp_path):
    """Rotating tls.crt/tls.key reaches new handshakes without a restart."""
    from cryptography import x509

    certs = _cert_dir(tmp_path / "certs", cn="gen-one")
    srv = _server(loop, ["--secure-serving", "--cert-path", str(certs),
                         "--enable-cert-reload"])

    def served_cn() -> str:
        raw = ssl.get_server_certificate(("127.0.0.1", srv.port))
        cert = x509.load_pem_x509_certificate(raw.encode())
        return cert.subject.get_attributes_for_oid(x509.NameOID.COMMON_NAME)[0].value

    try:
        assert served_cn() == "gen-one"
        _cert_dir(certs, cn="gen-two")
        for _ in range(100):  # poll(1 s) + settle (one tick)
            threading.Event().wait(0.2)
            if served_cn() == "gen-two":
                break
        else:
            raise AssertionError("certificate never reloaded")
    finally:
        _run(loop, srv.stop())


def test_gateway_routes_to_tls_port_engine(loop):
    """A pool endpoint declared ``scheme: https`` is scraped and proxied
    over TLS with skip-verify: the router is unchanged."""
    pytest.importorskip("cryptography")
    import httpx

    eng = _server(loop, ["--secure-serving"])
    gw_port = free_port()
    gw = build_gateway(f"""
pool:
  endpoints:
    - {{address: 127.0.0.1, port: {eng.port}, scheme: https}}
plugins:
  - {{type: queue-scorer}}
schedulingProfiles:
  - name: default
    plugins:
      - {{pluginRef: queue-scorer}}
""", port=gw_port, poll_interval=0.02)

    async def body():
        await gw.start()
        try:
            async with httpx.AsyncClient(timeout=30) as c:
                r = await c.post(f"http://127.0.0.1:{gw_port}/v1/completions",
                                 json={"model": "tiny", "prompt": "hello",
                                       "max_tokens": 4})
                assert r.status_code == 200, r.text
                assert r.json()["choices"][0]["text"]
            ep = gw.datastore.endpoint_list()[0]
            for _ in range(100):
                if ep.metrics.fresh:
                    break
                await asyncio.sleep(0.05)
            assert ep.metrics.fresh
        finally:
            await gw.stop()

    try:
        _run(loop, body())
    finally:
        _run(loop, eng.stop())


# ---- the client legs ---------------------------------------------------------------


@pytest.mark.parametrize("policy", ["skip-verify", "ca-cert", "verify-fails"])
def test_decode_pulls_kv_from_an_https_prefill_engine(loop, tmp_path, policy):
    """The prefill engine serves TLS, so its ``kv_transfer_params`` name
    ``https``; the decode engine pulls over TLS under its client policy and
    gives the monolithic tokens. A certificate that does not verify (the
    system trust store against a self-signed one) falls back to local
    prefill, with the same tokens and no pull."""
    certs = _cert_dir(tmp_path / "certs")
    argv = {"skip-verify": [], "ca-cert": ["--client-ca-cert", str(certs / "tls.crt")],
            "verify-fails": ["--client-verify"]}[policy]
    pre = _server(loop, ["--secure-serving", "--cert-path", str(certs)])
    dec = _server(loop, argv)
    mono = _server(loop)
    taps = {"dec": _tap(dec.engine), "mono": _tap(mono.engine)}
    try:
        body = {"prompt": PROMPT, "max_tokens": 6, "temperature": 0, "ignore_eos": True}
        _call(f"http://127.0.0.1:{mono.port}/v1/completions", {**body, "request_id": "m"})
        status, _, raw = _call(f"https://127.0.0.1:{pre.port}/v1/completions", {
            **body, "max_tokens": 1, "request_id": f"p-{uuid.uuid4().hex[:6]}",
            "kv_transfer_params": {"do_remote_decode": True}}, context=_trust(certs))
        assert status == 200
        ktp = json.loads(raw)["kv_transfer_params"]
        assert ktp["remote_scheme"] == "https"
        status, headers, _ = _call(f"http://127.0.0.1:{dec.port}/v1/completions", {
            **body, "request_id": "d", "kv_transfer_params": ktp})
        assert status == 200
        assert taps["dec"]["d"] == taps["mono"]["m"]
        if policy == "verify-fails":
            assert "x-kv-pull-route" not in headers
        else:
            assert headers["x-kv-pull-route"] == "host"
            assert int(headers["x-kv-pull-bytes"]) > 0
            assert pre.engine.get_kv_export(ktp["remote_request_id"]) is None  # released
    finally:
        for s in (pre, dec, mono):
            _run(loop, s.stop())


def test_ec_pull_from_an_https_encoder(loop, tmp_path):
    """An ``https`` ``/ec`` source is pulled under the client policy: the
    rows equal the encoder's staged ones with skip-verify and with the CA
    bundle, and a source that does not verify is skipped."""
    certs = _cert_dir(tmp_path / "certs")
    enc = _server(loop, ["--secure-serving", "--cert-path", str(certs), "--role", "encode"])
    servers = {"skip": _server(loop), "ca": _server(loop, ["--client-ca-cert",
                                                           str(certs / "tls.crt")]),
               "verify": _server(loop, ["--client-verify"])}
    try:
        rng = np.random.default_rng(0)
        item = {"pixels": rng.normal(size=(8, 8, 3)).tolist()}
        status, _, _ = _call(f"https://127.0.0.1:{enc.port}/v1/encode",
                             {"request_id": "e1", "items": [item]}, context=_trust(certs))
        assert status == 200
        rows = enc.ec_store["e1"]["embeds"]
        body = {"request_id": "e1", "ec_sources": [f"https://127.0.0.1:{enc.port}"]}
        for name, srv in servers.items():
            _, mm, _ = _run(loop, srv._resolve_multimodal(body, [7]))
            if name == "verify":
                assert mm is None
            else:
                np.testing.assert_array_equal(mm, rows)
    finally:
        for s in (enc, *servers.values()):
            _run(loop, s.stop())
