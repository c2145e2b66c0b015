"""TLS for the engine: a self-signed certificate, serving from a cert
directory with live reload, and the client legs' verification policy.

The port's copy of ``create_self_signed_cert``, ``TlsServing`` and
``client_verify`` (``llm_d_inference_scheduler_tpu/router/tlsutil.py``),
without the gRPC credentials, which the engine does not use:

- with a cert path, ``<path>/tls.crt`` and ``<path>/tls.key`` are loaded
  (the mount layout of a kubernetes.io/tls Secret); a bad path fails here,
  before the engine loads anything;
- without one, a process-local self-signed certificate is minted (10-year
  validity, serverAuth EKU, SANs for localhost). That needs the
  ``cryptography`` package, imported only then; where it is missing,
  ``--cert-path`` is the way to serve TLS, and the error says so;
- with reload, a 1 s mtime poll re-reads the pair into the live context
  once both files have settled: new handshakes get the new certificate,
  established connections keep theirs;
- ``client_verify`` gives the ``ssl.SSLContext`` of a client leg
  (``http.client``): a CA bundle, which takes precedence over skip-verify,
  else skip-verify, else the system trust store.
"""

from __future__ import annotations

import datetime
import logging
import os
import ssl
import tempfile
import threading

log = logging.getLogger("engine.torch.tls")

CERT_FILE = "tls.crt"
KEY_FILE = "tls.key"
_RELOAD_POLL_S = 1.0


def create_self_signed_cert(common_name: str = "llm-d-tpu",
                            org: str = "Inference Ext") -> tuple[bytes, bytes]:
    """A self-signed server certificate and its key, PEM: 10-year validity,
    digitalSignature + keyEncipherment, serverAuth EKU, SANs localhost,
    ``common_name`` and 127.0.0.1."""
    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID
    except ImportError as e:
        raise RuntimeError(
            "a self-signed certificate needs the 'cryptography' package, which "
            "is not installed: pass --cert-path DIR with tls.crt and tls.key") from e
    import ipaddress

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([
        x509.NameAttribute(NameOID.ORGANIZATION_NAME, org),
        x509.NameAttribute(NameOID.COMMON_NAME, common_name),
    ])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=3650))
        .add_extension(x509.KeyUsage(
            digital_signature=True, key_encipherment=True,
            content_commitment=False, data_encipherment=False,
            key_agreement=False, key_cert_sign=False, crl_sign=False,
            encipher_only=False, decipher_only=False), critical=True)
        .add_extension(x509.ExtendedKeyUsage(
            [ExtendedKeyUsageOID.SERVER_AUTH]), critical=False)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                       critical=True)
        .add_extension(x509.SubjectAlternativeName([
            x509.DNSName("localhost"),
            x509.DNSName(common_name),
            x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
        ]), critical=False)
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(serialization.Encoding.PEM,
                                serialization.PrivateFormat.PKCS8,
                                serialization.NoEncryption())
    return cert_pem, key_pem


class TlsServing:
    """One serving identity (a cert directory or a self-signed pair) and its
    server ``ssl.SSLContext``, optionally reloaded on rotation."""

    def __init__(self, cert_path: str | None = None, enable_reload: bool = False,
                 common_name: str = "llm-d-tpu"):
        self.cert_path = cert_path or None
        # Reload needs real files to watch.
        self.enable_reload = bool(enable_reload and cert_path)
        self._tmpdir: tempfile.TemporaryDirectory | None = None
        if self.cert_path:
            self._crt = os.path.join(self.cert_path, CERT_FILE)
            self._key = os.path.join(self.cert_path, KEY_FILE)
        else:
            cert_pem, key_pem = create_self_signed_cert(common_name)
            self._tmpdir = tempfile.TemporaryDirectory(prefix="llmd-tls-")
            self._crt = os.path.join(self._tmpdir.name, CERT_FILE)
            self._key = os.path.join(self._tmpdir.name, KEY_FILE)
            with open(self._crt, "wb") as f:
                f.write(cert_pem)
            with open(self._key, "wb") as f:
                f.write(key_pem)
            log.info("TLS: using a self-signed certificate (no cert path)")
        self._ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        self._ctx.load_cert_chain(self._crt, self._key)
        self._mtimes = self._stat()
        self._stop = threading.Event()
        self._watcher: threading.Thread | None = None
        if self.enable_reload:
            self._watcher = threading.Thread(target=self._watch, name="cert-reload",
                                             daemon=True)
            self._watcher.start()

    @property
    def ssl_context(self) -> ssl.SSLContext:
        return self._ctx

    def cert_pem(self) -> bytes:
        with open(self._crt, "rb") as f:
            return f.read()

    def _stat(self):
        try:
            return (os.stat(self._crt).st_mtime_ns, os.stat(self._key).st_mtime_ns)
        except OSError:
            return None

    def _watch(self):
        # A rotation writes two files: reload once both have settled (one
        # poll without a change after a change).
        pending = False
        while not self._stop.wait(_RELOAD_POLL_S):
            now = self._stat()
            if now is None or now == self._mtimes:
                if pending:
                    try:
                        self._ctx.load_cert_chain(self._crt, self._key)
                        self._mtimes = self._stat()
                        pending = False
                        log.info("TLS: reloaded certificate from %s", self.cert_path)
                    except Exception as e:
                        # A partial write mid-rotation: retry next tick.
                        log.warning("TLS reload failed (will retry): %s", e)
                continue
            self._mtimes = now
            pending = True

    def close(self):
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=3)
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None


def client_verify(insecure_skip_verify: bool = False,
                  ca_cert_path: str | None = None) -> ssl.SSLContext:
    """The ``ssl.SSLContext`` of a client leg: verification against a CA
    bundle when one is given (it takes precedence over the skip flag, whose
    default is on: an operator setting only a CA means "verify against
    it"), no verification when skipped, else the system trust store."""
    if ca_cert_path:
        return ssl.create_default_context(cafile=ca_cert_path)
    if insecure_skip_verify:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    return ssl.create_default_context()
