"""The ``/kv`` handoff wire: page tensors to the bytes the JAX engine server
sends, and back, plus the blocking HTTP client the importer pulls with.

A KV payload is K then V, each ``[L, n_blocks, block, Hkv, Dh]`` in the
pages' dtype, raw little-endian elements (``server.py`` of the JAX package
sends ``k.tobytes() + v.tobytes()``). ``x-kv-dtype`` names the element type
as numpy and ``ml_dtypes`` do (``bfloat16``, ``float32``, ``float16``), never
as torch does. bf16 goes through a byte view and ``torch.frombuffer``: no
numpy bf16 dtype is needed on either side.

The client is ``http.client`` (no HTTP package beyond the standard library):
one keep-alive connection per pull, so a chunk long-poll does not open a TCP
connection per poll; over TLS when the exporter serves ``https`` (the
context carries the engine's client policy, ``utils/tls.client_verify``).
"""

from __future__ import annotations

import http.client
import ssl
import urllib.parse

import torch

_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.float16: "float16"}
_DTYPES = {v: k for k, v in _NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The ``x-kv-dtype`` header value for a page dtype."""
    return _NAMES[dtype]


def dtype_from_name(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported kv dtype {name!r}; have {sorted(_DTYPES)}")


def tensor_bytes(t: torch.Tensor) -> memoryview:
    """The raw elements of a host tensor, C order, without a copy when the
    tensor is contiguous (the view keeps the tensor's memory alive)."""
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    return memoryview(flat.numpy())


def decode_kv(payload: bytes | bytearray, dtype: torch.dtype,
              shape: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """K and V host tensors of ``shape`` from a K-then-V payload; raises
    ValueError when the payload is not exactly that size."""
    n = 1
    for d in shape:
        n *= int(d)
    itemsize = torch.empty((), dtype=dtype).element_size()
    expected = 2 * n * itemsize
    if len(payload) != expected:
        raise ValueError(f"kv payload size {len(payload)} != expected {expected}")
    buf = payload if isinstance(payload, bytearray) else bytearray(payload)
    flat = torch.frombuffer(buf, dtype=dtype)
    return flat[:n].reshape(shape), flat[n:].reshape(shape)


class KvClient:
    """Blocking keep-alive client for one exporter's ``/kv`` routes (TLS
    with ``context``).

    ``get`` returns (status, lower-cased headers, body); 200, 202 and 204 are
    answers of the protocol, any other status raises ``KvHTTPError``."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 context: ssl.SSLContext | None = None):
        if context is not None:
            self.conn = http.client.HTTPSConnection(host, int(port), timeout=timeout,
                                                    context=context)
        else:
            self.conn = http.client.HTTPConnection(host, int(port), timeout=timeout)

    def __enter__(self) -> "KvClient":
        return self

    def __exit__(self, *exc) -> None:
        self.conn.close()

    def _call(self, method: str, path: str) -> tuple[int, dict[str, str], bytearray]:
        self.conn.request(method, path)
        r = self.conn.getresponse()
        headers = {k.lower(): v for k, v in r.getheaders()}
        size = r.length
        if size is None:
            body = bytearray(r.read())
        else:
            body = bytearray(size)
            view, got = memoryview(body), 0
            while got < size:
                n = r.readinto(view[got:])
                if not n:
                    raise http.client.IncompleteRead(bytes(body[:got]), size - got)
                got += n
            r.read()  # end of the response: the connection is reusable
        if r.status not in (200, 202, 204):
            raise KvHTTPError(f"{method} {path}: HTTP {r.status} {bytes(body[:200])!r}")
        return r.status, headers, body

    def get(self, path: str, **params) -> tuple[int, dict[str, str], bytearray]:
        if params:
            path = f"{path}?{urllib.parse.urlencode(params)}"
        return self._call("GET", path)

    def delete(self, path: str) -> None:
        self._call("DELETE", path)


class KvHTTPError(Exception):
    """A ``/kv`` answer outside the protocol (a 404 for a gone export)."""
