"""Host-staged shard wire: per-process TCP transport for sharded KV handoff.

Port of ``llm_d_inference_scheduler_tpu/engine/shard_wire.py`` with the same
bytes on the wire, so a port process pulls from a JAX server and the other
way round:

    request:  8-byte big-endian uuid
    response: 4-byte count (0xFFFFFFFF = unknown uuid), then per shard:
              4-byte header length, header JSON {"dtype", "shape"},
              8-byte payload length, raw array bytes (C order)

Dtype names are numpy's and ``ml_dtypes``' (``float32``, ``bfloat16``), as
``kv_wire.dtype_name`` gives them. One small TCP server thread per process
serves that process's staged shard list by uuid; shards stay on the device
as they were staged and are copied to the host only when a peer pulls (one
D2H per shard at pull time). A multi-process engine group uses this wire
between groups when ``kv_wire`` resolves to ``host`` (``EngineConfig``).

Trust model (the JAX module's): the wire serves staged KV to any peer that
presents a valid 63-bit uuid, like the engine's HTTP ``/kv`` route and the
device wire; uuids are random with a TTL-swept registration, the server
binds the engine's configured host, and concurrent connections are capped
(``MAX_CONNS``).
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
from typing import Any

import torch

from .kv_wire import dtype_from_name, dtype_name, tensor_bytes

log = logging.getLogger("engine.shard_wire")

_UUID = struct.Struct(">Q")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_UNKNOWN = 0xFFFFFFFF

# Concurrent-transfer cap: P/D fan-in is bounded by the decode group size
# (each importer process opens one connection per pull).
MAX_CONNS = 32


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("shard wire peer closed")
        got += k
    return buf


def _recv_uuid(sock: socket.socket) -> int | None:
    """A request's uuid, or None when the peer closed before sending a byte
    (a reachability probe: the engine's preflight connects and closes)."""
    first = sock.recv(1)
    if not first:
        return None
    return _UUID.unpack(bytes(first) + bytes(_recv_exact(sock, _UUID.size - 1)))[0]


class ShardWireServer:
    """Serves this process's staged shards by uuid on a daemon thread."""

    def __init__(self, host: str):
        self._host = host
        self._registry: dict[int, list[Any]] = {}
        self._lock = threading.Lock()
        self._conn_sem = threading.Semaphore(MAX_CONNS)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, 0))
        self._srv.listen(16)
        self._port = self._srv.getsockname()[1]
        self._closed = False
        self._thread = threading.Thread(target=self._serve, name="shard-wire",
                                        daemon=True)
        self._thread.start()

    def address(self) -> str:
        return f"{self._host}:{self._port}"

    def register(self, tuid: int, shards: list[torch.Tensor]) -> None:
        with self._lock:
            self._registry[int(tuid)] = list(shards)

    def unregister(self, tuid: int) -> None:
        with self._lock:
            self._registry.pop(int(tuid), None)

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass

    # ---- server loop ----------------------------------------------------

    def _serve(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # closed
            if not self._conn_sem.acquire(timeout=30.0):
                log.warning("shard wire at connection cap (%d); shedding",
                            MAX_CONNS)
                conn.close()
                continue
            threading.Thread(target=self._handle, args=(conn,),
                             name="shard-wire-conn", daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(60.0)
                tuid = _recv_uuid(conn)
                if tuid is None:
                    return
                with self._lock:
                    shards = self._registry.get(tuid)
                if shards is None:
                    conn.sendall(_U32.pack(_UNKNOWN))
                    return
                conn.sendall(_U32.pack(len(shards)))
                for t in shards:
                    # D2H at pull time: staged shards stay on the device
                    # until a peer wants the bytes.
                    payload = tensor_bytes(t.cpu())
                    hdr = json.dumps({"dtype": dtype_name(t.dtype),
                                      "shape": list(t.shape)}).encode()
                    conn.sendall(_U32.pack(len(hdr)) + hdr
                                 + _U64.pack(payload.nbytes))
                    conn.sendall(payload)
        except Exception:
            if not self._closed:
                log.debug("shard wire connection failed", exc_info=True)
        finally:
            self._conn_sem.release()


def pull_shards(address: str, tuid: int,
                timeout: float = 120.0) -> list[torch.Tensor]:
    """Fetch the shard list registered under ``tuid`` at ``address`` as
    host tensors."""
    host, _, port = address.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=timeout) as conn:
        conn.settimeout(timeout)
        conn.sendall(_UUID.pack(int(tuid)))
        (count,) = _U32.unpack(_recv_exact(conn, _U32.size))
        if count == _UNKNOWN:
            raise KeyError(f"uuid {tuid} not staged at {address}")
        out: list[torch.Tensor] = []
        for _ in range(count):
            (hl,) = _U32.unpack(_recv_exact(conn, _U32.size))
            hdr = json.loads(bytes(_recv_exact(conn, hl)))
            (pl,) = _U64.unpack(_recv_exact(conn, _U64.size))
            data = _recv_exact(conn, pl)
            dtype = dtype_from_name(hdr["dtype"])
            shape = [int(d) for d in hdr["shape"]]
            out.append(torch.frombuffer(data, dtype=dtype).reshape(shape)
                       if pl else torch.empty(shape, dtype=dtype))
        return out
