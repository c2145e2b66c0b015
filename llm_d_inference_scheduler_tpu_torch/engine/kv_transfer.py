"""Device wire: P/D KV handoff device to device over CUDA IPC, within a node.

The H100 counterpart of the JAX engine's ``jax.experimental.transfer``
server (``llm_d_inference_scheduler_tpu/engine/core.py:87-96``):

- The exporter stages an export's page shards (``[L/pp, nb, block, Hkv/tp,
  Dh]`` K, then V) in allocations of their own (a gather out of the pages,
  never a view of them: the blocks go back to the allocator at once),
  waits for its stream, and registers them under the export's 63-bit uuid
  with this process's :class:`DeviceWireServer`.
- The server answers a uuid on a small TCP side channel with one CUDA IPC
  handle per shard (``cudaIpcGetMemHandle`` through torch's storage sharing,
  ``UntypedStorage._share_cuda_``, which also carries an interprocess event
  the opener waits on), described field by field in JSON: no code crosses
  the wire, and the opener checks every field before it opens a handle.
- The importer opens each handle (``cudaIpcOpenMemHandle``), copies device
  to device into its own pages, waits for the copy, closes the handles and
  then releases the export (``consumed="device"``). The staged tensors stay
  registered, and so alive, until that release or the export's TTL sweep.
- ``cudaIpcOpenMemHandle`` refuses a handle of its own process: an importer
  in the exporter's process (a P/D pair in one process) finds the server in
  this process's registry and copies from the staged tensors directly.

Allocations under ``expandable_segments`` do not export through IPC, so the
server refuses to start under that allocator setting (``kv_transfer
="device"`` then raises; ``"auto"`` keeps the host wire). Cross-node device
transfer (NCCL or UCX) is not here: it needs more than one node.

Side-channel protocol (the shard wire's framing, ``engine/shard_wire.py``):

    request:  8-byte big-endian uuid
    response: 4-byte count (0xFFFFFFFF = unknown uuid), then per shard:
              4-byte length, a JSON handle description (``_FIELDS``:
              byte strings in hex)

An importer dials only addresses on its own node (CUDA IPC works only
there): a numeric address that is loopback, unspecified or bound to one of
this host's interfaces. Otherwise the trust model is that of the shard wire
and ``/kv``: a trusted node network.
"""

from __future__ import annotations

import ipaddress
import json
import logging
import os
import re
import socket
import struct
import threading
from typing import Any

import torch

from .kv_wire import dtype_from_name, dtype_name
from .shard_wire import MAX_CONNS, _recv_exact, _recv_uuid

log = logging.getLogger("engine.kv_transfer")

_UUID = struct.Struct(">Q")
_U32 = struct.Struct(">I")
_UNKNOWN = 0xFFFFFFFF
_MAX_DESC = 1 << 16   # bytes of one handle description
_MAX_HANDLE = 1024    # bytes of one IPC, event or ref-counter handle
_MAX_SHARDS = 4096    # shards of one export (K and V of each local rank)
_SHM_NAME = re.compile(r"/[A-Za-z0-9_.-]{1,200}")

# A handle description: the exporter's ``UntypedStorage._share_cuda_``
# fields and the tensor's view of the storage, each with its JSON type.
_FIELDS = {"size": list, "stride": list, "offset": int, "dtype": str,
           "device": int, "handle": str, "storage_size_bytes": int,
           "storage_offset_bytes": int, "ref_counter_handle": str,
           "ref_counter_offset": int, "event_handle": (str, type(None)),
           "event_sync_required": bool}

# This process's servers by address: an importer here copies directly.
_LOCAL: dict[str, "DeviceWireServer"] = {}
_LOCAL_LOCK = threading.Lock()


def check_available(device: torch.device) -> None:
    """Raise unless the device wire can run on ``device``: a CUDA device and
    an allocator whose blocks export through IPC."""
    if device.type != "cuda":
        raise RuntimeError(f"the device wire needs a CUDA device, the engine "
                           f"runs on {device}")
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
    if "expandable_segments:true" in conf.replace(" ", "").lower():
        raise RuntimeError("PYTORCH_CUDA_ALLOC_CONF sets expandable_segments, "
                           "whose allocations do not export through CUDA IPC")


class DeviceWireServer:
    """Serves this process's staged device shards by uuid: CUDA IPC handles
    over a TCP side channel, on a daemon thread."""

    def __init__(self, host: str, device: torch.device):
        check_available(device)
        self._host = host
        self._registry: dict[int, list[torch.Tensor]] = {}
        self._lock = threading.Lock()
        self._conn_sem = threading.Semaphore(MAX_CONNS)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, 0))
        self._srv.listen(16)
        self._port = self._srv.getsockname()[1]
        self._closed = False
        self._thread = threading.Thread(target=self._serve, name="device-wire",
                                        daemon=True)
        self._thread.start()
        with _LOCAL_LOCK:
            _LOCAL[self.address()] = self

    def address(self) -> str:
        return f"{self._host}:{self._port}"

    def register(self, tuid: int, shards: list[torch.Tensor]) -> None:
        """Hold ``shards`` (staged device tensors, written: the caller has
        waited for their stream) for pulls of ``tuid``."""
        with self._lock:
            self._registry[int(tuid)] = list(shards)

    def unregister(self, tuid: int) -> None:
        with self._lock:
            self._registry.pop(int(tuid), None)

    def lookup(self, tuid: int) -> list[torch.Tensor] | None:
        with self._lock:
            return self._registry.get(int(tuid))

    def close(self) -> None:
        self._closed = True
        with _LOCAL_LOCK:
            _LOCAL.pop(self.address(), None)
        with self._lock:
            self._registry.clear()
        try:
            self._srv.close()
        except OSError:
            pass

    def _serve(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # closed
            if not self._conn_sem.acquire(timeout=30.0):
                log.warning("device wire at connection cap (%d); shedding",
                            MAX_CONNS)
                conn.close()
                continue
            threading.Thread(target=self._handle, args=(conn,),
                             name="device-wire-conn", daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(60.0)
                tuid = _recv_uuid(conn)
                if tuid is None:
                    return  # a reachability probe
                shards = self.lookup(tuid)
                if shards is None:
                    conn.sendall(_U32.pack(_UNKNOWN))
                    return
                msgs = [json.dumps(describe(t)).encode() for t in shards]
                conn.sendall(_U32.pack(len(msgs)))
                for m in msgs:
                    conn.sendall(_U32.pack(len(m)) + m)
                # Hold the connection until the peer has opened the handles
                # (it closes its end), so the export outlives the open.
                conn.recv(1)
        except Exception:
            if not self._closed:
                log.warning("device wire connection failed", exc_info=True)
        finally:
            self._conn_sem.release()


def describe(t: torch.Tensor) -> dict[str, Any]:
    """The CUDA IPC handle description of ``t`` (a CUDA tensor) that
    :func:`open_description` opens in another process of this node."""
    (device, handle, size_bytes, offset_bytes, ref_handle, ref_offset,
     event_handle, event_sync) = t.untyped_storage()._share_cuda_()
    return {"size": list(t.shape), "stride": list(t.stride()),
            "offset": t.storage_offset(), "dtype": dtype_name(t.dtype),
            "device": int(device), "handle": bytes(handle).hex(),
            "storage_size_bytes": int(size_bytes),
            "storage_offset_bytes": int(offset_bytes),
            "ref_counter_handle": bytes(ref_handle).hex(),
            "ref_counter_offset": int(ref_offset),
            "event_handle": None if event_handle is None else bytes(event_handle).hex(),
            "event_sync_required": bool(event_sync)}


def _hex(desc: dict[str, Any], key: str) -> bytes | None:
    v = desc[key]
    if v is None:
        return None
    b = bytes.fromhex(v)
    if not 0 < len(b) <= _MAX_HANDLE:
        raise ValueError(f"{key} of {len(b)} bytes")
    return b


def parse_description(raw: bytes) -> dict[str, Any]:
    """A peer's handle description, checked field by field (types, ranges,
    a shared-memory name for the ref counter); raises ValueError."""
    if len(raw) > _MAX_DESC:
        raise ValueError("handle description too long")
    try:
        desc = json.loads(raw)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"handle description is not JSON: {e}") from None
    if not isinstance(desc, dict) or set(desc) != set(_FIELDS):
        raise ValueError("handle description fields differ from the protocol's")
    for key, typ in _FIELDS.items():
        v = desc[key]
        if not isinstance(v, typ) or (typ is int and (isinstance(v, bool) or v < 0)):
            raise ValueError(f"handle description field {key}={v!r}")
    dims = desc["size"] + desc["stride"]
    if (len(desc["size"]) != len(desc["stride"]) or len(desc["size"]) > 8
            or not all(isinstance(d, int) and not isinstance(d, bool) and d >= 0
                       for d in dims)):
        raise ValueError("handle description shape")
    desc["dtype"] = dtype_from_name(desc["dtype"])
    for key in ("handle", "ref_counter_handle", "event_handle"):
        desc[key] = _hex(desc, key)
    if desc["handle"] is None or not _SHM_NAME.fullmatch(
            desc["ref_counter_handle"].decode("ascii", "replace")):
        raise ValueError("handle description names no IPC handle or ref counter")
    return desc


def open_description(desc: dict[str, Any]) -> torch.Tensor:
    """The exporter's tensor, opened through its IPC handle (a checked
    :func:`parse_description`)."""
    from torch.multiprocessing.reductions import rebuild_cuda_tensor

    if desc["device"] >= torch.cuda.device_count():
        raise ValueError(f"the exporter's device {desc['device']} is not on this node")
    return rebuild_cuda_tensor(
        torch.Tensor, torch.Size(desc["size"]), tuple(desc["stride"]), desc["offset"],
        torch.storage.TypedStorage, desc["dtype"], desc["device"], desc["handle"],
        desc["storage_size_bytes"], desc["storage_offset_bytes"], False,
        desc["ref_counter_handle"], desc["ref_counter_offset"], desc["event_handle"],
        desc["event_sync_required"])


def on_this_node(host: str) -> bool:
    """Whether ``host`` (a numeric address, or ``localhost``) is one of this
    node's: loopback, unspecified, or bound to a local interface (a bind to
    it succeeds; nothing is sent). Names are not resolved."""
    if host == "localhost":
        return True
    try:
        ip = ipaddress.ip_address(host.strip("[]"))
    except ValueError:
        return False
    if ip.is_loopback or ip.is_unspecified:
        return True
    family = socket.AF_INET6 if ip.version == 6 else socket.AF_INET
    with socket.socket(family, socket.SOCK_DGRAM) as s:
        try:
            s.bind((str(ip), 0))
        except OSError:
            return False
    return True


def stage(pages: list[torch.Tensor], ids: torch.Tensor) -> list[torch.Tensor]:
    """Each page tensor's blocks ``ids`` (on its device) gathered into an
    allocation of its own, written when this returns."""
    out = [p[:, ids.to(p.device)] for p in pages]
    for dev in {t.device for t in out if t.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()
    return out


def pull(address: str, tuid: int, timeout: float = 60.0):
    """The shards staged under ``tuid`` at ``address``, as device tensors
    aliasing the exporter's memory: ``(shards, done)``. Copy out of them,
    then call ``done()`` (after the copy has finished on the device), which
    closes the IPC handles. An exporter in this process hands its staged
    tensors over directly."""
    with _LOCAL_LOCK:
        local = _LOCAL.get(address)
    if local is not None:
        shards = local.lookup(tuid)
        if shards is None:
            raise KeyError(f"uuid {tuid} not staged at {address}")
        return list(shards), lambda: None
    host, _, port = address.rpartition(":")
    if not on_this_node(host):
        raise ValueError(f"device wire address {address} is not on this node")
    conn = socket.create_connection((host, int(port)), timeout=timeout)
    try:
        conn.settimeout(timeout)
        conn.sendall(_UUID.pack(int(tuid)))
        (count,) = _U32.unpack(_recv_exact(conn, _U32.size))
        if count == _UNKNOWN:
            raise KeyError(f"uuid {tuid} not staged at {address}")
        if count > _MAX_SHARDS:
            raise ValueError(f"{count} shards offered")
        descs = []
        for _ in range(count):
            (n,) = _U32.unpack(_recv_exact(conn, _U32.size))
            if n > _MAX_DESC:
                raise ValueError(f"handle description of {n} bytes")
            descs.append(parse_description(bytes(_recv_exact(conn, n))))
        shards: list[Any] = [open_description(d) for d in descs]
    except BaseException:
        conn.close()
        raise

    def done() -> None:
        shards.clear()  # drops the aliases: the IPC handles close
        conn.close()

    return shards, done
