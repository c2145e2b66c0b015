"""PyTorch port, the device wire (``engine/kv_transfer.py``): analogues of
the JAX ``tests/test_kv_device_transfer.py:71-206``.

On the CPU, the device wire runs its in-process leg (an importer in the
exporter's process copies from the staged tensors directly; the
availability check, which asks for a CUDA device, is patched out), so the
engine's routing shows here:

- a port exporter advertises the wire under the port's keys
  (``kv_wire_device``, ``transfer_uuid``, ``kv_shape``, ``kv_dtype``,
  ``kv_mesh``), never the JAX ``transfer_address``/``transfer_shards``; the
  importer pulls over it (``x-kv-pull-route: device``), its pages equal the
  exporter's host-staged /kv copy bitwise, the tokens equal monolithic
  serving and the release (``consumed=device``) drops the export;
- ``kv_transfer="host"`` keeps the /kv path; a failed pull and a page
  geometry mismatch fall back to it;
- interop: a JAX importer (its own transfer server up) given a port export
  takes /kv at once and never tries a device pull; a port importer given a
  JAX export's device keys ignores them and takes /kv;
- the wire refuses to start without a CUDA device or under
  ``expandable_segments``.

The cases that need the card (the CUDA IPC pull across two processes, a
P/D pair of engines on the card in one process) are in
``tests/test_torch_kv_device_cuda.py``, which imports no JAX: the card's
machine has none.
"""

import json

import numpy as np
import pytest
import torch

from _net import free_port
from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu.engine.server import EngineServer as JaxEngineServer
from llm_d_inference_scheduler_tpu_torch.engine import kv_transfer
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from test_torch_multihost import weights  # noqa: F401 (fixture)
from test_torch_pd import COMMON, Node, _complete, _port_node, loop  # noqa: F401

PROMPT = [1] + [(i * 11) % 400 + 3 for i in range(40)]
N_GEN = 6


@pytest.fixture
def cpu_device_wire(monkeypatch):
    monkeypatch.setattr(kv_transfer, "check_available", lambda device: None)


@pytest.fixture(scope="module")
def mono(loop, weights):  # noqa: F811
    model, _, tparams = weights
    node = _port_node(loop, model, tparams, kv_transfer="host")
    _complete(node.port, PROMPT, N_GEN, rid="mono")
    yield node.tokens["mono"]
    node.stop()


def _pd(loop, weights, pre_kw, dec_kw, mutate=None):  # noqa: F811
    model, _, tparams = weights
    pre = _port_node(loop, model, tparams, **pre_kw)
    dec = _port_node(loop, model, tparams, **dec_kw)
    try:
        staged = {}
        stage = pre.engine._op_stage_kv

        def tap(**kw):
            rec = stage(**kw)
            staged["k"], staged["v"] = rec.get("k"), rec.get("v")
            return rec

        pre.engine._op_stage_kv = tap
        _, r1 = _complete(pre.port, PROMPT, 1, ktp={"do_remote_decode": True})
        ktp = r1["kv_transfer_params"]
        headers, _ = _complete(dec.port, PROMPT, N_GEN, rid="dec",
                               ktp=mutate(ktp) if mutate else ktp)
        return ktp, headers, dec.tokens["dec"], pre, dec, staged
    finally:
        pre.stop()
        dec.stop()


def test_device_path_used_and_matches_monolithic(loop, weights, mono, cpu_device_wire):  # noqa: F811
    imported = {}
    copy = TorchEngine._copy_shards

    def tap(self, shards, blocks, shape):
        imported["blocks"] = np.array(blocks)
        copy(self, shards, blocks, shape)
        imported["k"] = self.k_pages[:, torch.from_numpy(blocks).long()].clone()

    TorchEngine._copy_shards = tap
    try:
        ktp, headers, toks, pre, dec, staged = _pd(
            loop, weights, dict(kv_transfer="device"), dict(kv_transfer="device"))
    finally:
        TorchEngine._copy_shards = copy
    assert ktp["kv_wire_device"] == [pre.engine.kv_device_wire.address()]
    assert ktp["kv_shape"][2] == 16 and ktp["kv_dtype"] == "float32"
    assert ktp["kv_mesh"] is None and isinstance(ktp["transfer_uuid"], int)
    assert "transfer_address" not in ktp and "transfer_shards" not in ktp
    assert headers["x-kv-pull-route"] == "device"
    assert (dec.engine.kv_import_device_count, dec.engine.kv_import_host_count) == (1, 0)
    assert toks == mono
    # The device-imported pages are the /kv host route's bytes.
    n = len(imported["blocks"])
    assert torch.equal(imported["k"], staged["k"][:, :n])
    assert not pre.engine.kv_exports  # released (consumed=device)
    assert pre.engine.kv_device_wire is not None
    assert pre.engine.kv_device_wire.lookup(ktp["transfer_uuid"]) is None


def test_host_path_when_transfer_disabled(loop, weights, mono, cpu_device_wire):  # noqa: F811
    ktp, headers, toks, pre, dec, _ = _pd(loop, weights, dict(kv_transfer="host"),
                                          dict(kv_transfer="host"))
    assert pre.engine.kv_device_wire is None
    assert "kv_wire_device" not in ktp and "transfer_uuid" not in ktp
    assert headers["x-kv-pull-route"] == "host"
    assert (dec.engine.kv_import_device_count, dec.engine.kv_import_host_count) == (0, 1)
    assert toks == mono


def test_device_pull_failure_falls_back_to_http(loop, weights, mono, cpu_device_wire):  # noqa: F811
    ktp, headers, toks, _, dec, _ = _pd(
        loop, weights, dict(kv_transfer="device"), dict(kv_transfer="device"),
        mutate=lambda ktp: {**ktp, "kv_wire_device": ["127.0.0.1:1"]})
    assert headers["x-kv-pull-route"] == "host"
    assert (dec.engine.kv_import_device_count, dec.engine.kv_import_host_count) == (0, 1)
    assert toks == mono


def test_sharded_geometry_mismatch_falls_back_to_host(loop, weights, mono, cpu_device_wire):  # noqa: F811
    """A tp=2 exporter, an unsharded importer: the page sharding differs,
    so the pull takes /kv (whose joined layout fits any importer)."""
    ktp, headers, toks, _, dec, _ = _pd(loop, weights, dict(kv_transfer="device", tp_size=2),
                                        dict(kv_transfer="device"))
    assert ktp["kv_mesh"]["mesh_shape"] == [1, 2, 1]
    assert headers["x-kv-pull-route"] == "host"
    assert (dec.engine.kv_import_device_count, dec.engine.kv_import_host_count) == (0, 1)
    assert toks == mono


def test_jax_importer_takes_kv_from_port_exporter(loop, weights, mono, cpu_device_wire):  # noqa: F811
    """The JAX decode engine has its transfer server up (kv_transfer
    "auto"): a port export gives it no JAX device key, so it pulls /kv at
    once and never a device pull that would block on a peer that is not
    JAX."""
    model, jparams, tparams = weights
    pre = _port_node(loop, model, tparams, kv_transfer="device")
    cfg = JaxEngineConfig(model=model, port=free_port(), kv_events_port=0, **COMMON)
    dec = Node(loop, JaxEngineServer(cfg, engine=TpuEngine(cfg, params=jparams)))
    try:
        assert dec.engine.kv_transfer_server is not None
        _, r1 = _complete(pre.port, PROMPT, 1, ktp={"do_remote_decode": True})
        ktp = r1["kv_transfer_params"]
        assert "kv_wire_device" in ktp
        _complete(dec.port, PROMPT, N_GEN, rid="dec", ktp=ktp)
        assert (dec.engine.kv_import_device_count, dec.engine.kv_import_host_count) == (0, 1)
        assert dec.tokens["dec"] == mono
    finally:
        pre.stop()
        dec.stop()


def test_port_importer_ignores_jax_device_keys(loop, weights, mono, cpu_device_wire):  # noqa: F811
    """A JAX exporter with its transfer server up advertises
    ``transfer_address``; a port importer with its device wire up skips the
    JAX keys (and a sharded JAX export's) and takes /kv."""
    model, jparams, tparams = weights
    cfg = JaxEngineConfig(model=model, port=free_port(), kv_events_port=0, **COMMON)
    pre = Node(loop, JaxEngineServer(cfg, engine=TpuEngine(cfg, params=jparams)))
    dec = _port_node(loop, model, tparams, kv_transfer="device")
    try:
        _, r1 = _complete(pre.port, PROMPT, 1, ktp={"do_remote_decode": True})
        ktp = r1["kv_transfer_params"]
        assert "transfer_address" in ktp and "transfer_uuid" in ktp
        ktp |= {"transfer_shards": [ktp["transfer_address"]],
                "shard_wire_addrs": [ktp["transfer_address"]]}
        headers, _ = _complete(dec.port, PROMPT, N_GEN, rid="dec", ktp=ktp)
        assert headers["x-kv-pull-route"] == "host"
        assert (dec.engine.kv_import_device_count, dec.engine.kv_import_host_count) == (0, 1)
        assert dec.tokens["dec"] == mono
    finally:
        pre.stop()
        dec.stop()


def test_device_wire_refused_where_it_cannot_run(monkeypatch):
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        kv_transfer.check_available(torch.device("cpu"))
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    with pytest.raises(RuntimeError, match="expandable_segments"):
        kv_transfer.check_available(torch.device("cuda"))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TorchEngine(EngineConfig(model="tiny", device="cpu", kv_transfer="device"))
    eng = TorchEngine(EngineConfig(model="tiny", device="cpu"))  # "auto": host
    assert eng.kv_device_wire is None and eng.kv_shard_wire is None


def test_device_wire_registry_in_process(cpu_device_wire):
    srv = kv_transfer.DeviceWireServer("127.0.0.1", torch.device("cpu"))
    try:
        ts = [torch.arange(6.0).reshape(2, 3)]
        srv.register(5, ts)
        got, done = kv_transfer.pull(srv.address(), 5)
        assert got[0] is ts[0]
        done()
        with pytest.raises(KeyError):
            kv_transfer.pull(srv.address(), 6)
        srv.unregister(5)
        assert srv.lookup(5) is None
    finally:
        srv.close()


def _one_shot_peer(reply: bytes):
    """A fake device-wire peer on localhost: reads one uuid, answers
    ``reply``, waits for the puller to close. Returns (address, thread)."""
    import socket
    import threading

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        with srv:
            conn, _ = srv.accept()
            with conn:
                conn.recv(8)
                conn.sendall(reply)
                conn.recv(1)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return f"127.0.0.1:{srv.getsockname()[1]}", t


class _RunsCode:
    """Unpickled, it runs code: it sets ``builtins._device_wire_ran``."""

    def __reduce__(self):
        return (exec, ("import builtins; builtins._device_wire_ran = True",))


def _pickling_peer():
    """A fake peer that answers a pull with one pickled ``_RunsCode``."""
    import pickle
    import struct

    blob = pickle.dumps(_RunsCode())
    return _one_shot_peer(struct.pack(">II", 1, len(blob)) + blob)


def test_device_wire_runs_no_code_from_a_peer():
    """A peer that answers a pull with a pickle that would run code when
    unpickled is refused: the wire reads checked JSON descriptions only."""
    import builtins

    addr, t = _pickling_peer()
    with pytest.raises(ValueError, match="not JSON"):
        kv_transfer.pull(addr, 5)
    t.join(5)
    assert not hasattr(builtins, "_device_wire_ran")


def test_device_pull_from_a_pickling_peer_falls_back_to_http(loop, weights, mono,  # noqa: F811
                                                             cpu_device_wire):
    """The same peer named in a completion's kv_transfer_params: the decode
    engine refuses its reply, takes /kv and runs nothing of it."""
    import builtins

    addr, t = _pickling_peer()
    ktp, headers, toks, _, dec, _ = _pd(
        loop, weights, dict(kv_transfer="device"), dict(kv_transfer="device"),
        mutate=lambda ktp: {**ktp, "kv_wire_device": [addr]})
    t.join(5)
    assert not hasattr(builtins, "_device_wire_ran")
    assert headers["x-kv-pull-route"] == "host"
    assert (dec.engine.kv_import_device_count, dec.engine.kv_import_host_count) == (0, 1)
    assert toks == mono


def _description(**kw):
    desc = {"size": [2, 3], "stride": [3, 1], "offset": 0, "dtype": "bfloat16",
            "device": 0, "handle": "ab" * 64, "storage_size_bytes": 12,
            "storage_offset_bytes": 0, "ref_counter_handle": b"/torch_12_34_0".hex(),
            "ref_counter_offset": 0, "event_handle": "cd" * 64,
            "event_sync_required": True}
    return json.dumps({**desc, **kw}).encode()


@pytest.mark.parametrize("bad", [
    {"size": [2, -3]}, {"stride": [1]}, {"offset": -1}, {"offset": True},
    {"dtype": "object"}, {"handle": "zz"}, {"handle": None}, {"handle": ""},
    {"ref_counter_handle": b"../etc/passwd".hex()}, {"event_sync_required": 1},
    {"extra": 1}])
def test_device_wire_description_is_checked(bad):
    good = kv_transfer.parse_description(_description())
    assert good["dtype"] == torch.bfloat16 and good["handle"] == bytes.fromhex("ab" * 64)
    assert good["ref_counter_handle"] == b"/torch_12_34_0"
    with pytest.raises(ValueError):
        kv_transfer.parse_description(_description(**bad))


def test_device_wire_dials_only_this_node(monkeypatch):
    """CUDA IPC works only within a node: an address that is not this
    node's is refused before any connection (no name is resolved)."""
    import socket

    for host in ("127.0.0.1", "localhost", "0.0.0.0", "::1"):
        assert kv_transfer.on_this_node(host), host
    for host in ("192.0.2.1", "node-7.cluster", ""):
        assert not kv_transfer.on_this_node(host), host

    def no_dial(*a, **k):
        raise AssertionError("dialed")

    monkeypatch.setattr(socket, "create_connection", no_dial)
    with pytest.raises(ValueError, match="not on this node"):
        kv_transfer.pull("192.0.2.1:9", 5)


def test_wire_servers_take_a_probe_quietly(cpu_device_wire, caplog):
    """The engine's preflight connects and closes before a pull: neither
    wire server logs that as a failed connection."""
    import logging
    import socket
    import time

    from llm_d_inference_scheduler_tpu_torch.engine import shard_wire

    caplog.set_level(logging.DEBUG)
    servers = [kv_transfer.DeviceWireServer("127.0.0.1", torch.device("cpu")),
               shard_wire.ShardWireServer("127.0.0.1")]
    try:
        for srv in servers:
            host, _, port = srv.address().rpartition(":")
            socket.create_connection((host, int(port)), timeout=5).close()
        time.sleep(0.5)
        assert not [r for r in caplog.records if "connection failed" in r.getMessage()]
    finally:
        for srv in servers:
            srv.close()
