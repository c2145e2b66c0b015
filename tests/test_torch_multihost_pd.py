"""PyTorch port, P/D handoff between multi-process groups on the CPU.

- The shard wire's bytes cross both ways with the JAX module: the port's
  ``pull_shards`` against a JAX ``ShardWireServer`` and a JAX
  ``pull_shards`` against the port's server, on f32 and bf16 arrays;
- ``mesh_descriptor`` equals the JAX one of the same ``(pp, tp, ep)`` mesh;
- a two-process tp=2 prefill group hands its KV to a two-process tp=2
  decode group over the host shard wire (the JAX
  ``tests/test_multihost_pd.py:161``), and a pp=2 pair over the device wire
  (its in-process leg: both groups' processes are threads here), each
  process pulling its own shards from its counterpart: tokens equal the JAX
  monolithic engine's, the imported pages equal the staged shards bitwise,
  the export is released everywhere;
- mixed wires (a host-wire exporter group, a device-wire importer group)
  degrade to local prefill with the monolithic tokens and no pull (the JAX
  ``:329``); a group's leader answers ``GET /kv`` 404.

Groups are engines in threads of this process (``test_torch_multihost``'s
``Group``), leaders behind in-process servers on free ports.
"""

import asyncio
import json
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from _net import free_port
from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine import kv_shards as jax_kv_shards
from llm_d_inference_scheduler_tpu.engine import shard_wire as jax_wire
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu.engine.server import EngineServer as JaxEngineServer
from llm_d_inference_scheduler_tpu.parallel import pp_serve as jax_pp
from llm_d_inference_scheduler_tpu.parallel import serve as jax_serve
from llm_d_inference_scheduler_tpu_torch.engine import kv_shards, kv_transfer
from llm_d_inference_scheduler_tpu_torch.engine import shard_wire
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
from test_torch_multihost import COMMON, Group, weights  # noqa: F401 (fixture)
from test_torch_pd import Node, _complete, _request

PROMPT = [1] + list(range(20, 80))
N_GEN = 6


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield loop
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)


@pytest.fixture
def cpu_device_wire(monkeypatch):
    """Let the device wire run on CPU tensors: within one process its pull
    is a direct copy, which is all the CPU can show (CUDA IPC needs a card:
    tests/test_torch_kv_device.py's cuda cases)."""
    monkeypatch.setattr(kv_transfer, "check_available", lambda device: None)


@pytest.fixture(scope="module")
def mono(loop, weights):
    model, jparams, _ = weights
    cfg = JaxEngineConfig(model=model, port=free_port(), kv_events_port=0,
                          kv_transfer="host", **COMMON)
    node = Node(loop, JaxEngineServer(cfg, engine=TpuEngine(cfg, params=jparams)))
    _complete(node.port, PROMPT, N_GEN, rid="mono")
    yield node.tokens["mono"]
    node.stop()


class ServedGroup:
    """A two-process group whose leader serves HTTP; taps each process's
    staged shards and each import's blocks."""

    def __init__(self, loop, weights, **kw):
        model, _, tparams = weights
        self.group = Group(2, dict(model=model, **COMMON, device="cpu", port=0,
                                   kv_events_port=0, **kw), tparams)
        self.staged: list[list[torch.Tensor]] = [[], []]
        self.imported: list[np.ndarray] = []
        for pid, eng in enumerate(self.group.engines):
            for wire in (eng.kv_shard_wire, eng.kv_device_wire):
                if wire is not None:
                    reg = wire.register
                    wire.register = (lambda tuid, shards, reg=reg, pid=pid: (
                        self.staged[pid].extend(t.clone() for t in shards),
                        reg(tuid, shards)))
            copy = eng._copy_shards
            eng._copy_shards = (lambda shards, blocks, shape, copy=copy: (
                self.imported.append(np.array(blocks)), copy(shards, blocks, shape)))
            if pid:
                # A follower that stages and pulls late: the leader must not
                # name the export before it is staged everywhere, nor release
                # it before every process has pulled.
                for name in ("_op_stage_kv", "_op_pull_kv_import"):
                    op = getattr(eng, name)
                    setattr(eng, name, lambda op=op, **kw: (time.sleep(0.3), op(**kw))[1])
        self.node = Node(loop, EngineServer(self.group.leader.cfg, engine=self.group.leader))

    def stop(self):
        self.node.stop()
        self.group.join()


def _handoff(exp: ServedGroup, imp: ServedGroup):
    _, r1 = _complete(exp.node.port, PROMPT, 1, ktp={"do_remote_decode": True})
    ktp = r1["kv_transfer_params"]
    headers, _ = _complete(imp.node.port, PROMPT, N_GEN, rid="dec", ktp=ktp)
    return ktp, headers, imp.node.tokens["dec"]


@pytest.mark.parametrize("tp,pp,wire", [(2, 1, "host"), (1, 2, "device")],
                         ids=["tp2-host-wire", "pp2-device-wire"])
def test_dist_handoff_matches_monolithic(loop, weights, mono, cpu_device_wire, tp, pp, wire):
    exp = ServedGroup(loop, weights, tp_size=tp, pp_size=pp, kv_wire=wire)
    imp = ServedGroup(loop, weights, tp_size=tp, pp_size=pp, kv_wire=wire)
    try:
        ktp, headers, toks = _handoff(exp, imp)
        assert ktp["kv_mesh"] == kv_shards.mesh_descriptor(tp, 1, pp, 2)
        assert len(ktp[f"kv_wire_{wire}"]) == 2 and all(ktp[f"kv_wire_{wire}"])
        # Never the JAX device wire's keys: a JAX importer takes /kv at once.
        assert "transfer_address" not in ktp and "transfer_shards" not in ktp
        assert toks == mono
        assert headers["x-kv-pull-route"] == ("device" if wire == "device" else "shard-wire")
        lead = imp.group.leader
        assert (lead.kv_import_device_count, lead.kv_import_host_count) == (
            (1, 0) if wire == "device" else (0, 1))
        # Each importer process copied its own shards: the prompt's positions
        # (decode has written past them since) bitwise the staged ones.
        assert len(imp.imported) == 2
        n = len(imp.imported[0])

        def prompt_rows(t):
            return t.reshape(t.shape[0], -1, *t.shape[3:])[:, :len(PROMPT)]

        for pid, eng in enumerate(imp.group.engines):
            ks = exp.staged[pid]
            pairs = eng._page_pairs()
            assert len(ks) == 2 * len(pairs) == 2
            ids = torch.from_numpy(imp.imported[pid]).long()
            assert torch.equal(prompt_rows(pairs[0][0][:, ids]), prompt_rows(ks[0][:, :n]))
            assert torch.equal(prompt_rows(pairs[0][1][:, ids]), prompt_rows(ks[1][:, :n]))
        # The release reached every exporter process.
        for eng in exp.group.engines:
            deadline = 50
            while eng.kv_exports and deadline:
                threading.Event().wait(0.1)
                deadline -= 1
            assert not eng.kv_exports
        # A group serves no /kv: the leader answers 404 for an export.
        _, r1 = _complete(exp.node.port, PROMPT, 1, ktp={"do_remote_decode": True})
        rid = r1["kv_transfer_params"]["remote_request_id"]
        status, _, body = _request(exp.node.port, f"/kv/{rid}")
        assert status == 404 and b"shard wires" in body
    finally:
        exp.stop()
        imp.stop()


def test_dist_mixed_wires_degrade_to_local_prefill(loop, weights, mono, cpu_device_wire):
    exp = ServedGroup(loop, weights, tp_size=2, kv_wire="host")
    imp = ServedGroup(loop, weights, tp_size=2, kv_wire="device")
    try:
        ktp, headers, toks = _handoff(exp, imp)
        assert "kv_wire_host" in ktp and "kv_wire_device" not in ktp
        assert toks == mono
        lead = imp.group.leader
        assert (lead.kv_import_device_count, lead.kv_import_host_count) == (0, 0)
        assert "x-kv-pull-route" not in headers and imp.imported == []
    finally:
        exp.stop()
        imp.stop()


# ---- the shard wire against the JAX module -------------------------------------


def _arrays(dtype):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32)
    b = rng.standard_normal((2, 1, 4, 2, 8)).astype(np.float32)
    if dtype == "bfloat16":
        a, b = a.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    return [a, b]


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_pulls_from_jax_shard_wire_server(dtype):
    srv = jax_wire.ShardWireServer("127.0.0.1")
    try:
        arrays = _arrays(dtype)
        srv.register(7, arrays)
        got = shard_wire.pull_shards(srv.address(), 7)
        assert [str(t.dtype) for t in got] == [f"torch.{dtype}"] * 2
        for t, a in zip(got, arrays):
            assert torch.equal(t, _to_torch(a))
        with pytest.raises(KeyError):
            shard_wire.pull_shards(srv.address(), 8)
    finally:
        srv.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_pulls_from_port_shard_wire_server(dtype):
    srv = shard_wire.ShardWireServer("127.0.0.1")
    try:
        arrays = _arrays(dtype)
        srv.register(9, [_to_torch(a) for a in arrays])
        got = jax_wire.pull_shards(srv.address(), 9)
        for g, a in zip(got, arrays):
            assert g.dtype == a.dtype and g.shape == a.shape
            np.testing.assert_array_equal(g.view(np.uint8), a.view(np.uint8))
        srv.unregister(9)
        with pytest.raises(KeyError):
            jax_wire.pull_shards(srv.address(), 9)
    finally:
        srv.close()


def test_shard_wire_round_trip_and_empty_shard():
    srv = shard_wire.ShardWireServer("127.0.0.1")
    try:
        ts = [torch.arange(24, dtype=torch.float32).reshape(2, 3, 4),
              torch.zeros((0, 4), dtype=torch.bfloat16)]
        srv.register(3, ts)
        got = shard_wire.pull_shards(srv.address(), 3)
        assert torch.equal(got[0], ts[0]) and got[1].shape == (0, 4)
    finally:
        srv.close()


@pytest.mark.parametrize("tp,ep,pp", [(1, 1, 1), (2, 1, 1), (2, 2, 1), (4, 1, 1),
                                      (1, 1, 2), (2, 1, 2), (1, 2, 4)])
def test_mesh_descriptor_equals_jax(tp, ep, pp):
    devs = jax.devices()
    if pp > 1:
        mesh, spec = jax_pp.make_pp_mesh(devs[:pp * tp * ep], pp, tp=tp, ep=ep), jax_pp.PAGE_SPEC
    else:
        mesh, spec = jax_serve.make_serve_mesh(devs[:tp * ep], tp=tp, ep=ep), \
            jax_serve.KV_PAGE_SPEC
    want = jax_kv_shards.mesh_descriptor(mesh, spec)
    assert kv_shards.mesh_descriptor(tp, ep, pp, jax.process_count()) == want
    assert json.loads(json.dumps(want)) == want  # as it travels in kv_transfer_params


def test_local_unique_shards_follow_the_canonical_order():
    """A process's page shards in the JAX canonical order (sorted by first
    layer, then first kv head): the port's (stage, tp) index order, the
    other processes' shards left out."""
    from llm_d_inference_scheduler_tpu_torch.parallel import serve as par

    class C:
        rank, size, backend = 1, 2, "gloo"

    lay = par.make_serve_layout(["cpu", "cpu"], tp=2, pp=2, comm=C())
    pages = [None if lay.tp_device(t, s) is None else f"s{s}t{t}"
             for s in range(2) for t in range(2)]
    assert kv_shards.local_unique_shards(pages) == ["s1t0", "s1t1"]
