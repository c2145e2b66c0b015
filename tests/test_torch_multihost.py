"""PyTorch port, multi-process serving (``--dist-*``) on the CPU.

The JAX ``tests/test_multihost.py`` does not run on this image, so a port
group is held to the JAX single-device engine, as the tp and pp slices are:

- a two-process group (two engines in threads of this process, each with
  its own gloo group over one ``HashStore`` and the real instruction
  channel) with tp=2, and one with pp=2, on TINY f32 (``decode_chunk`` 4)
  gives greedy tokens equal to the JAX single-device engine's on the same
  weights: three concurrent prompts (batch bucket 4: the pp interleave),
  then the first again (a prefix-cache hit) and a lone prompt (bucket 1:
  the pp broadcast ring); the embedding within 1e-4;
- at temperature 1.0 with a fixed seed the group's tokens equal the
  single-process port engine's (every sampling process holds the same
  logits and the same seeded generator);
- the instruction channel: the JAX module's liveness drill, a JAX leader's
  pings and ops decoding in a port follower and the port leader's in a JAX
  follower;
- the degrade drill with a real follower process (the server CLI): killing
  it turns the leader's ``/health`` 503 ``degraded`` and ends the in-flight
  request; and with a real leader process: killing it makes the follower
  exit nonzero (the only two tests that spawn processes, each bounded);
- the layouts a group serves, the backend rule and the parser.
"""

import asyncio
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _net import free_port
from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine import EngineRequest as JaxRequest
from llm_d_inference_scheduler_tpu.engine import multihost as jax_mh
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu_torch.engine import multihost
from llm_d_inference_scheduler_tpu_torch.engine import server as server_mod
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy
from llm_d_inference_scheduler_tpu_torch.parallel import serve as par

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = dict(max_batch=4, max_model_len=128, decode_chunk=4)
PROMPTS = [[1] + list(range(10 + 7 * i, 40 + 7 * i)) for i in range(3)]
LONE = [1] + list(range(200, 223))
TOL = dict(rtol=1e-4, atol=1e-4)
# (case, tp, pp)
GROUPS = [("tp2", 2, 1), ("pp2", 1, 2)]
CHILD_TIMEOUT_S = 120


def model_dir(tmp_path_factory, dtype="float32"):
    d = tmp_path_factory.mktemp(f"tiny_{dtype}")
    fields = dataclasses.asdict(jax_configs.TINY) | {"dtype": dtype}
    (d / "model_config.json").write_text(json.dumps(fields))
    return str(d)


class Group:
    """``n`` engines of one group in threads of this process: each with its
    own gloo group over a shared ``HashStore`` and the real instruction
    channel; the followers replay in ``run_follower`` threads."""

    def __init__(self, n: int, cfg_kw: dict, params=None):
        store = dist.HashStore()
        instr = free_port()
        self.engines: list = [None] * n
        errors: list = []

        def build(pid):
            try:
                cfg = EngineConfig(**cfg_kw, dist_coordinator="127.0.0.1:0",
                                   dist_num_processes=n, dist_process_id=pid,
                                   dist_instr_port=instr)
                self.engines[pid] = TorchEngine(cfg, params=params,
                                                comm=multihost.make_comm(store, pid, n))
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=build, args=(p,)) for p in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        if errors:
            raise errors[0]
        self.leader = self.engines[0]
        self.followers = [threading.Thread(target=multihost.run_follower, args=(e,),
                                           daemon=True) for e in self.engines[1:]]
        for t in self.followers:
            t.start()

    def join(self):
        """After the leader's stop: the followers got ("stop",) and return."""
        for t in self.followers:
            t.join(30)
            assert not t.is_alive()
        for e in self.engines[1:]:
            e.close()


async def gen(engine, make_req, rid, prompt, max_tokens, temperature=0.0):
    out = engine.submit(make_req(request_id=rid, prompt_token_ids=list(prompt),
                                 max_tokens=max_tokens, temperature=temperature,
                                 ignore_eos=True))
    toks = []
    while True:
        ev = await asyncio.wait_for(out.get(), timeout=120)
        if ev.token_id is not None:
            toks.append(ev.token_id)
        if ev.finish_reason is not None:
            assert ev.finish_reason.value != "abort"
            return toks


async def scenario(engine, make_req, temperature=0.0):
    """Three prompts at once, the first again (a prefix hit) and a lone
    prompt; then the embedding of the lone prompt."""
    await engine.start()
    try:
        res = list(await asyncio.gather(*(gen(engine, make_req, f"p{i}", p, 8 + i,
                                              temperature)
                                          for i, p in enumerate(PROMPTS))))
        res.append(await gen(engine, make_req, "again", PROMPTS[0], 6, temperature))
        res.append(await gen(engine, make_req, "lone", LONE, 9, temperature))
        emb = np.asarray(engine.embed(LONE))
        return res, emb
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    model = model_dir(tmp_path_factory)
    jparams = jax_llama.init_params(jax_configs.get_config(model), jax.random.key(5))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return model, jparams, tparams


@pytest.fixture(scope="module")
def jax_ref(weights):
    model, jparams, _ = weights
    eng = TpuEngine(JaxEngineConfig(model=model, **COMMON, kv_events_port=0,
                                    kv_transfer="host"), params=jparams)
    return asyncio.run(scenario(eng, JaxRequest))


@pytest.mark.parametrize("case,tp,pp", GROUPS, ids=[g[0] for g in GROUPS])
def test_group_greedy_tokens_equal_jax_engine(weights, jax_ref, case, tp, pp):
    model, _, tparams = weights
    g = Group(2, dict(model=model, **COMMON, device="cpu", tp_size=tp, pp_size=pp,
                      kv_events_port=0), tparams)
    lay = g.leader.layout
    assert (lay.procs, lay.tp, lay.pp) == (2, tp, pp)
    # Each process holds its own ranks only: one page shard each.
    assert [sum(k is not None for k in e.k_pages) for e in g.engines] == [1, 1]
    res, emb = asyncio.run(scenario(g.leader, EngineRequest))
    g.join()
    ref_res, ref_emb = jax_ref
    assert res == ref_res
    assert [len(t) for t in res] == [8, 9, 10, 6, 9]
    np.testing.assert_allclose(emb, ref_emb, **TOL)
    if pp > 1:  # both pp schedules served, on both processes
        for e in g.engines:
            assert e.decode_steps_by_schedule["interleave"] > 0
            assert e.decode_steps_by_schedule["ring"] > 0


@pytest.mark.parametrize("case,tp,pp", GROUPS, ids=[g[0] for g in GROUPS])
def test_group_sampled_tokens_equal_single_process(weights, case, tp, pp):
    model, _, tparams = weights
    kw = dict(model=model, **COMMON, device="cpu", kv_events_port=0, seed=11)
    single, _ = asyncio.run(scenario(TorchEngine(EngineConfig(**kw), params=tparams),
                                     EngineRequest, temperature=1.0))
    g = Group(2, dict(kw, tp_size=tp, pp_size=pp), tparams)
    res, _ = asyncio.run(scenario(g.leader, EngineRequest, temperature=1.0))
    g.join()
    assert res == single
    greedy, _ = asyncio.run(scenario(TorchEngine(EngineConfig(**kw), params=tparams),
                                     EngineRequest))
    assert res != greedy  # the draws moved the tokens


def test_group_launch_counts_gather_every_process(weights):
    """``group_launches`` reads every process's kernel counts over the group
    (the plain versions count nothing on the CPU: zeros, one row each)."""
    model, _, tparams = weights
    g = Group(2, dict(model=model, **COMMON, device="cpu", tp_size=2,
                      kv_events_port=0), tparams)

    async def body():
        await g.leader.start()
        try:
            return await asyncio.to_thread(g.leader.group_launches, True)
        finally:
            await g.leader.stop()

    counts = asyncio.run(body())
    g.join()
    assert len(counts) == 2 and all(set(c) == set(counts[0]) for c in counts)
    assert all(v == 0 for c in counts for v in c.values())


@pytest.mark.parametrize("walk", ["right", "reversed"])
def test_group_kernel_check_holds_each_process(weights, monkeypatch, walk):
    """``check_kernels`` holds K1 to its plain version in every process, on
    random pages read through a shuffled block table: a kernel that walks
    the table the wrong way disagrees in each process."""
    from llm_d_inference_scheduler_tpu_torch.ops import attention, paged_attention

    if walk == "reversed":
        def wrong(q, kp, vp, tables, lens, ck, cv):
            return attention.paged_decode_attention(q, kp, vp, tables.flip(-1), lens,
                                                    cur_k=ck, cur_v=cv)

        monkeypatch.setattr(paged_attention, "paged_decode_attention_cuda", wrong)
    model, _, tparams = weights
    g = Group(2, dict(model=model, **COMMON, device="cpu", tp_size=2,
                      kv_events_port=0), tparams)

    async def body():
        await g.leader.start()
        try:
            return await asyncio.to_thread(g.leader.check_kernels, 1e-5, 1e-5, 1e-3)
        finally:
            await g.leader.stop()

    res = asyncio.run(body())
    g.join()
    assert len(res) == 2 and all(set(r) == {paged_attention.KERNEL} for r in res)
    assert all(ok == (walk == "right") for r in res for _, ok in r.values())


def test_stopped_group_leader_frees_its_engine(weights):
    """Once stopped, a group's leader engine (and the weights it holds) is
    freed at the next collection, while the channel's ping thread still
    sleeps: nothing the channel keeps refers back to the engine."""
    import gc
    import weakref

    model, _, tparams = weights
    g = Group(2, dict(model=model, **COMMON, device="cpu", tp_size=2,
                      kv_events_port=0), tparams)

    async def body():
        await g.leader.start()
        await g.leader.stop()

    asyncio.run(body())
    g.join()
    ref = weakref.ref(g.leader)
    g.leader = None
    g.engines = []
    gc.collect()
    assert ref() is None


# ---- the instruction channel ------------------------------------------------


def _leader_in_thread(mod, port, ping, box):
    def make():
        box["ch"] = mod.InstructionChannel(leader=True, host="127.0.0.1", port=port,
                                           n_followers=1, ping_interval=ping)

    t = threading.Thread(target=make, daemon=True)
    t.start()
    return t


def test_channel_liveness_in_process():
    """The JAX drill: pings flow; a closed leader trips LeaderLost; a dead
    follower fires the peer monitor and breaks broadcast; a silent leader
    trips the recv deadline."""
    box = {}
    port = free_port()
    t = _leader_in_thread(multihost, port, 0.1, box)
    follower = multihost.InstructionChannel(leader=False, host="127.0.0.1", port=port,
                                            recv_timeout=2.0)
    t.join(10)
    assert follower.recv()[0] == ("ping",)
    box["ch"].close()
    with pytest.raises(multihost.LeaderLost):
        while True:
            follower.recv()
    follower.close()

    port = free_port()
    lost = threading.Event()
    t = _leader_in_thread(multihost, port, 0.0, box)
    follower = multihost.InstructionChannel(leader=False, host="127.0.0.1", port=port,
                                            recv_timeout=2.0)
    t.join(10)
    leader = box["ch"]
    leader.on_peer_lost = lambda idx, why: lost.set()
    follower.close()
    assert lost.wait(5.0), "peer monitor never fired"
    deadline = time.monotonic() + 5.0
    while True:
        try:
            leader.broadcast(("decode",), {})
        except multihost.ChannelBroken:
            break
        assert time.monotonic() < deadline, "broadcast never raised ChannelBroken"
        time.sleep(0.05)
    leader.close()

    port = free_port()
    t = _leader_in_thread(multihost, port, 0.0, box)
    follower = multihost.InstructionChannel(leader=False, host="127.0.0.1", port=port,
                                            recv_timeout=0.3)
    t.join(10)
    with pytest.raises(multihost.LeaderLost, match="presumed dead"):
        follower.recv()
    follower.close()
    box["ch"].close()


@pytest.mark.parametrize("lead,follow", [(jax_mh, multihost), (multihost, jax_mh)],
                         ids=["jax-leader", "port-leader"])
def test_channel_framing_interoperates_with_jax(lead, follow):
    """The framing is the JAX module's: a leader's pings and ops (numpy
    arguments) decode in a follower of the other package, and the
    follower's hello reaches the leader."""
    box = {}
    port = free_port()
    t = _leader_in_thread(lead, port, 0.05, box)
    follower = follow.InstructionChannel(leader=False, host="127.0.0.1", port=port,
                                         recv_timeout=5.0,
                                         hello={"process_id": 1,
                                                "shard_wire_address": "h:1"})
    t.join(10)
    leader = box["ch"]
    assert leader.hellos[1]["shard_wire_address"] == "h:1"
    assert follower.recv() == (("ping",), {})
    leader.broadcast(("decode",), {"tokens": np.arange(4, dtype=np.int32)})
    while True:
        op, args = follower.recv()
        if op != ("ping",):
            break
    assert op == ("decode",)
    np.testing.assert_array_equal(args["tokens"], np.arange(4, dtype=np.int32))
    leader.broadcast(("stop",), {})
    follower.close()
    leader.close()


# ---- real processes: the degrade drills ---------------------------------------


def _cli(pid: int, coord: int, instr: int, port: int, *extra) -> list[str]:
    return [sys.executable, "-m", "llm_d_inference_scheduler_tpu_torch.engine.server",
            "--model", "tiny", "--device", "cpu", "--tp-size", "2", "--max-batch", "2",
            "--max-model-len", "256", "--port", str(port), "--kv-events-port", "0",
            "--dist-coordinator", f"127.0.0.1:{coord}", "--dist-num-processes", "2",
            "--dist-process-id", str(pid), "--dist-instr-port", str(instr), *extra]


def _spawn(argv, log_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(log_path, "wb") as out:  # the child keeps its own descriptor
        return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out,
                                stderr=subprocess.STDOUT, start_new_session=True)


def _reap(*procs):
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
        p.wait(10)


def _health(port: int) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_health(port: int, want: str, timeout: float) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        try:
            status, doc = _health(port)
            if doc.get("status") == want:
                return doc
        except OSError:
            pass
        assert time.monotonic() < deadline, f"/health never reported {want}"
        time.sleep(0.1)


def test_leader_degrades_when_follower_dies(tmp_path):
    """A follower process (the server CLI) joins a leader served in this
    process; killing it mid-request ends the request, turns /health 503
    ``degraded`` and makes new work end at once: no call hangs."""
    coord, instr = free_port(), free_port()
    follower = _spawn(_cli(1, coord, instr, 0), tmp_path / "follower.log")
    try:
        cfg, _ = server_mod.parse_config(_cli(0, coord, instr, 0)[3:])
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever, daemon=True)
        thread.start()
        server = server_mod.EngineServer(cfg)
        assert server.engine.layout.procs == 2
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(CHILD_TIMEOUT_S)
        port = server.port
        try:
            assert _wait_health(port, "ok", 30)["status"] == "ok"
            body = json.dumps({"prompt": "hello", "max_tokens": 200, "ignore_eos": True,
                               "temperature": 0}).encode()
            done = {}

            def long_request():
                req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                             data=body,
                                             headers={"content-type": "application/json"})
                t0 = time.monotonic()
                try:
                    with urllib.request.urlopen(req, timeout=60) as r:
                        done["status"], done["doc"] = r.status, json.loads(r.read())
                except urllib.error.HTTPError as e:
                    done["status"] = e.code
                done["s"] = time.monotonic() - t0

            t = threading.Thread(target=long_request)
            t.start()
            deadline = time.monotonic() + 30
            while server.engine.decode_steps == 0:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            os.killpg(follower.pid, signal.SIGKILL)
            t_kill = time.monotonic()
            t.join(30)
            assert not t.is_alive(), "the in-flight request hung"
            assert time.monotonic() - t_kill < 15
            doc = _wait_health(port, "degraded", 10)
            assert _health(port)[0] == 503 and doc["status"] == "degraded"
            assert server.engine.dist_degraded
            # The in-flight request ended short of its 200 tokens.
            assert done["status"] != 200 or done["doc"]["usage"]["completion_tokens"] < 200
            t0 = time.monotonic()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                         data=body, headers={"content-type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert json.loads(r.read())["usage"]["completion_tokens"] == 0
            except urllib.error.HTTPError:
                pass
            assert time.monotonic() - t0 < 10
        finally:
            asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
            loop.call_soon_threadsafe(loop.stop)
            thread.join(10)
    finally:
        _reap(follower)


def test_follower_exits_when_leader_crashes(tmp_path):
    """Both processes from the server CLI; SIGKILL on the leader makes the
    follower exit nonzero (LeaderLost), within its recv deadline."""
    coord, instr, port = free_port(), free_port(), free_port()
    leader = _spawn(_cli(0, coord, instr, port), tmp_path / "leader.log")
    follower = _spawn(_cli(1, coord, instr, 0), tmp_path / "follower.log")
    try:
        _wait_health(port, "ok", CHILD_TIMEOUT_S)
        assert follower.poll() is None
        os.killpg(leader.pid, signal.SIGKILL)
        rc = follower.wait(40)
        assert rc != 0, (tmp_path / "follower.log").read_text()[-2000:]
        assert "LeaderLost" in (tmp_path / "follower.log").read_text()
    finally:
        _reap(leader, follower)


# ---- layouts, backend rule, parser --------------------------------------------


class _FakeComm:
    def __init__(self, rank, size):
        self.rank, self.size, self.backend = rank, size, "gloo"


@pytest.mark.parametrize("tp,ep,pp,procs,err", [
    (2, 1, 1, 2, None), (4, 2, 1, 2, None), (1, 1, 2, 2, None), (2, 1, 2, 2, None),
    (1, 1, 4, 2, None),
    (1, 2, 1, 2, "whole tp ranks"), (1, 1, 1, 2, "whole tp ranks"),
    (2, 1, 2, 4, "whole stages"), (2, 1, 3, 2, "whole stages")])
def test_validate_dist(tp, ep, pp, procs, err):
    if err is None:
        par.validate_dist(tp, ep, pp, procs)
    else:
        with pytest.raises(ValueError, match=err):
            par.validate_dist(tp, ep, pp, procs)


def test_group_layout_holds_this_process_ranks():
    """Process-major ranks: process 1 of 2 under pp=2 x tp=2 holds stage 1."""
    lay = par.make_serve_layout(["cpu", "cpu"], tp=2, pp=2, comm=_FakeComm(1, 2))
    assert lay.devices[:2] == (None, None) and lay.procs == 2
    assert [r for r, _, _ in lay.ranks()] == [2, 3]
    assert (lay.stage_proc(0), lay.stage_proc(1)) == (0, 1)
    assert lay.first_device == torch.device("cpu") and lay.stage(1).comm is None
    lay = par.make_serve_layout(["cpu"], tp=2, comm=_FakeComm(0, 2))
    assert lay.tp_device(1) is None and lay.stage(0).comm is not None
    with pytest.raises(ValueError, match=r"pp\*tp\*ep == global devices \(4 != 6\)"):
        par.make_serve_layout(["cpu"] * 3, tp=2, pp=2, comm=_FakeComm(0, 2))


def test_backend_rule():
    assert multihost.pick_backend([["h:GPU-a"], ["h:GPU-b"]]) == "nccl"
    assert multihost.pick_backend([["h:GPU-a"], ["h:GPU-a"]]) == "gloo"
    assert multihost.pick_backend([["h:cpu"], ["h:cpu"]]) == "gloo"
    assert multihost.device_identity([torch.device("cpu")]) == [f"{socket.gethostname()}:cpu"]


def test_comm_abort_only_under_nccl():
    """A dead follower aborts an NCCL group's communicators (a collective in
    flight raises at once); gloo's collectives fail by themselves."""
    calls = []

    class PG:
        def abort(self):
            calls.append(1)

    par.Comm(PG(), 0, 2, "gloo").abort()
    assert calls == []
    par.Comm(PG(), 0, 2, "nccl").abort()
    assert calls == [1]


def test_parser_takes_the_dist_flags():
    cfg, _ = server_mod.parse_config(
        ["--dist-coordinator", "10.0.0.1:9000", "--dist-num-processes", "2",
         "--dist-process-id", "1", "--dist-instr-port", "9001", "--dist-instr-host",
         "10.0.0.1", "--tp-size", "2"])
    assert (cfg.dist_coordinator, cfg.dist_num_processes, cfg.dist_process_id,
            cfg.dist_instr_port, cfg.dist_instr_host, cfg.kv_wire) == (
        "10.0.0.1:9000", 2, 1, 9001, "10.0.0.1", "auto")
    assert cfg.dist and cfg.dist_recv_timeout_s == 30.0 and cfg.kv_transfer == "auto"
    # The wires are config fields, as in the JAX server: no flags.
    for flag in ("--kv-wire", "--kv-transfer"):
        with pytest.raises(SystemExit):
            server_mod.parse_config([flag, "host"])
    # A group's CPU ranks: this process's share.
    cfg.device = "cpu"
    assert cfg.rank_devices() == ["cpu"]
    with pytest.raises(ValueError, match="whole tp ranks"):
        TorchEngine(EngineConfig(model="tiny", device="cpu", dist_coordinator="h:1",
                                 dist_num_processes=2))
