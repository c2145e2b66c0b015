"""PyTorch port, the engine chaos shim against the JAX one.

- ``FaultInjector.decide`` and ``decide_lifecycle`` of the port's copy
  (``utils/faults.py``) take the JAX shim's decisions over 1,000 seeded ids
  for every kind, with the same ``triggered`` counts;
- on a port engine server (TINY on the CPU, in process), ``delay``,
  ``http503``, ``reset`` and ``stall`` look to a client as they do on the
  JAX server (its sim backend, same spec and seed);
- analogues of ``tests/test_resilience.py``'s gateway drills over port
  engines: failover around a ``reset`` engine with the breaker opening and
  recovering, and the retry budget bounding an all-``http503`` storm;
- the lifecycle kinds: ``spawn_fail``, ``slow_start``, ``stall_drain``; and
  the ``ENGINE_CHAOS`` environment variable.
"""

import asyncio
import time

import httpx
import numpy as np
import pytest

from _net import free_port
from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine.server import EngineServer as JaxEngineServer
from llm_d_inference_scheduler_tpu.router import resilience
from llm_d_inference_scheduler_tpu.router.gateway import build_gateway
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
from llm_d_inference_scheduler_tpu_torch.utils import faults

CHAOS_SEED = 7


def _metric_value(text: str, needle: str) -> float:
    for line in text.splitlines():
        if line.startswith(needle + " ") or (
                line.startswith(needle) and line[len(needle)] in "{ "):
            return float(line.rsplit(" ", 1)[-1])
    return 0.0


# ---- decisions ----------------------------------------------------------------


@pytest.mark.parametrize("kind", faults.FaultInjector.KINDS)
def test_decisions_equal_the_jax_shim(kind):
    rng = np.random.default_rng(3)
    ids = [f"req-{rng.integers(1 << 40):x}" for _ in range(1000)]
    for seed, pct in ((0, 25.0), (CHAOS_SEED, 50.0), (12345, 3.5)):
        spec = f"{kind}:{pct}:40,http503:30" if kind != "http503" else f"{kind}:{pct}"
        mine = faults.FaultInjector.from_spec(spec, seed=seed)
        ref = resilience.FaultInjector.from_spec(spec, seed=seed)
        if kind in faults.FaultInjector.LIFECYCLE_KINDS:
            got = [mine.decide_lifecycle(kind, f"10.0.0.{i % 250}:{8000 + i}")
                   for i in range(1000)]
            want = [ref.decide_lifecycle(kind, f"10.0.0.{i % 250}:{8000 + i}")
                    for i in range(1000)]
        else:
            got = [mine.decide(i) for i in ids]
            want = [ref.decide(i) for i in ids]
        as_tuple = [None if r is None else (r.kind, r.pct, r.arg) for r in want]
        assert [None if r is None else (r.kind, r.pct, r.arg) for r in got] == as_tuple
        assert mine.triggered == ref.triggered
        assert 0 < sum(r is not None for r in got) < 1000
    # Request traffic never takes a lifecycle rule, and a disabled shim nothing.
    inj = faults.FaultInjector.from_spec("spawn_fail:100,slow_start:100:5", seed=1)
    assert inj.decide("any") is None
    inj.enabled = False
    assert inj.decide_lifecycle("spawn_fail", "h:1") is None


def test_spec_grammar_equals_the_jax_shim():
    for spec in ("", "  ", "reset", "delay:10:250, stall:5", "http503:100,,reset:1"):
        mine = faults.FaultInjector.from_spec(spec)
        ref = resilience.FaultInjector.from_spec(spec)
        assert (mine is None) == (ref is None)
        if mine is not None:
            assert [(r.kind, r.pct, r.arg) for r in mine.rules] == \
                   [(r.kind, r.pct, r.arg) for r in ref.rules]
    with pytest.raises(ValueError, match="unknown fault kind 'boom'"):
        faults.FaultInjector.from_spec("boom:5")


# ---- request kinds on a port server, against the JAX server ---------------------


def _port_engine(chaos="", port=0, **kw):
    cfg = EngineConfig(model="tiny", device="cpu", port=port, max_batch=4,
                       max_model_len=128, decode_chunk=4, kv_events_port=0,
                       chaos=chaos, chaos_seed=CHAOS_SEED, **kw)
    return EngineServer(cfg, engine=TorchEngine(cfg))


def _jax_sim(chaos, port):
    return JaxEngineServer(JaxEngineConfig(
        backend="sim", model="tiny", port=port, max_batch=4,
        sim_decode_ms_per_token=1.0, chaos=chaos, chaos_seed=CHAOS_SEED))


async def _observe(port: int, kind: str) -> dict:
    """What a client sees of one generate request."""
    body = {"model": "tiny", "prompt": "hi", "max_tokens": 2,
            "stream": kind == "stall"}
    url = f"http://127.0.0.1:{port}/v1/completions"
    t0 = time.monotonic()
    async with httpx.AsyncClient(timeout=30) as c:
        try:
            if kind == "stall":
                lines = []
                async with c.stream("POST", url, json=body) as r:
                    async for line in r.aiter_lines():
                        if line:
                            lines.append(line)
                return {"status": r.status_code, "lines": lines}
            r = await c.post(url, json=body, headers={"x-request-id": "obs-1"})
        except httpx.TransportError as e:
            return {"error": type(e).__name__, "lines": locals().get("lines")}
    out = {"status": r.status_code, "elapsed_s": time.monotonic() - t0,
           "removal": r.headers.get("x-removal-reason")}
    if r.status_code != 200:
        out["body"] = r.json()
    return out


@pytest.mark.parametrize("kind", ["delay", "http503", "reset", "stall"])
def test_request_kinds_behave_as_the_jax_server(kind):
    spec = f"{kind}:100:300" if kind == "delay" else f"{kind}:100"

    async def body():
        port_srv = _port_engine(spec)
        jax_srv = _jax_sim(spec, free_port())
        await port_srv.start()
        await jax_srv.start()
        try:
            mine = await _observe(port_srv.port, kind)
            ref = await _observe(jax_srv.cfg.port, kind)
            after = await _observe(port_srv.port, "none")  # still serving?
            return mine, ref, after, port_srv.chaos.triggered[kind]
        finally:
            await port_srv.stop()
            await jax_srv.stop()

    mine, ref, after, triggered = asyncio.run(body())
    assert triggered == 2
    if kind == "delay":
        assert mine["status"] == ref["status"] == 200
        assert mine["elapsed_s"] >= 0.3 and ref["elapsed_s"] >= 0.3
    elif kind == "http503":
        assert (mine["status"], mine["removal"], mine["body"]) == \
               (ref["status"], ref["removal"], ref["body"]) == \
               (503, "chaos-injected", {"error": "chaos: injected 503"})
    elif kind == "reset":
        assert mine == ref and mine["error"] == "RemoteProtocolError"
    else:  # stall: one partial event, then the connection drops mid-stream
        assert mine == ref
        assert mine["lines"] == ['data: {"choices":[{"index":0,"text":"chaos"}]}']
    if kind in ("delay",):
        assert after["status"] == 200


# ---- gateway drills over port engines (tests/test_resilience.py analogues) -------


def test_chaos_failover_breaker_opens_and_recovers():
    """Engine A resets every request: all traffic still completes through
    failover, A's breaker opens, and after the open window a half-open
    probe recovers it."""

    async def body():
        ea = _port_engine("reset:100")
        eb = _port_engine()
        await ea.start()
        await eb.start()
        cfg = f"""
pool:
  endpoints:
    - {{address: 127.0.0.1, port: {ea.port}}}
    - {{address: 127.0.0.1, port: {eb.port}}}
plugins:
  - {{type: circuit-breaker-filter}}
  - {{type: queue-scorer}}
schedulingProfiles:
  - name: default
    plugins:
      - {{pluginRef: circuit-breaker-filter}}
      - {{pluginRef: queue-scorer}}
resilience:
  maxAttempts: 3
  breakerFailureThreshold: 2
  breakerOpenS: 0.5
"""
        gw_port = free_port()
        gw = build_gateway(cfg, port=gw_port, poll_interval=0.02)
        await gw.start()
        try:
            async with httpx.AsyncClient(timeout=60) as c:
                statuses = []
                for i in range(12):
                    r = await c.post(f"http://127.0.0.1:{gw_port}/v1/completions",
                                     json={"model": "tiny", "prompt": f"p{i}",
                                           "max_tokens": 2},
                                     headers={"x-request-id": f"chaos-{i}"})
                    statuses.append(r.status_code)
                assert statuses.count(200) == len(statuses), statuses
                m = (await c.get(f"http://127.0.0.1:{gw_port}/metrics")).text
                assert _metric_value(m, 'router_endpoint_circuit_breaker_state'
                                        '{endpoint="127.0.0.1:%d"}' % ea.port) == 2.0
                assert _metric_value(m, 'router_retries_total{kind="connect"}') > 0
                assert ea.chaos.triggered["reset"] > 0

                ea.chaos.enabled = False
                await asyncio.sleep(0.6)
                served = set()
                for i in range(30):
                    r = await c.post(f"http://127.0.0.1:{gw_port}/v1/completions",
                                     json={"model": "tiny", "prompt": f"r{i}",
                                           "max_tokens": 1})
                    assert r.status_code == 200
                    served.add(r.headers["x-gateway-destination-endpoint-served"])
                    if f"127.0.0.1:{ea.port}" in served:
                        break
                assert f"127.0.0.1:{ea.port}" in served
                m = (await c.get(f"http://127.0.0.1:{gw_port}/metrics")).text
                assert _metric_value(m, 'router_endpoint_circuit_breaker_state'
                                        '{endpoint="127.0.0.1:%d"}' % ea.port) == 0.0
        finally:
            await gw.stop()
            await ea.stop()
            await eb.stop()

    asyncio.run(body())


def test_chaos_retry_budget_bounds_storm():
    """Both engines answer 503: excess failures come back at once with
    x-removal-reason, and the engines see requests + burst attempts."""

    async def body():
        ea = _port_engine("http503:100")
        eb = _port_engine("http503:100")
        await ea.start()
        await eb.start()
        cfg = f"""
pool:
  endpoints:
    - {{address: 127.0.0.1, port: {ea.port}}}
    - {{address: 127.0.0.1, port: {eb.port}}}
resilience:
  maxAttempts: 4
  retryBudgetRatio: 0
  retryBudgetMinPerSec: 0
  retryBudgetBurst: 2
  breakerFailureThreshold: 1000
"""
        gw_port = free_port()
        gw = build_gateway(cfg, port=gw_port, poll_interval=0.02)
        await gw.start()
        try:
            async with httpx.AsyncClient(timeout=30) as c:
                marked = 0
                for _ in range(6):
                    r = await c.post(f"http://127.0.0.1:{gw_port}/v1/completions",
                                     json={"model": "tiny", "prompt": "x",
                                           "max_tokens": 1})
                    assert r.status_code == 503
                    assert r.headers["x-removal-reason"] == "chaos-injected"
                    marked += r.json().get("retry") == "retry-budget-exhausted"
                assert marked >= 4
                assert ea.chaos.triggered["http503"] + eb.chaos.triggered["http503"] == 8
        finally:
            await gw.stop()
            await ea.stop()
            await eb.stop()

    asyncio.run(body())


# ---- lifecycle kinds -------------------------------------------------------------


def test_spawn_fail_raises_before_the_engine_starts():
    srv = _port_engine("spawn_fail:100")
    started = []
    srv.engine.start = lambda: started.append(1)
    with pytest.raises(RuntimeError, match="chaos spawn_fail"):
        asyncio.run(srv.start())
    assert not started and srv.chaos.triggered["spawn_fail"] == 1


def test_slow_start_and_stall_drain():
    async def body():
        srv = _port_engine("slow_start:100:400,stall_drain:100:3")
        await srv.start()
        try:
            async with httpx.AsyncClient(timeout=10) as c:
                url = f"http://127.0.0.1:{srv.port}"
                r = await c.get(url + "/health")
                assert (r.status_code, r.json()["status"]) == (503, "warming")
                m = (await c.get(url + "/metrics")).text
                assert _metric_value(m, "jetstream:num_requests_running") == 3.0
                await asyncio.sleep(0.5)
                r = await c.get(url + "/health")
                assert (r.status_code, r.json()["status"]) == (200, "ok")
        finally:
            await srv.stop()

    asyncio.run(body())


def test_engine_chaos_environment_variable(monkeypatch):
    monkeypatch.setenv("ENGINE_CHAOS", "http503:100")

    async def body():
        srv = _port_engine()
        await srv.start()
        try:
            return await _observe(srv.port, "http503")
        finally:
            await srv.stop()

    assert asyncio.run(body())["status"] == 503
