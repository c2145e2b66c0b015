"""PyTorch port, the slice as a whole: TorchEngine against TpuEngine on the CPU.

Both engines serve TINY in f32 (a model_config.json with dtype float32) with
the same weights (JAX ``init_params`` carried over by ``params_from_numpy``)
and must emit exactly the same greedy tokens, with whole-prompt and with
incremental prefill (``prefill_chunk``). Also: the port imports no JAX,
asks for the card by default, and its telemetry renders the JAX engine's
exposition.
"""

import asyncio
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine import EngineRequest as JaxRequest
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu.engine.telemetry import EngineTelemetry as JaxTelemetry
from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest
from llm_d_inference_scheduler_tpu_torch.engine.telemetry import EngineTelemetry
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_A = [1] + list(range(100, 140))            # 41 tokens: 2 full blocks
PROMPT_B = [1] + [7, 8, 9, 10] * 5                 # 21 tokens
PROMPT_C = [1] + list(range(300, 360))             # 61 tokens


async def _generate(engine, make_req, rid, prompt, max_tokens, stop=()):
    out = engine.submit(make_req(request_id=rid, prompt_token_ids=list(prompt),
                                 max_tokens=max_tokens, temperature=0.0,
                                 ignore_eos=True, stop_token_ids=tuple(stop)))
    toks, cached = [], 0
    while True:
        ev = await asyncio.wait_for(out.get(), timeout=120)
        cached = max(cached, ev.cached_tokens)
        if ev.token_id is not None:
            toks.append(ev.token_id)
        if ev.finish_reason is not None:
            return toks, cached, ev.finish_reason.value


async def _scenarios(engine, make_req):
    res = {"single": await _generate(engine, make_req, "s", PROMPT_B, 10)}
    res["concurrent"] = await asyncio.gather(
        _generate(engine, make_req, "c1", PROMPT_A, 12),
        _generate(engine, make_req, "c2", PROMPT_B, 5),
        _generate(engine, make_req, "c3", PROMPT_C, 9))
    # PROMPT_A's two complete blocks are cached now: a second identical
    # prompt continues from them through the prefix-prefill path.
    res["prefix"] = await _generate(engine, make_req, "p", PROMPT_A, 12)
    # A stop token taken from this engine's own greedy output, and a prompt
    # that reaches max_model_len (128) after 7 generated tokens.
    stop = res["single"][0][4]
    res["stop"] = await _generate(engine, make_req, "st", PROMPT_B, 10, stop=(stop,))
    res["limit"] = await _generate(engine, make_req, "lim", [1] + list(range(10, 130)), 20)
    return res


@pytest.fixture(scope="module")
def both_engines(tmp_path_factory):
    model_dir = tmp_path_factory.mktemp("tiny_f32")
    fields = dataclasses.asdict(jax_configs.TINY) | {"dtype": "float32"}
    (model_dir / "model_config.json").write_text(json.dumps(fields))
    jparams = jax_llama.init_params(jax_configs.get_config(str(model_dir)),
                                    jax.random.key(11))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    common = dict(model=str(model_dir), max_batch=4, max_model_len=128, decode_chunk=4)

    async def run_jax():
        eng = TpuEngine(JaxEngineConfig(**common, kv_events_port=0, kv_transfer="host"),
                        params=jparams)
        await eng.start()
        try:
            return await _scenarios(eng, JaxRequest)
        finally:
            await eng.stop()

    async def run_torch():
        eng = TorchEngine(EngineConfig(**common, device="cpu"), params=tparams)
        await eng.start()
        try:
            res = await _scenarios(eng, EngineRequest)
            assert eng.allocator.used_fraction == 0.0  # every block released
            return res
        finally:
            await eng.stop()

    return asyncio.run(run_jax()), asyncio.run(run_torch())


def test_engine_single_request_matches_jax(both_engines):
    jax_res, torch_res = both_engines
    assert torch_res["single"] == jax_res["single"]
    assert len(torch_res["single"][0]) == 10


def test_engine_concurrent_requests_match_jax(both_engines):
    jax_res, torch_res = both_engines
    assert torch_res["concurrent"] == jax_res["concurrent"]
    assert [len(r[0]) for r in torch_res["concurrent"]] == [12, 5, 9]


def test_engine_prefix_cache_hit_matches_jax(both_engines):
    jax_res, torch_res = both_engines
    toks, cached, _ = torch_res["prefix"]
    assert cached == 32  # two cached blocks reused
    assert torch_res["prefix"] == jax_res["prefix"]
    assert toks == torch_res["concurrent"][0][0]  # same continuation as uncached


@pytest.mark.parametrize("case,reason", [("stop", "stop"), ("limit", "length")])
def test_engine_stop_and_context_limit_match_jax(both_engines, case, reason):
    jax_res, torch_res = both_engines
    assert torch_res[case] == jax_res[case]
    assert torch_res[case][2] == reason
    if case == "limit":
        assert len(torch_res[case][0]) == 7  # positions 121..127


async def _moe_scenarios(engine, make_req):
    res = {"single": await _generate(engine, make_req, "s", PROMPT_B, 8)}
    res["pair"] = await asyncio.gather(
        _generate(engine, make_req, "c1", PROMPT_A, 8),
        _generate(engine, make_req, "c2", PROMPT_C, 6))
    res["prefix"] = await _generate(engine, make_req, "p", PROMPT_A, 8)
    return res


@pytest.fixture(scope="module")
def moe_engines(tmp_path_factory):
    """tiny-moe in f32: the JAX engine (dense MoE FFN) and the port engine
    with the grouped path (K2's plain version on the CPU) and with dense."""
    model_dir = tmp_path_factory.mktemp("tiny_moe_f32")
    fields = dataclasses.asdict(jax_configs.TINY_MOE) | {"dtype": "float32"}
    (model_dir / "model_config.json").write_text(json.dumps(fields))
    jparams = jax_llama.init_params(jax_configs.get_config(str(model_dir)),
                                    jax.random.key(11))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    common = dict(model=str(model_dir), max_batch=2, max_model_len=96, decode_chunk=4)

    async def run(engine, make_req):
        await engine.start()
        try:
            return await _moe_scenarios(engine, make_req)
        finally:
            await engine.stop()

    jax_eng = TpuEngine(JaxEngineConfig(**common, kv_events_port=0, kv_transfer="host"),
                        params=jparams)
    grouped = TorchEngine(EngineConfig(**common, device="cpu", grouped_moe=True),
                          params=tparams)
    dense = TorchEngine(EngineConfig(**common, device="cpu"), params=tparams)
    assert grouped.mcfg.moe_impl == "grouped" and dense.mcfg.moe_impl == "dense"
    return {name: asyncio.run(run(eng, req)) for name, eng, req in (
        ("jax", jax_eng, JaxRequest), ("grouped", grouped, EngineRequest),
        ("dense", dense, EngineRequest))}


@pytest.mark.parametrize("impl", ["grouped", "dense"])
@pytest.mark.parametrize("case", ["single", "pair", "prefix"])
def test_moe_engine_matches_jax(moe_engines, impl, case):
    assert moe_engines[impl][case] == moe_engines["jax"][case]
    if case == "prefix":
        assert moe_engines[impl][case][1] == 32  # two cached blocks reused


def test_moe_engine_rejects_untileable_dff(tmp_path):
    fields = dataclasses.asdict(jax_configs.TINY_MOE) | {"d_ff": 192}
    (tmp_path / "model_config.json").write_text(json.dumps(fields))
    with pytest.raises(ValueError, match="multiples of 128"):
        TorchEngine(EngineConfig(model=str(tmp_path), device="cpu", grouped_moe=True))


def test_engine_asks_for_the_card_by_default():
    assert EngineConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchEngine(EngineConfig(model="tiny"))


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    neither jax nor the JAX package in sys.modules; and an entry point asked
    for the card on a machine without one raises."""
    code = r"""
import importlib, pkgutil, sys
import llm_d_inference_scheduler_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "llm_d_inference_scheduler_tpu"
       or m.startswith("llm_d_inference_scheduler_tpu.")]
assert not bad, bad
assert len(names) >= 15, names
import torch
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
if not torch.cuda.is_available():
    try:
        TorchEngine(EngineConfig(model="tiny"))
    except RuntimeError:
        pass
    else:
        raise AssertionError("TorchEngine ran on the CPU without being asked")
print("ok", len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok")


def _normalise(text: bytes) -> list[str]:
    return [re.sub(r"_created(\{.*\})? .*", r"_created\1 TS", line)
            for line in text.decode().splitlines()]


def test_telemetry_exposition_matches_jax_engine():
    """Same families, help strings, labels, sample names and values as the
    JAX engine's prometheus_client registry (creation timestamps aside)."""
    rendered = []
    for cls in (JaxTelemetry, EngineTelemetry):
        t = cls(block_size=16, num_blocks=33)
        t.waiting.set(3)
        t.running.set(2)
        t.kv_usage.set(0.25)
        t.prompt_tokens.inc(12345678)
        t.ttft.observe(0.3)
        t.ttft.observe(20)
        t.decode_step.observe(0.004)
        t.request_success.labels(finished_reason="stop").inc()
        t.request_success.labels(finished_reason="length").inc(2)
        t.prefill_tokens_admitted.inc(5)
        t.prefix_hit_tokens.inc(3)
        rendered.append(_normalise(t.render()))
    assert rendered[0] == rendered[1]


# ---- incremental prefill (prefill_chunk) ------------------------------------

LONG = [1] + [(j * 17) % 450 + 3 for j in range(120)]
SHORT = [1] + [(j * 5) % 450 + 3 for j in range(30)]


async def _long_and_short(engine, make_req):
    """LONG submitted first, SHORT beside it; returns each one's greedy
    tokens and the time its first token was emitted."""
    first_at = {}

    async def one(rid, prompt, n):
        out = engine.submit(make_req(request_id=rid, prompt_token_ids=list(prompt),
                                     max_tokens=n, temperature=0.0, ignore_eos=True))
        toks = []
        while True:
            ev = await asyncio.wait_for(out.get(), timeout=120)
            if ev.token_id is not None:
                first_at.setdefault(rid, time.monotonic())
                toks.append(ev.token_id)
            if ev.finish_reason is not None:
                return toks

    lt, st = await asyncio.gather(one("L", LONG, 6), one("S", SHORT, 12))
    return lt, st, first_at


@pytest.fixture(scope="module")
def chunked_prefill(tmp_path_factory):
    """The LONG/SHORT pair on the JAX engine with prefill_chunk=32, and on
    port engines with prefill_chunk=32 and with whole-prompt prefill; then
    LONG twice more on the chunked port engine (the second run warm)."""
    model_dir = tmp_path_factory.mktemp("tiny_f32_chunked")
    fields = dataclasses.asdict(jax_configs.TINY) | {"dtype": "float32"}
    (model_dir / "model_config.json").write_text(json.dumps(fields))
    jparams = jax_llama.init_params(jax_configs.get_config(str(model_dir)),
                                    jax.random.key(7))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    base = dict(model=str(model_dir), max_batch=4, max_model_len=256, decode_chunk=4)

    async def run(engine, make_req, warm=False):
        await engine.start()
        try:
            res = await _long_and_short(engine, make_req)
            if not warm:
                return res
            rerun = []
            for rid in ("a", "b"):
                rerun.append(await _generate(engine, make_req, rid, LONG, 6))
            return res, rerun
        finally:
            await engine.stop()

    jax_eng = TpuEngine(JaxEngineConfig(**base, prefill_chunk=32, kv_events_port=0,
                                        kv_transfer="host"), params=jparams)
    return {
        "jax": asyncio.run(run(jax_eng, JaxRequest)),
        "whole": asyncio.run(run(TorchEngine(EngineConfig(**base, device="cpu"),
                                             params=tparams), EngineRequest)),
        "chunked": asyncio.run(run(TorchEngine(EngineConfig(**base, device="cpu",
                                                            prefill_chunk=32),
                                               params=tparams), EngineRequest,
                                   warm=True)),
    }


def test_incremental_prefill_matches_jax_and_whole_prompt(chunked_prefill):
    (lt, st, _), _ = chunked_prefill["chunked"]
    assert (lt, st) == chunked_prefill["jax"][:2]
    assert (lt, st) == chunked_prefill["whole"][:2]
    assert len(lt) == 6 and len(st) == 12


def test_incremental_prefill_lets_the_short_request_through(chunked_prefill):
    """Whole-prompt prefill lands LONG's first token first; chunked prefill
    lets SHORT's first token through between LONG's windows."""
    _, _, whole_at = chunked_prefill["whole"]
    (_, _, chunked_at), _ = chunked_prefill["chunked"]
    assert whole_at["L"] <= whole_at["S"]
    assert chunked_at["S"] < chunked_at["L"]


def test_incremental_prefill_warm_rerun_prefix_hits(chunked_prefill):
    (lt, _, _), ((a, _, _), (b, cached, _)) = chunked_prefill["chunked"]
    assert a == b == lt
    assert cached >= 112  # 7 complete blocks committed after the last window
