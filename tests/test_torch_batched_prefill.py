"""PyTorch port, batched prefill (``prefill_batch``), against the JAX engine
on the CPU.

The JAX engine (``TpuEngine``, ``prefill_batch=4``), the port with
``prefill_batch=4`` and the port's single path (``prefill_batch=1``) serve
TINY in f32 with the same weights through one sequence of waves, each wave
submitted while the engine's admission lock is held, so that it is admitted
as one group:

- cold: six distinct 41-token prompts (one bucket: a batch of four, one of
  two);
- warm: the same six again (prefix-cache hits: the single path);
- duplicates: a chain four times in one group with two other prompts (the
  first copy batches with them, the other three reroute to the single path
  after the batch committed its hashes and report cached tokens);
- fuzz: short and long prompts (the long ones past the 64-token incremental
  window), repeated chains, varied max_tokens, some aborted after their
  first token.

Greedy tokens and cached-token counts are equal across the three engines
(in the fuzz the tokens only, an aborted request's first only: when an
abort lands decides what is cached when the next requests are admitted),
the port's batched path really ran,
and every block comes back. Also: grouped MoE (K2's plain version on the
CPU) gives the single path's tokens with padding rows in the batch; a
failed batched dispatch answers its whole group and frees its blocks; the
warm-up runs one batched prefill and leaves no trace.
"""

import asyncio
import dataclasses
import json
import random
import threading

import jax
import numpy as np
import pytest

from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine import EngineRequest as JaxRequest
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest, FinishReason
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy

COMMON = dict(max_batch=6, max_model_len=256, decode_chunk=4, prefill_chunk=64)


def _prompt(i: int, n: int = 40) -> list[int]:
    return [1] + [(i * 13 + j * 7) % 400 + 3 for j in range(n)]


def _fuzz_plan() -> list[list[tuple]]:
    """Three waves of (rid, prompt, max_tokens, abort after the first
    token), drawn up front so that every engine gets the same plan."""
    rng = random.Random(11)
    waves = []
    for w in range(3):
        wave = []
        for i in range(10):
            n = rng.choice([8, 30, 30, 90, 150])
            base = rng.randrange(3)  # repeated chains
            prompt = [1] + [(base * 131 + j * 7) % 400 + 3 for j in range(n)]
            wave.append((f"fz{w}-{i}", prompt, rng.choice([1, 4, 9]), rng.random() < 0.25))
        waves.append(wave)
    return waves


async def _collect(engine, out, rid, kill):
    toks, cached = [], 0
    while True:
        ev = await asyncio.wait_for(out.get(), timeout=120)
        cached = max(cached, ev.cached_tokens or 0)
        if ev.token_id is not None:
            toks.append(ev.token_id)
            if kill and len(toks) == 1:
                engine.abort(rid)
        if ev.finish_reason is not None:
            return toks, cached, ev.finish_reason.value


async def _wave(engine, make_req, wave):
    """Submit a whole wave under the engine's admission lock (reentrant),
    so that the engine thread admits it as one group."""
    outs = []
    with engine._cond:
        for rid, prompt, max_tokens, _ in wave:
            outs.append(engine.submit(make_req(
                request_id=rid, prompt_token_ids=list(prompt), max_tokens=max_tokens,
                temperature=0.0, ignore_eos=True)))
    return await asyncio.gather(*[_collect(engine, o, w[0], w[3])
                                  for o, w in zip(outs, wave)])


def _free(engine) -> int:
    return getattr(engine.allocator, "reusable_blocks", engine.allocator.free_blocks)


async def _scenario(engine, make_req):
    await engine.start()
    try:
        cold = [(f"c{i}", _prompt(i), 5, False) for i in range(6)]
        res = {"cold": await _wave(engine, make_req, cold),
               "warm": await _wave(engine, make_req,
                                   [(f"w{i}", p, n, k) for i, (_, p, n, k) in enumerate(cold)])}
        dup = _prompt(50)
        res["dup"] = await _wave(engine, make_req, [
            ("d0", dup, 4, False), ("d1", dup, 4, False), ("x0", _prompt(51), 4, False),
            ("x1", _prompt(52), 4, False), ("d2", dup, 4, False), ("d3", dup, 4, False)])
        plan = _fuzz_plan()
        fuzz = []
        for wave in plan:
            fuzz += await _wave(engine, make_req, wave)
        # When an abort lands decides which waiting requests are admitted
        # together, and so their cache hits, and an aborted request's later
        # tokens: the tokens are compared, an aborted request's first only.
        kills = [w[3] for wave in plan for w in wave]
        assert all(r[2] == "length" or kill and r[2] == "abort"
                   for r, kill in zip(fuzz, kills))
        res["fuzz"] = [r[0][:1] if kill else r[0] for r, kill in zip(fuzz, kills)]
        res["blocks_back"] = _free(engine) == engine.n_blocks - 1
        return res
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_f32")
    fields = dataclasses.asdict(jax_configs.TINY) | {"dtype": "float32"}
    (d / "model_config.json").write_text(json.dumps(fields))
    jparams = jax_llama.init_params(jax_configs.get_config(str(d)), jax.random.key(7))
    return str(d), jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _port_engine(model, tparams, **kw):
    return TorchEngine(EngineConfig(model=model, device="cpu", kv_events_port=0,
                                    **COMMON, **kw), params=tparams)


def _record_batches(engine) -> list[int]:
    """Row counts of the engine's batched prefill dispatches."""
    sizes = []
    run = engine._run_batched_prefill

    def recorded(entries):
        sizes.append(len(entries))
        return run(entries)

    engine._run_batched_prefill = recorded
    return sizes


@pytest.fixture(scope="module")
def served(weights):
    model, jparams, tparams = weights
    jax_eng = TpuEngine(JaxEngineConfig(model=model, kv_events_port=0, kv_transfer="host",
                                        prefill_batch=4, **COMMON), params=jparams)
    port = _port_engine(model, tparams, prefill_batch=4)
    sizes = _record_batches(port)
    single = _port_engine(model, tparams)
    return {"jax": asyncio.run(_scenario(jax_eng, JaxRequest)),
            "port": asyncio.run(_scenario(port, EngineRequest)),
            "single": asyncio.run(_scenario(single, EngineRequest)),
            "sizes": sizes}


@pytest.mark.parametrize("case", ["cold", "warm", "dup", "fuzz"])
def test_batched_prefill_matches_jax_and_the_single_path(served, case):
    assert served["port"][case] == served["jax"][case]
    assert served["port"][case] == served["single"][case]


def test_batched_prefill_ran_and_returned_every_block(served):
    # Cold: a batch of four and one of two; duplicates: one of three.
    assert served["sizes"][:3] == [4, 2, 3], served["sizes"]
    assert all(served[k]["blocks_back"] for k in ("jax", "port", "single"))
    # The rerouted duplicates took the committed blocks as a prefix hit.
    cached = [c for _, c, _ in served["port"]["dup"]]
    assert [c >= 32 for c in cached] == [False, True, False, False, True, True]
    warm = [c for _, c, _ in served["port"]["warm"]]
    assert all(c == 32 for c in warm)


def test_grouped_moe_batched_prefill_keeps_the_single_path_tokens(tmp_path):
    """tiny-moe with the grouped FFN: a batch of prompts of other lengths
    (padding rows routed through the experts beside the real ones) gives
    each prompt the tokens it gets alone."""
    fields = dataclasses.asdict(jax_configs.TINY_MOE) | {"dtype": "float32"}
    (tmp_path / "model_config.json").write_text(json.dumps(fields))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jax_llama.init_params(
        jax_configs.get_config(str(tmp_path)), jax.random.key(3))), "cpu")
    wave = [(f"m{i}", _prompt(60 + i, n), 6, False) for i, n in enumerate((20, 28, 17, 31))]

    async def run(engine):
        await engine.start()
        try:
            return await _wave(engine, EngineRequest, wave)
        finally:
            await engine.stop()

    batched = _port_engine(str(tmp_path), tparams, prefill_batch=4, grouped_moe=True)
    sizes = _record_batches(batched)
    got = asyncio.run(run(batched))
    assert sizes == [4]
    assert got == asyncio.run(run(_port_engine(str(tmp_path), tparams, grouped_moe=True)))


def test_failed_batched_dispatch_answers_the_group_and_frees_its_blocks(weights):
    model, _, tparams = weights
    engine = _port_engine(model, tparams, prefill_batch=4)
    rows = engine._prefill_rows

    def broken(reqs, prompts, rows_np, **mm):
        if len(prompts) > 1:
            raise RuntimeError("device fault")
        return rows(reqs, prompts, rows_np, **mm)

    engine._prefill_rows = broken
    # The loop's failure handler aborts whatever is queued when it runs:
    # the next wave waits for it.
    handled = threading.Event()
    abort_all = engine._abort_all
    engine._abort_all = lambda: (abort_all(), handled.set())

    async def run():
        await engine.start()
        try:
            failed = await _wave(engine, EngineRequest,
                                 [(f"f{i}", _prompt(i), 4, False) for i in range(3)])
            assert await asyncio.to_thread(handled.wait, 30)
            after = await _wave(engine, EngineRequest, [("ok", _prompt(9), 4, False)])
            return failed, after, _free(engine)
        finally:
            await engine.stop()

    failed, after, free = asyncio.run(run())
    assert [r[2] for r in failed] == ["abort"] * 3 and all(not r[0] for r in failed)
    assert after[0][2] == "length" and len(after[0][0]) == 4  # the engine serves on
    assert free == engine.n_blocks - 1


def test_warmup_runs_a_batched_prefill_and_leaves_no_trace(weights):
    model, _, tparams = weights
    engine = _port_engine(model, tparams, prefill_batch=4, warmup=True)
    calls = []
    rows = engine._prefill_rows
    engine._prefill_rows = lambda reqs, prompts, r, **mm: (
        calls.append(len(prompts)), rows(reqs, prompts, r, **mm))[1]

    async def run():
        await engine.start()
        try:
            return await _wave(engine, EngineRequest, [("a", _prompt(1), 3, False)])
        finally:
            await engine.stop()

    got = asyncio.run(run())
    assert 4 in calls and engine.failure is None
    assert engine.telemetry.prefill_step.count == 1  # the one served prefill
    assert got[0][2] == FinishReason.LENGTH.value and _free(engine) == engine.n_blocks - 1


def test_causal_attention_in_row_chunks_equals_whole(monkeypatch):
    """A batch whose f32 logits pass the cap runs a few rows at a time, with
    the same result."""
    import torch

    from llm_d_inference_scheduler_tpu_torch.ops import attention

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(5, 12, h, 8, generator=g) for h in (4, 2, 2))
    valid = torch.arange(12)[None, :] < torch.tensor([12, 7, 3, 12, 9])[:, None]
    whole = attention.causal_attention(q, k, v, kv_valid=valid)
    monkeypatch.setattr(attention, "LOGITS_BYTES_CAP", 2 * 4 * 12 * 12 * 4)  # 2 rows
    assert torch.equal(attention.causal_attention(q, k, v, kv_valid=valid), whole)
