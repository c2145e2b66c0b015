"""PyTorch port, tensor- and expert-parallel serving: the sharded engine
against the JAX single-device engine on the CPU.

Ranks on ``"cpu"``, f32, the numpy-seeded weights of
``tests/test_torch_parallel.py`` given to both stacks. Greedy tokens of the
port at tp=2, ep=2 and tp=2 x ep=2 equal the JAX single-device engine's
(the JAX TP tests do not run on this image) for a dense config and an MoE
config through incremental prefill (``prefill_chunk`` 32), concurrency and
a prefix-cache continuation, and for a Qwen3-style ``qk_norm`` config on
one request; embeddings agree within 1e-4 (abs and rel); batched prefill on
a tp=2 engine gives the same tokens.
"""

import asyncio

import numpy as np
import pytest

from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine import EngineRequest as JaxRequest
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest
from llm_d_inference_scheduler_tpu_torch.parallel import serve as par
from test_torch_parallel import (IDS, LAYOUTS, PROMPT_A, PROMPT_B, PROMPT_C, TOL,
                                 _generate, _model_dir, _params)


# ---- engine against the JAX single-device engine ------------------------------


async def _scenario(engine, make_req, full=True):
    """Three prompts at once (with ``prefill_chunk`` 32 the two long ones
    prefill incrementally), then PROMPT_A again (a prefix-cache
    continuation); or, not ``full``, PROMPT_B alone."""
    if not full:
        return [await _generate(engine, make_req, "b", PROMPT_B, 6)]
    res = await asyncio.gather(_generate(engine, make_req, "a", PROMPT_A, 10),
                               _generate(engine, make_req, "b", PROMPT_B, 6),
                               _generate(engine, make_req, "c", PROMPT_C, 8))
    return list(res) + [await _generate(engine, make_req, "a2", PROMPT_A, 10)]


COMMON = dict(max_batch=4, max_model_len=128, decode_chunk=4, prefill_chunk=32)


async def _run(engine, make_req, embed=False, full=True):
    """The scenario's token lists, then (with ``embed``) PROMPT_B's
    embedding."""
    await engine.start()
    try:
        res = await _scenario(engine, make_req, full)
        if embed:
            res.append(np.asarray(engine.embed(PROMPT_B)))
        return res
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per config: the JAX single-device engine's results, and the port's
    at every layout of LAYOUTS (plus tp=2 with batched prefill on tiny).
    The dense and the MoE config run the whole scenario; the qk_norm one,
    whose sharding the model test holds, one request (each JAX engine
    compiles for seconds on one core)."""
    out = {}
    for name in ("tiny", "tiny-qwen", "tiny-moe"):
        model = _model_dir(tmp_path_factory, name)
        jp, full = _params(name)
        whole = name != "tiny-qwen"
        ref = asyncio.run(_run(TpuEngine(JaxEngineConfig(
            model=model, **COMMON, kv_events_port=0, kv_transfer="host"),
            params=jp), JaxRequest, embed=True, full=whole))
        for n, tp, ep in LAYOUTS:
            if n != name:
                continue
            eng = TorchEngine(EngineConfig(model=model, **COMMON, device="cpu",
                                           tp_size=tp, ep_size=ep), params=full)
            assert isinstance(eng.params, par.ShardedParams)
            assert len(eng.k_pages) == tp
            out[f"{name}-tp{tp}-ep{ep}"] = (asyncio.run(_run(eng, EngineRequest, embed=True,
                                                             full=whole)), ref)
        if name == "tiny":
            eng = TorchEngine(EngineConfig(model=model, max_batch=4, max_model_len=128,
                                           decode_chunk=4, prefill_batch=4, device="cpu",
                                           tp_size=2), params=full)
            out["tiny-batched"] = (asyncio.run(_run(eng, EngineRequest)), ref)
    return out


@pytest.mark.parametrize("case", IDS)
def test_sharded_engine_tokens_equal_jax_engine(served, case):
    mine, ref = served[case]
    assert mine[:-1] == ref[:-1]
    lens = [6] if case.startswith("tiny-qwen") else [10, 6, 8, 10]
    assert [len(t) for t in mine[:-1]] == lens


@pytest.mark.parametrize("case", IDS)
def test_sharded_embeddings_match_jax_engine(served, case):
    mine, ref = served[case]
    np.testing.assert_allclose(mine[-1], ref[-1], **TOL)


def test_sharded_batched_prefill_tokens_equal_jax_engine(served):
    mine, ref = served["tiny-batched"]
    assert mine[:4] == ref[:4]
