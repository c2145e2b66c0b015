"""PyTorch port, pipeline-parallel serving: pp engines against the JAX
single-device engine on the CPU.

Ranks on ``"cpu"``, f32, the numpy-seeded weights of ``tests/test_torch_pp.py``
given to both stacks through ``convert_jax``. Port analogues of the JAX pp
engine tests (``tests/test_pp_serve.py``), with the JAX single-device engine
as the reference:

- greedy tokens of pp engines equal the JAX engine's for ``tiny`` cut to 4
  layers at pp=2 and pp=4, ``tiny-qwen`` at pp=2 x tp=2 and ``tiny-moe`` at
  pp=2 (dense and grouped), pp=2 x ep=2 and pp=2 x tp=2 x ep=2, through
  three concurrent prompts (batch buckets 4, 2 and 1, so the lane-group
  interleave and the broadcast ring both serve), incremental prefill
  (``prefill_chunk`` 32), a prefix-cache hit (32 cached tokens, as JAX
  reports) and a multimodal prompt; embeddings within 1e-4 (abs and rel,
  the tolerance of ``tests/test_torch_parallel.py``);
- with ``prefill_batch`` 4 a pp engine makes no batched dispatch and its
  tokens are unchanged;
- the ``/kv`` wire: a pp=2 exporter's body equals a pp=1 port exporter's
  and a JAX decode engine imports it; a pp=2 decode engine imports a JAX
  export; tokens equal the monolithic ones;
- the parser takes ``--pp-size 2 --devices cpu,cpu`` and refuses
  ``--pp-size 3`` on ``tiny`` with the JAX message; a pp engine asked for
  CUDA without a card raises.
"""

import asyncio
import dataclasses
import json
import urllib.request
import uuid

import numpy as np
import pytest
import torch

from _net import free_port
from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine import EngineRequest as JaxRequest
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu.engine.server import EngineServer as JaxEngineServer
from llm_d_inference_scheduler_tpu.parallel import pp_serve as jax_pp
from llm_d_inference_scheduler_tpu_torch.engine import server as server_mod
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
from llm_d_inference_scheduler_tpu_torch.parallel import serve as par
from test_torch_parallel import PROMPT_A, PROMPT_B, PROMPT_C, _Loop, _post, _tap
from test_torch_pp import TOL, f32, seeded_params

COMMON = dict(max_batch=4, max_model_len=128, decode_chunk=4, prefill_chunk=32)
# (case, config, layers, pp, tp, ep, grouped)
CASES = [("tiny-pp2", "tiny", 4, 2, 1, 1, False), ("tiny-pp4", "tiny", 4, 4, 1, 1, False),
         ("qwen-pp2-tp2", "tiny-qwen", 2, 2, 2, 1, False),
         ("moe-pp2", "tiny-moe", 2, 2, 1, 1, False),
         ("moe-pp2-grouped", "tiny-moe", 2, 2, 1, 1, True),
         ("moe-pp2-ep2", "tiny-moe", 2, 2, 1, 2, False),
         ("moe-pp2-tp2-ep2", "tiny-moe", 2, 2, 2, 2, False)]
MM_ROWS = 2
WAVE = [[1] + [40 + 9 * i + j for j in range(12)] for i in range(4)]


def _model_dir(tmp_path_factory, name, n_layers):
    jcfg, _ = f32(name, n_layers)
    d = tmp_path_factory.mktemp(f"{name}_{n_layers}l")
    (d / "model_config.json").write_text(json.dumps(dataclasses.asdict(jcfg)))
    return str(d)


async def _gen(engine, make_req, rid, prompt, max_tokens, **kw):
    out = engine.submit(make_req(request_id=rid, prompt_token_ids=list(prompt),
                                 max_tokens=max_tokens, temperature=0.0,
                                 ignore_eos=True, **kw))
    toks, cached = [], 0
    while True:
        ev = await asyncio.wait_for(out.get(), timeout=120)
        cached = max(cached, ev.cached_tokens)
        if ev.token_id is not None:
            toks.append(ev.token_id)
        if ev.finish_reason is not None:
            assert ev.finish_reason.value != "abort"
            return toks, cached


async def _scenario(engine, make_req, mm, full):
    """Three prompts at once (A and C past the 32-token window: incremental
    prefill), A again (a prefix-cache hit), then, with ``full``, a
    multimodal prompt and four short prompts admitted as one group (a batch
    bucket of 4); last the embedding of B."""
    await engine.start()
    try:
        res = list(await asyncio.gather(_gen(engine, make_req, "a", PROMPT_A, 10),
                                        _gen(engine, make_req, "b", PROMPT_B, 6),
                                        _gen(engine, make_req, "c", PROMPT_C, 8)))
        res.append(await _gen(engine, make_req, "a2", PROMPT_A, 10))
        if full:
            res.append(await _gen(engine, make_req, "m", PROMPT_B, 5, mm_embeds=mm,
                                  mm_positions=[1, 2]))
            with engine._cond:
                wave = [asyncio.ensure_future(_gen(engine, make_req, f"w{i}", WAVE[i], 6))
                        for i in range(4)]
                await asyncio.sleep(0)  # each coroutine submits before the lock goes
            res += await asyncio.gather(*wave)
        res.append(np.asarray(engine.embed(PROMPT_B)))
        return res
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per case: the port pp engine's results and the JAX single-device
    engine's, and the steps each pp schedule took. The qk_norm config, whose
    staging the model tests hold, skips the multimodal prompt and the wave
    (each JAX engine compiles for ~20 s on one core)."""
    out, refs = {}, {}
    for case, name, L, pp, tp, ep, grouped in CASES:
        model = _model_dir(tmp_path_factory, name, L)
        jp, full = seeded_params(name, L)
        mm = np.random.default_rng(3).normal(size=(MM_ROWS, f32(name, L)[1].d_model)
                                             ).astype(np.float32)
        full_run = name != "tiny-qwen"
        if (name, L) not in refs:
            refs[name, L] = asyncio.run(_scenario(TpuEngine(JaxEngineConfig(
                model=model, **COMMON, kv_events_port=0, kv_transfer="host"),
                params=jp), JaxRequest, mm, full_run))
        eng = TorchEngine(EngineConfig(model=model, **COMMON, device="cpu", pp_size=pp,
                                       tp_size=tp, ep_size=ep, grouped_moe=grouped),
                          params=full)
        assert isinstance(eng.params, par.ShardedParams) and eng.layout.pp == pp
        assert len(eng.k_pages) == pp * tp and eng.k_pages[0].shape[0] == L // pp
        assert eng.mcfg.moe_impl == ("grouped" if grouped else "dense")
        out[case] = (asyncio.run(_scenario(eng, EngineRequest, mm, full_run)),
                     refs[name, L], dict(eng.decode_steps_by_schedule))
    return out


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_pp_engine_tokens_equal_jax_engine(served, case):
    """Tokens of the concurrent prompts, the prefix-cache hit (cached
    tokens too) and the multimodal prompt."""
    mine, ref, schedules = served[case]
    assert mine[:-1] == ref[:-1]
    lens = [10, 6, 8, 10] + ([] if case.startswith("qwen") else [5, 6, 6, 6, 6])
    assert [len(t) for t, _ in mine[:-1]] == lens
    assert mine[3][1] == 32                         # A again: two cached blocks
    if not case.startswith("qwen"):
        assert mine[4][0] != mine[1][0][:5]         # the splice moved the tokens
    # Buckets of 2 or 4 dividing by pp take the interleave; the B=1 bucket
    # the broadcast ring.
    assert schedules["interleave"] > 0 and schedules["ring"] > 0


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_pp_embeddings_match_jax_engine(served, case):
    mine, ref, _ = served[case]
    np.testing.assert_allclose(mine[-1], ref[-1], **TOL)


def test_pp_engine_makes_no_batched_prefill(tmp_path_factory):
    """With prefill_batch 4 a pp=2 engine prefills each prompt alone (the
    JAX pp engine's rule) and gives the tokens of a pp=1 engine that
    batches the same group."""
    model = _model_dir(tmp_path_factory, "tiny", 4)
    _, full = seeded_params("tiny", 4)
    prompts = [[1] + list(range(10 + 7 * i, 30 + 7 * i)) for i in range(3)]

    async def run(pp):
        eng = TorchEngine(EngineConfig(model=model, max_batch=4, max_model_len=128,
                                       decode_chunk=4, prefill_batch=4, device="cpu",
                                       pp_size=pp), params=full)
        batched = []
        run_batched = eng._run_batched_prefill
        eng._run_batched_prefill = lambda entries: (batched.append(len(entries)),
                                                    run_batched(entries))
        await eng.start()
        try:
            with eng._cond:  # one admission group
                outs = [eng.submit(EngineRequest(request_id=f"p{i}", prompt_token_ids=p,
                                                 max_tokens=5, ignore_eos=True))
                        for i, p in enumerate(prompts)]

            async def drain(o):
                toks = []
                while True:
                    ev = await asyncio.wait_for(o.get(), timeout=120)
                    if ev.token_id is not None:
                        toks.append(ev.token_id)
                    if ev.finish_reason is not None:
                        return toks
            return await asyncio.gather(*map(drain, outs)), batched
        finally:
            await eng.stop()

    staged, staged_batches = asyncio.run(run(2))
    single, single_batches = asyncio.run(run(1))
    assert staged_batches == [] and single_batches == [3]
    assert staged == single and all(len(t) == 5 for t in staged)


# ---- the /kv wire ---------------------------------------------------------------


def _get_kv(port, rid):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/kv/{rid}") as r:
        return {k.lower(): v for k, v in r.headers.items()}, r.read()


@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2)])
def test_kv_wire_between_pp_and_jax_engines(tmp_path_factory, pp, tp):
    """A pp (x tp) prefill engine's export has the single-device shape and
    headers and the bytes of a pp=1 port export; a JAX decode engine
    imports it and gives the monolithic tokens; a pp decode engine imports
    a JAX export and gives them too."""
    name, L = ("tiny", 4) if tp == 1 else ("tiny-qwen", 2)
    model = _model_dir(tmp_path_factory, name, L)
    jp, full = seeded_params(name, L)
    _, tcfg = f32(name, L)
    lp = _Loop()
    common = dict(model=model, max_batch=4, max_model_len=128, decode_chunk=4)
    servers = {}
    try:
        for key, p in (("pre_pp", pp), ("mono", 1), ("pre1", 1), ("dec_pp", pp)):
            cfg = EngineConfig(**common, device="cpu", port=0, pp_size=p,
                               tp_size=tp if p > 1 else 1)
            servers[key] = EngineServer(cfg, engine=TorchEngine(cfg, params=full))
        for key in ("jdec", "jpre"):
            jcfg = JaxEngineConfig(**common, port=free_port(), kv_events_port=0,
                                   kv_transfer="host")
            servers[key] = JaxEngineServer(jcfg, engine=TpuEngine(jcfg, params=jp))
        taps = {k: _tap(s.engine) for k, s in servers.items()}
        for s in servers.values():
            lp.run(s.start())
        port = {k: getattr(s, "port", None) or s.cfg.port for k, s in servers.items()}
        prompt = [1] + list(range(200, 240))
        body = {"prompt": prompt, "max_tokens": 6, "temperature": 0, "ignore_eos": True}
        _post(port["mono"], {**body, "request_id": "mono"})
        mono = taps["mono"]["mono"]
        assert len(mono) == 6

        remote = {"kv_transfer_params": {"do_remote_decode": True}}
        _, r1 = _post(port["pre_pp"], {**body, "max_tokens": 1, "request_id": "x", **remote})
        headers, payload = _get_kv(port["pre_pp"], "x")
        nb = int(headers["x-kv-num-blocks"])
        shape = [tcfg.n_layers, nb, tcfg.kv_block_size, tcfg.n_kv_heads, tcfg.head_dim]
        assert json.loads(headers["x-kv-shape"]) == shape
        assert headers["x-kv-dtype"] == "float32"
        assert int(headers["x-kv-seq-len"]) == len(prompt)
        _post(port["pre1"], {**body, "max_tokens": 1, "request_id": "x1", **remote})
        headers1, single = _get_kv(port["pre1"], "x1")
        assert {k: v for k, v in headers.items() if k.startswith("x-kv")} == \
            {k: v for k, v in headers1.items() if k.startswith("x-kv")}
        np.testing.assert_allclose(np.frombuffer(payload, np.float32),
                                   np.frombuffer(single, np.float32), **TOL)

        rid = f"d-{uuid.uuid4().hex[:6]}"
        _post(port["jdec"], {**body, "request_id": rid,
                             "kv_transfer_params": r1["kv_transfer_params"]})
        assert taps["jdec"][rid] == mono

        _, r2 = _post(port["jpre"], {**body, "max_tokens": 1, "request_id": "y", **remote})
        hdrs, _ = _post(port["dec_pp"], {**body, "request_id": "d2",
                                         "kv_transfer_params": r2["kv_transfer_params"]})
        assert hdrs["x-kv-pull-route"] == "host"
        assert taps["dec_pp"]["d2"] == mono
    finally:
        for s in servers.values():
            lp.run(s.stop())
        lp.close()


# ---- entry points ---------------------------------------------------------------


def test_parser_takes_pp_size_and_refuses_a_bad_one(capsys):
    cfg, _ = server_mod.parse_config(["--model", "tiny", "--pp-size", "2",
                                      "--devices", "cpu,cpu", "--kv-events-port", "0"])
    assert (cfg.pp_size, cfg.rank_devices()) == (2, ["cpu", "cpu"])
    eng = TorchEngine(cfg)
    assert eng.layout.pp == 2 and eng.device == torch.device("cpu")
    assert [tuple(k.shape[:1]) for k in eng.k_pages] == [(1,), (1,)]
    # --device cpu lays every rank on the CPU.
    cfg, _ = server_mod.parse_config(["--pp-size", "2", "--tp-size", "2", "--device", "cpu"])
    assert cfg.rank_devices() == ["cpu"] * 4
    with pytest.raises(SystemExit):
        server_mod.parse_config(["--model", "tiny", "--pp-size", "3", "--device", "cpu"])
    want = "pp_size=3 does not divide n_layers=2"
    with pytest.raises(ValueError) as jax_err:
        jax_pp.validate_pp(f32("tiny")[0], 3)
    assert str(jax_err.value) == want
    assert capsys.readouterr().err.strip().endswith(f"error: {want}")


def test_pp_engine_refuses_bad_geometry_as_jax():
    """The port analogue of ``tests/test_pp_serve.py:109``: both engines
    refuse pp=3 on tiny with the same message."""
    msgs = []
    for make in (lambda: TpuEngine(JaxEngineConfig(model="tiny", backend="tpu", pp_size=3,
                                                   kv_events_port=0, kv_transfer="host")),
                 lambda: TorchEngine(EngineConfig(model="tiny", pp_size=3, device="cpu"))):
        with pytest.raises(ValueError, match="does not divide") as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # grouped MoE stays refused wherever tp or ep shard the FFN.
    with pytest.raises(ValueError, match="the sharded path stays dense"):
        TorchEngine(EngineConfig(model="tiny-moe", device="cpu", grouped_moe=True,
                                 pp_size=2, ep_size=2))
    if not torch.cuda.is_available():
        # Asked for the card (the default) where there is none: no engine.
        with pytest.raises(ValueError, match="needs 2 CUDA devices"):
            TorchEngine(EngineConfig(model="tiny", pp_size=2, kv_events_port=0))
        with pytest.raises(RuntimeError, match="is_available"):
            TorchEngine(EngineConfig(model="tiny", pp_size=2, devices="cuda:0,cuda:0",
                                     kv_events_port=0))


