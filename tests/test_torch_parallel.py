"""PyTorch port, tensor- and expert-parallel serving on the CPU.

Every rank lies on ``"cpu"`` (a device list may repeat a device, as the JAX
tests use virtual CPU devices), in f32, with numpy-seeded weights given to
both stacks. The JAX TP tests do not run on this image, so the reference is
the JAX single-device engine and model:

- ``validate_tp`` raises as the JAX version does;
- logits and hidden states of the sharded forward, and the K/V and
  last logits of the sharded prefill, agree with the JAX model within 1e-4
  (abs and rel: f32, only the summation order of the row-parallel sums and
  matmuls differs), and the sharded decode step and prefill over a cached
  prefix with the port's single-device ones, which
  ``tests/test_torch_model.py`` holds against JAX at the same tolerance;
- greedy tokens of the sharded engine against the JAX single-device
  engine's are in ``tests/test_torch_parallel_engine.py``;
- the ``/kv`` export of a tp=2 engine has the single-device shapes and
  headers, a JAX decode engine imports it and gives the tp=1 tokens, and a
  tp=2 decode engine imports a single-device export;
- converted HF weights load into shards equal to the split full weights;
  ``grouped_moe`` with tp or ep > 1 is refused.
"""

import asyncio
import dataclasses
import json
import threading
import urllib.request
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _net import free_port
from llm_d_inference_scheduler_tpu.engine import EngineConfig as JaxEngineConfig
from llm_d_inference_scheduler_tpu.engine.core import TpuEngine
from llm_d_inference_scheduler_tpu.engine.server import EngineServer as JaxEngineServer
from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu.parallel import serve as jax_serve
from llm_d_inference_scheduler_tpu_torch.engine import checkpoint
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
from llm_d_inference_scheduler_tpu_torch.models import configs, convert_hf, llama
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy
from llm_d_inference_scheduler_tpu_torch.parallel import serve as par

TOL = dict(rtol=1e-4, atol=1e-4)
# (config, tp, ep) of every sharded case; the MoE config takes all three.
LAYOUTS = [("tiny", 2, 1), ("tiny-qwen", 2, 1), ("tiny-moe", 2, 1),
           ("tiny-moe", 1, 2), ("tiny-moe", 2, 2)]
IDS = [f"{n}-tp{t}-ep{e}" for n, t, e in LAYOUTS]
PROMPT_A = [1] + list(range(100, 140))            # 41 tokens: 2 full blocks
PROMPT_B = [1] + [7, 8, 9, 10] * 5                 # 21 tokens
PROMPT_C = [1] + list(range(300, 360))             # 61 tokens


def _f32(name):
    return (dataclasses.replace(jax_configs.get_config(name), dtype="float32"),
            dataclasses.replace(configs.get_config(name), dtype="float32"))


_PARAMS = {}


def _params(name):
    """(JAX params, port params) of the same numpy-seeded f32 weights: normal
    / sqrt(fan in) for the matrices, 1 + N(0, 0.1) for the norms."""
    if name not in _PARAMS:
        _, tcfg = _f32(name)
        rng = np.random.default_rng(21)
        tree: dict = {"layers": {}}
        for key, shape in llama.param_shapes(tcfg).items():
            if len(shape) == 1 or key.endswith(("norm", "ln_attn", "ln_mlp")):
                a = 1.0 + 0.1 * rng.standard_normal(shape)
            else:
                a = rng.standard_normal(shape) / np.sqrt(shape[-2])
            a = a.astype(np.float32)
            if key.startswith("layers."):
                tree["layers"][key[len("layers."):]] = a
            else:
                tree[key] = a
        _PARAMS[name] = (jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu"))
    return _PARAMS[name]


def _layout(tp, ep):
    return par.make_serve_layout(["cpu"] * (tp * ep), tp, ep)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- layout and validation ----------------------------------------------------


@pytest.mark.parametrize("name,tp,ep", [
    ("llama3-8b", 3, 1), ("llama3-8b", 16, 1), ("tiny", 2, 2), ("tiny-moe", 1, 3),
    ("tiny-moe", 4, 1), ("llama3-8b", 2, 1), ("mixtral-8x7b", 2, 4)])
def test_validate_tp_raises_as_jax(name, tp, ep):
    def outcome(fn, cfg):
        try:
            fn(cfg, tp, ep)
        except ValueError as e:
            return str(e)
        return None

    ref = outcome(jax_serve.validate_tp, jax_configs.get_config(name))
    assert outcome(par.validate_tp, configs.get_config(name)) == ref
    if (name, tp) == ("llama3-8b", 3):
        assert ref == "tp=3 does not divide n_kv_heads=8"


def test_make_serve_layout():
    lay = par.make_serve_layout(["cpu"] * 4, tp=2, ep=2)
    assert list(lay.ranks()) == [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    assert lay.tp_device(1) == torch.device("cpu")
    with pytest.raises(ValueError, match="3 devices given"):
        par.make_serve_layout(["cpu"] * 3, tp=2, ep=2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 CUDA devices"):
            par.make_serve_layout(None, tp=2)


def test_grouped_moe_refused_when_sharded():
    for tp, ep in ((1, 2), (2, 1)):
        with pytest.raises(ValueError, match="the sharded path stays dense"):
            TorchEngine(EngineConfig(model="tiny-moe", device="cpu", grouped_moe=True,
                                     tp_size=tp, ep_size=ep))


def test_init_params_with_layout_splits_the_seeded_weights():
    """A seed gives the tp=1 weights, split: each shard equals the split of
    the full tensor, drawn one tensor at a time."""
    cfg = dataclasses.replace(configs.get_config("tiny-moe"), dtype="float32")
    full = llama.init_params(cfg, "cpu", generator=torch.Generator().manual_seed(4))
    sp = llama.init_params(cfg, "cpu", generator=torch.Generator().manual_seed(4),
                           layout=_layout(2, 2))
    ref = par.shard_params(full, cfg, _layout(2, 2))
    for mine, want in zip(sp.shards, ref.shards):
        for k, v in llama.flat_params(want).items():
            torch.testing.assert_close(llama.flat_params(mine)[k], v, rtol=0, atol=0)
    wq = sp.shards[2]["layers"]["wq"]      # tp rank 1: the second half of the heads
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim // 2)
    w1 = sp.shards[1]["layers"]["w1"]      # ep rank 1: experts 2 and 3, d_ff half 0
    torch.testing.assert_close(w1, full["layers"]["w1"][:, 2:, :, :cfg.d_ff // 2])


# ---- model against JAX ---------------------------------------------------------


_JAX_FORWARD = {}


def _jax_forward(name, tokens):
    """The JAX model's logits, K/V and hidden states, once per config."""
    if name not in _JAX_FORWARD:
        jcfg, _ = _f32(name)
        jp, _ = _params(name)
        logits, kv = jax_llama.forward(jp, jcfg, jnp.asarray(tokens), want_kv=True)
        hidden, _ = jax_llama.forward(jp, jcfg, jnp.asarray(tokens), want_hidden=True)
        _JAX_FORWARD[name] = tuple(np.asarray(a) for a in (logits, *kv, hidden))
    return _JAX_FORWARD[name]


@pytest.mark.parametrize("name,tp,ep", LAYOUTS, ids=IDS)
def test_sharded_model_matches_jax(name, tp, ep):
    """forward (logits, hidden) and prefill (the K/V in the pages, last
    logits) of the sharded port against the JAX model; decode_step (logits,
    pages) and prefill over a cached prefix against the port's
    single-device functions."""
    _, tcfg = _f32(name)
    _, full = _params(name)
    sp = par.shard_params(full, tcfg, _layout(tp, ep))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jk, jv, jh = _jax_forward(name, tokens)
    tl, _ = llama.forward(sp, tcfg, _t(tokens))
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    th, _ = llama.forward(sp, tcfg, _t(tokens), want_hidden=True)
    np.testing.assert_allclose(th.numpy(), jh, **TOL)
    # Row b's 12 tokens into block 1 + b of every tp rank's pages.
    tk, tv = par.alloc_sharded_pages(tcfg, sp.layout, 3, torch.float32)
    last, _, _ = llama.prefill(sp, tcfg, _t(tokens), _t(np.asarray([12, 12], np.int32)),
                               tk, tv, _t(np.asarray([[1], [2]], np.int32)))
    assert len(tk) == tp and tk[0].shape[3] == tcfg.n_kv_heads // tp
    np.testing.assert_allclose(last.numpy(), jl[:, -1], **TOL)
    np.testing.assert_allclose(par.join_kv_heads(tk).numpy()[:, 1:, :12], jk, **TOL)
    np.testing.assert_allclose(par.join_kv_heads(tv).numpy()[:, 1:, :12], jv, **TOL)

    block, maxB, B = tcfg.kv_block_size, 4, 3
    shape = (tcfg.n_layers, 1 + B * maxB, block, tcfg.n_kv_heads, tcfg.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    tables = np.arange(1, 1 + B * maxB, dtype=np.int32).reshape(B, maxB)
    tables[2] = 0
    positions = np.asarray([37, 5, 0], np.int32)
    toks = rng.integers(0, tcfg.vocab_size, B).astype(np.int32)
    rk, rv = _t(kp), _t(vp)
    rl, _, _ = llama.decode_step(full, tcfg, _t(toks), _t(positions), rk, rv, _t(tables))
    tks = [x.contiguous() for x in par.split_kv_heads(_t(kp), tp)]
    tvs = [x.contiguous() for x in par.split_kv_heads(_t(vp), tp)]
    tl, _, _ = llama.decode_step(sp, tcfg, _t(toks), _t(positions), tks, tvs, _t(tables))
    np.testing.assert_allclose(tl.numpy(), rl.numpy(), **TOL)
    np.testing.assert_allclose(par.join_kv_heads(tks).numpy()[:, 1:], rk.numpy()[:, 1:], **TOL)
    np.testing.assert_allclose(par.join_kv_heads(tvs).numpy()[:, 1:], rv.numpy()[:, 1:], **TOL)

    row = np.asarray([[3, 1, 4, 0]], np.int32)
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :5] = rng.integers(0, tcfg.vocab_size, 5)
    args = (suffix, np.asarray([5], np.int32), np.asarray([2 * block], np.int32))
    rk, rv = _t(kp), _t(vp)
    rl, _, _ = llama.prefill(full, tcfg, _t(suffix), _t(args[1]), rk, rv, _t(row),
                             _t(args[2]), _t(row[:, :2]))
    tks = [x.contiguous() for x in par.split_kv_heads(_t(kp), tp)]
    tvs = [x.contiguous() for x in par.split_kv_heads(_t(vp), tp)]
    tl, _, _ = llama.prefill(sp, tcfg, _t(suffix), _t(args[1]), tks, tvs, _t(row),
                             _t(args[2]), _t(row[:, :2]))
    np.testing.assert_allclose(tl.numpy(), rl.numpy(), **TOL)
    np.testing.assert_allclose(par.join_kv_heads(tks).numpy()[:, 1:], rk.numpy()[:, 1:], **TOL)


def test_sharded_embedding_rows_are_exact():
    """The vocab-sharded embedding (masked lookup + sum of zeros) gives
    the single-device rows bitwise, at every shard boundary."""
    _, tcfg = _f32("tiny")
    _, full = _params("tiny")
    sp = par.shard_params(full, tcfg, _layout(2, 1))
    ids = torch.tensor([[0, 255, 256, 511, 3, 300]])
    mine = llama._Model(sp).embed(ids)
    torch.testing.assert_close(mine, full["embed"][ids], rtol=0, atol=0)


def test_sharded_multimodal_splice_matches_single():
    _, tcfg = _f32("tiny")
    _, full = _params("tiny")
    sp = par.shard_params(full, tcfg, _layout(2, 1))
    rng = np.random.default_rng(5)
    tokens = _t(rng.integers(0, tcfg.vocab_size, (1, 10)).astype(np.int32))
    mm = _t(rng.normal(size=(1, 3, tcfg.d_model)).astype(np.float32))
    pos = torch.tensor([[0, 1, 2]])
    a, _ = llama.forward(full, tcfg, tokens, mm_embeds=mm, mm_positions=pos)
    b, _ = llama.forward(sp, tcfg, tokens, mm_embeds=mm, mm_positions=pos)
    np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


# ---- engine helpers ---------------------------------------------------------


async def _generate(engine, make_req, rid, prompt, max_tokens):
    out = engine.submit(make_req(request_id=rid, prompt_token_ids=list(prompt),
                                 max_tokens=max_tokens, temperature=0.0,
                                 ignore_eos=True))
    toks = []
    while True:
        ev = await asyncio.wait_for(out.get(), timeout=120)
        if ev.token_id is not None:
            toks.append(ev.token_id)
        if ev.finish_reason is not None:
            return toks


def _model_dir(tmp_path_factory, name):
    d = tmp_path_factory.mktemp(f"{name}_f32")
    fields = dataclasses.asdict(jax_configs.get_config(name)) | {"dtype": "float32"}
    (d / "model_config.json").write_text(json.dumps(fields))
    return str(d)


# ---- the /kv wire -------------------------------------------------------------


def _post(port, body, timeout=60):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return {k.lower(): v for k, v in r.headers.items()}, json.loads(r.read())


class _Loop:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _tap(engine):
    tokens: dict[str, list[int]] = {}
    emit = engine._emit

    def tap(slot, ev):
        if ev.token_id is not None:
            tokens.setdefault(ev.request_id, []).append(ev.token_id)
        emit(slot, ev)

    engine._emit = tap
    return tokens


def test_kv_export_of_tp2_engine_imports_into_jax_and_back(tmp_path_factory):
    """A tp=2 port prefill engine's ``/kv`` body has the single-device shape
    and headers; a JAX decode engine imports it and gives the tokens of a
    tp=1 port engine; a tp=2 port decode engine imports a tp=1 export."""
    model = _model_dir(tmp_path_factory, "tiny")
    jp, full = _params("tiny")
    _, tcfg = _f32("tiny")
    lp = _Loop()
    common = dict(model=model, max_batch=4, max_model_len=128, decode_chunk=4)
    servers = {}
    try:
        for key, tp in (("pre2", 2), ("mono1", 1), ("pre1", 1), ("dec2", 2)):
            cfg = EngineConfig(**common, device="cpu", port=0, tp_size=tp)
            servers[key] = EngineServer(cfg, engine=TorchEngine(cfg, params=full))
        jcfg = JaxEngineConfig(**common, port=free_port(), kv_events_port=0,
                               kv_transfer="host")
        servers["jdec"] = JaxEngineServer(jcfg, engine=TpuEngine(jcfg, params=jp))
        taps = {k: _tap(s.engine) for k, s in servers.items()}
        for s in servers.values():
            lp.run(s.start())
        port = {k: getattr(s, "port", None) or s.cfg.port for k, s in servers.items()}
        prompt = [1] + list(range(200, 240))
        body = {"prompt": prompt, "max_tokens": 6, "temperature": 0, "ignore_eos": True}
        _post(port["mono1"], {**body, "request_id": "mono"})
        mono = taps["mono1"]["mono"]
        assert len(mono) == 6

        # Export from the tp=2 engine: the body's shape is the single-device one.
        _, r1 = _post(port["pre2"], {**body, "max_tokens": 1, "request_id": "x2",
                                     "kv_transfer_params": {"do_remote_decode": True}})
        ktp = r1["kv_transfer_params"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port['pre2']}/kv/x2") as r:
            headers = {k.lower(): v for k, v in r.headers.items()}
            payload = r.read()
        nb = int(headers["x-kv-num-blocks"])
        shape = [tcfg.n_layers, nb, tcfg.kv_block_size, tcfg.n_kv_heads, tcfg.head_dim]
        assert json.loads(headers["x-kv-shape"]) == shape
        assert headers["x-kv-dtype"] == "float32"
        assert len(payload) == 2 * 4 * int(np.prod(shape))
        assert int(headers["x-kv-seq-len"]) == len(prompt)
        # Its pages equal a tp=1 engine's export of the same prompt.
        _post(port["pre1"], {**body, "max_tokens": 1, "request_id": "x1",
                             "kv_transfer_params": {"do_remote_decode": True}})
        with urllib.request.urlopen(f"http://127.0.0.1:{port['pre1']}/kv/x1") as r:
            single = np.frombuffer(r.read(), np.float32)
        np.testing.assert_allclose(np.frombuffer(payload, np.float32), single, **TOL)

        rid = f"d-{uuid.uuid4().hex[:6]}"
        _post(port["jdec"], {**body, "request_id": rid, "kv_transfer_params": ktp})
        assert taps["jdec"][rid] == mono

        _, r2 = _post(port["pre1"], {**body, "max_tokens": 1, "request_id": "y1",
                                     "kv_transfer_params": {"do_remote_decode": True}})
        hdrs, _ = _post(port["dec2"], {**body, "request_id": "d2",
                                       "kv_transfer_params": r2["kv_transfer_params"]})
        assert hdrs["x-kv-pull-route"] == "host"
        assert taps["dec2"]["d2"] == mono
    finally:
        for s in servers.values():
            lp.run(s.stop())
        lp.close()


# ---- weights into shards ------------------------------------------------------


def _hf_state_dict(cfg, seed):
    """An HF-layout state dict ([out, in] linears, per-expert tensors) of
    ``cfg`` with seeded values."""
    rng = np.random.default_rng(seed)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def r(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    sd = {"model.embed_tokens.weight": r(V, D), "model.norm.weight": r(D),
          "lm_head.weight": r(V, D)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd |= {p + "self_attn.q_proj.weight": r(Hq * Dh, D),
               p + "self_attn.k_proj.weight": r(Hkv * Dh, D),
               p + "self_attn.v_proj.weight": r(Hkv * Dh, D),
               p + "self_attn.o_proj.weight": r(D, Hq * Dh),
               p + "input_layernorm.weight": r(D),
               p + "post_attention_layernorm.weight": r(D)}
        if cfg.qk_norm:
            sd |= {p + "self_attn.q_norm.weight": r(Dh), p + "self_attn.k_norm.weight": r(Dh)}
        if cfg.n_experts:
            sd[p + "block_sparse_moe.gate.weight"] = r(cfg.n_experts, D)
            for e in range(cfg.n_experts):
                q = f"{p}block_sparse_moe.experts.{e}."
                sd |= {q + "w1.weight": r(F, D), q + "w3.weight": r(F, D),
                       q + "w2.weight": r(D, F)}
        else:
            sd |= {p + "mlp.gate_proj.weight": r(F, D), p + "mlp.up_proj.weight": r(F, D),
                   p + "mlp.down_proj.weight": r(D, F)}
    return sd


@pytest.mark.parametrize("name,tp,ep", [("tiny-qwen", 2, 1), ("tiny-moe", 2, 2)])
def test_converted_checkpoint_loads_into_shards(tmp_path, name, tp, ep):
    """``convert_state_dict`` with a layout and ``load_params`` with one give
    the split of the full conversion, tensor for tensor; a sharded engine
    serves the converted directory with the tp=1 engine's tokens."""
    _, cfg = _f32(name)
    sd = _hf_state_dict(cfg, 9)
    layout = _layout(tp, ep)
    full = convert_hf.convert_state_dict(sd, cfg, device="cpu")
    want = par.shard_params(full, cfg, layout)
    got = convert_hf.convert_state_dict(sd, cfg, device="cpu", layout=layout)
    checkpoint.save_params(str(tmp_path), full)
    (tmp_path / "model_config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    loaded = checkpoint.load_params(str(tmp_path), cfg, "cpu", layout=layout)
    for w, g, ld in zip(want.shards, got.shards, loaded.shards):
        wf = llama.flat_params(w)
        for k, v in llama.flat_params(g).items():
            torch.testing.assert_close(v, wf[k], rtol=0, atol=0)
        for k, v in llama.flat_params(ld).items():
            torch.testing.assert_close(v, wf[k], rtol=0, atol=0)

    async def tokens(tp_, ep_):
        eng = TorchEngine(EngineConfig(model=str(tmp_path), device="cpu", max_batch=2,
                                       max_model_len=128, tp_size=tp_, ep_size=ep_))
        await eng.start()
        try:
            return await _generate(eng, EngineRequest, "r", PROMPT_B, 6)
        finally:
            await eng.stop()

    assert asyncio.run(tokens(tp, ep)) == asyncio.run(tokens(1, 1))
