"""PyTorch port, pipeline-parallel serving: the stage checks, the model over
stages and the weights split into them, on the CPU.

Every rank lies on ``"cpu"``, in f32, with numpy-seeded weights given to
both stacks. The layouts are the ones the engine tests serve: ``tiny`` cut
to 4 layers at pp=2 and pp=4, ``tiny-qwen`` at pp=2 x tp=2, ``tiny-moe`` at
pp=2 x ep=2 and pp=2 x tp=2 x ep=2. The reference is the JAX single-device
model (the port's pp code is held against what a stage ring must compute,
not against another ring):

- ``validate_pp`` gives the JAX verdicts and messages over a grid of
  configs and degrees;
- logits and hidden states of ``forward`` through the stages, the K/V
  and last logits of ``prefill`` (a whole prompt, and a window over a
  cached prefix), a decode step by the broadcast ring (``decode_step``)
  and a K-step chunk by the lane-group interleave (greedy tokens against a
  JAX ``decode_step`` loop) agree with the JAX model within 1e-4 (abs and
  rel, the tolerance of ``tests/test_torch_parallel.py``: f32, only the
  summation order of the row-parallel sums differs); the pages written by
  each stage, joined, equal the JAX pages within the same tolerance; rows
  with mixed prior and window lengths in one staged ``prefill`` equal
  single-row calls;
- a converted HF checkpoint loads into pp x tp (x ep) shards equal to the
  slices of the full weights, and seeded weights split the same way;
- under pp alone the grouped MoE FFN (K2's plain version here) matches the
  dense one.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu.parallel import pp_serve as jax_pp
from llm_d_inference_scheduler_tpu_torch.engine import checkpoint
from llm_d_inference_scheduler_tpu_torch.models import configs, convert_hf, llama
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy
from llm_d_inference_scheduler_tpu_torch.ops.attention import paged_decode_attention
from llm_d_inference_scheduler_tpu_torch.parallel import pp_serve
from llm_d_inference_scheduler_tpu_torch.parallel import serve as par
from test_torch_model import prefill_rows_against_single, prefill_rows_case
from test_torch_parallel import _hf_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)
# (config, layers, pp, tp, ep) of every staged case.
LAYOUTS = [("tiny", 4, 2, 1, 1), ("tiny", 4, 4, 1, 1), ("tiny-qwen", 2, 2, 2, 1),
           ("tiny-moe", 2, 2, 1, 2), ("tiny-moe", 2, 2, 2, 2)]
IDS = [f"{n}-{L}l-pp{p}-tp{t}-ep{e}" for n, L, p, t, e in LAYOUTS]


def f32(name, n_layers=None):
    """(JAX config, port config) of ``name`` in f32, cut to ``n_layers``."""
    cut = {} if n_layers is None else {"n_layers": n_layers}
    return (dataclasses.replace(jax_configs.get_config(name), dtype="float32", **cut),
            dataclasses.replace(configs.get_config(name), dtype="float32", **cut))


_PARAMS = {}


def seeded_params(name, n_layers=None):
    """(JAX params, port params) of the same numpy-seeded f32 weights: normal
    / sqrt(fan in) for the matrices, 1 + N(0, 0.1) for the norms."""
    key = (name, n_layers)
    if key not in _PARAMS:
        _, tcfg = f32(name, n_layers)
        rng = np.random.default_rng(21)
        tree: dict = {"layers": {}}
        for k, shape in llama.param_shapes(tcfg).items():
            if len(shape) == 1 or k.endswith(("norm", "ln_attn", "ln_mlp")):
                a = 1.0 + 0.1 * rng.standard_normal(shape)
            else:
                a = rng.standard_normal(shape) / np.sqrt(shape[-2])
            a = a.astype(np.float32)
            if k.startswith("layers."):
                tree["layers"][k[len("layers."):]] = a
            else:
                tree[k] = a
        _PARAMS[key] = (jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu"))
    return _PARAMS[key]


def layout(pp, tp=1, ep=1):
    return par.make_serve_layout(["cpu"] * (pp * tp * ep), tp, ep, pp)


def _t(x):
    return torch.from_numpy(np.array(x))


def _split(pages, tp, pp):
    return [x.contiguous() for x in par.split_pages(_t(pages), tp, pp)]


# ---- validation and layout ----------------------------------------------------


GRID = [(2, 1, 1), (3, 1, 1), (4, 1, 1), (5, 1, 1), (8, 1, 1), (16, 1, 1),
        (2, 2, 1), (2, 3, 1), (4, 8, 1), (2, 16, 1), (2, 1, 2), (2, 1, 3),
        (4, 1, 8), (2, 2, 2), (2, 3, 2), (2, 2, 3)]


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen", "tiny-moe", "llama3-8b",
                                  "llama3-70b", "mixtral-8x7b", "qwen3-32b", "llama3-3b"])
def test_validate_pp_gives_jax_verdicts(name):
    """The same verdict and message as JAX ``validate_pp`` for every
    (pp, tp, ep) of GRID."""
    def outcome(fn, cfg, pp, tp, ep):
        try:
            fn(cfg, pp, tp, ep)
        except ValueError as e:
            return str(e)
        return None

    jcfg, tcfg = jax_configs.get_config(name), configs.get_config(name)
    verdicts = []
    for pp, tp, ep in GRID:
        ref = outcome(jax_pp.validate_pp, jcfg, pp, tp, ep)
        assert outcome(pp_serve.validate_pp, tcfg, pp, tp, ep) == ref, (pp, tp, ep)
        verdicts.append(ref)
    assert any(v is None for v in verdicts) and any(v is not None for v in verdicts)
    if name == "tiny":
        assert verdicts[GRID.index((3, 1, 1))] == "pp_size=3 does not divide n_layers=2"


def test_make_serve_layout_with_stages():
    lay = layout(2, tp=2, ep=2)
    assert len(lay.devices) == 8
    assert [(lay.stage_of(r), t, e) for r, t, e in lay.ranks()] == [
        (s, t, e) for s in range(2) for t in range(2) for e in range(2)]
    st = lay.stage(1)
    assert (st.pp, st.tp, st.ep, len(st.devices)) == (1, 2, 2, 4)
    with pytest.raises(ValueError, match="4 devices given for pp\\*tp\\*ep=2\\*2\\*2"):
        par.make_serve_layout(["cpu"] * 4, 2, 2, 2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="pp\\*tp\\*ep=2\\*1\\*1 needs 2 CUDA devices"):
            par.make_serve_layout(None, pp=2)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            par.make_serve_layout(["cuda:0", "cuda:0"], pp=2)


def test_shard_params_places_embedding_and_head_on_stage_zero():
    """Stage 0's ranks hold the embedding, the final norm and the head;
    every rank holds its stage's slab of each stacked tensor."""
    _, tcfg = f32("tiny-moe")
    _, full = seeded_params("tiny-moe")
    sp = par.shard_params(full, tcfg, layout(2, tp=2, ep=2))
    for r, shard in enumerate(sp.shards):
        s = sp.layout.stage_of(r)
        assert ("embed" in shard) == ("lm_head" in shard) == ("final_norm" in shard) == (s == 0)
        assert shard["layers"]["wq"].shape[0] == tcfg.n_layers // 2
    w1 = sp.shards[7]["layers"]["w1"]   # stage 1, tp rank 1, ep rank 1
    torch.testing.assert_close(w1, full["layers"]["w1"][1:, 2:, :, tcfg.d_ff // 2:],
                               rtol=0, atol=0)


# ---- the model against JAX ---------------------------------------------------------


_JAX = {}


def _jax_forward(name, L, tokens):
    """The JAX model's logits, K/V and hidden states, once per config."""
    if (name, L) not in _JAX:
        jcfg, _ = f32(name, L)
        jp, _ = seeded_params(name, L)
        logits, kv = jax_llama.forward(jp, jcfg, jnp.asarray(tokens), want_kv=True)
        hidden, _ = jax_llama.forward(jp, jcfg, jnp.asarray(tokens), want_hidden=True)
        _JAX[name, L] = tuple(np.asarray(a) for a in (logits, *kv, hidden))
    return _JAX[name, L]


@pytest.mark.parametrize("name,L,pp,tp,ep", LAYOUTS, ids=IDS)
def test_staged_forward_matches_jax(name, L, pp, tp, ep):
    """forward through the stages (logits, hidden states) and prefill (the
    K/V every (stage, tp) rank writes into its pages, joined, and the last
    logits) against the JAX model."""
    _, tcfg = f32(name, L)
    _, full = seeded_params(name, L)
    sp = par.shard_params(full, tcfg, layout(pp, tp, ep))
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jk, jv, jh = _jax_forward(name, L, tokens)
    tl, _ = llama.forward(sp, tcfg, _t(tokens))
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    th, _ = llama.forward(sp, tcfg, _t(tokens), want_hidden=True)
    np.testing.assert_allclose(th.numpy(), jh, **TOL)
    # Row b's 12 tokens into block 1 + b of every (stage, tp) rank's pages.
    tk, tv = par.alloc_sharded_pages(tcfg, sp.layout, 3, torch.float32)
    last, _, _ = llama.prefill(sp, tcfg, _t(tokens), _t(np.asarray([12, 12], np.int32)),
                               tk, tv, _t(np.asarray([[1], [2]], np.int32)))
    assert len(tk) == pp * tp and tk[0].shape[0] == L // pp
    np.testing.assert_allclose(last.numpy(), jl[:, -1], **TOL)
    np.testing.assert_allclose(par.join_pages(tk, tp).numpy()[:, 1:, :12], jk, **TOL)
    np.testing.assert_allclose(par.join_pages(tv, tp).numpy()[:, 1:, :12], jv, **TOL)


def _decode_case(tcfg, rng, B=4, maxB=4):
    block = tcfg.kv_block_size
    shape = (tcfg.n_layers, 1 + B * maxB, block, tcfg.n_kv_heads, tcfg.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    tables = np.arange(1, 1 + B * maxB, dtype=np.int32).reshape(B, maxB)
    tables[2] = 0                                   # a padding lane
    positions = np.asarray([37, 5, 0, 20], np.int32)[:B]
    tokens = rng.integers(0, tcfg.vocab_size, B).astype(np.int32)
    return kp, vp, tables, positions, tokens


@pytest.mark.parametrize("name,L,pp,tp,ep", LAYOUTS, ids=IDS)
def test_broadcast_ring_decode_step_matches_jax(name, L, pp, tp, ep):
    """One decode step of every lane through the stages: logits and each
    stage's page writes against JAX ``decode_step`` on the same pages."""
    jcfg, tcfg = f32(name, L)
    jp, full = seeded_params(name, L)
    sp = par.shard_params(full, tcfg, layout(pp, tp, ep))
    kp, vp, tables, positions, tokens = _decode_case(tcfg, np.random.default_rng(1))
    jl, jk, jv = jax_llama.decode_step(jp, jcfg, *map(jnp.asarray, (tokens, positions, kp,
                                                                      vp, tables)))
    ks, vs = _split(kp, tp, pp), _split(vp, tp, pp)
    tl, _, _ = llama.decode_step(sp, tcfg, _t(tokens), _t(positions), ks, vs, _t(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # Block 0 is the trash block: the padding lane writes there.
    np.testing.assert_allclose(par.join_pages(ks, tp).numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
    np.testing.assert_allclose(par.join_pages(vs, tp).numpy()[:, 1:], np.asarray(jv)[:, 1:], **TOL)


@pytest.mark.parametrize("name,L,pp,tp,ep", LAYOUTS, ids=IDS)
def test_interleaved_chunk_matches_jax_decode_loop(name, L, pp, tp, ep):
    """K=3 greedy tokens of a batch of 4 by the lane-group interleave (P
    groups of 4/P lanes, group g's token j entering stage 0 at turn g + jP)
    against a JAX ``decode_step`` + argmax loop, tokens and pages."""
    jcfg, tcfg = f32(name, L)
    jp, full = seeded_params(name, L)
    sp = par.shard_params(full, tcfg, layout(pp, tp, ep))
    kp, vp, tables, positions, tokens = _decode_case(tcfg, np.random.default_rng(2))
    K = 3
    jk, jv, tok, pos, want = jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tokens), \
        jnp.asarray(positions), []
    for _ in range(K):
        logits, jk, jv = jax_llama.decode_step(jp, jcfg, tok, pos, jk, jv, jnp.asarray(tables))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
        pos = pos + 1
    ks, vs = _split(kp, tp, pp), _split(vp, tp, pp)
    groups = []

    def sample(logits, g):
        groups.append(g)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    assert pp_serve.use_interleave(4, pp)
    out = pp_serve.interleaved_chunk(sp, tcfg, _t(tokens), _t(positions), ks, vs,
                                     _t(tables), K, sample)
    np.testing.assert_array_equal(out.numpy(), np.stack(want))
    # Each group sampled once per token, group by group in turn order.
    assert groups == [g for _ in range(K) for g in range(pp)]
    np.testing.assert_allclose(par.join_pages(ks, tp).numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
    np.testing.assert_allclose(par.join_pages(vs, tp).numpy()[:, 1:], np.asarray(jv)[:, 1:], **TOL)
    with pytest.raises(ValueError, match="divisible by pp"):
        pp_serve.interleaved_chunk(sp, tcfg, _t(tokens[:3]), _t(positions[:3]), ks, vs,
                                   _t(tables[:3]), K, sample)


@pytest.mark.parametrize("pp", [2, 4])
def test_interleaved_chunk_hands_the_kernel_aligned_group_tables(pp):
    """A block table of odd width (``--max-model-len 80`` at block 16 gives
    5) puts a lane group's rows off the 16-byte alignment K1's wrapper
    takes on the card: every group's table reaches the attention aligned
    and contiguous, and the tokens equal a JAX ``decode_step``'s."""
    jcfg, tcfg = f32("tiny", 4)
    jp, full = seeded_params("tiny", 4)
    sp = par.shard_params(full, tcfg, layout(pp))
    kp, vp, tables, positions, tokens = _decode_case(tcfg, np.random.default_rng(3), maxB=5)
    logits, _, _ = jax_llama.decode_step(jp, jcfg, *map(jnp.asarray, (tokens, positions, kp,
                                                                          vp, tables)))
    seen = []

    def attention(q, k_pages, v_pages, block_tables, *rest):
        seen.append(block_tables.is_contiguous() and block_tables.data_ptr() % 16 == 0)
        return paged_decode_attention(q, k_pages, v_pages, block_tables, *rest)

    out = pp_serve.interleaved_chunk(sp, tcfg, _t(tokens), _t(positions), _split(kp, 1, pp),
                                     _split(vp, 1, pp), _t(tables), 1,
                                     lambda lg, g: torch.argmax(lg, dim=-1).to(torch.int32),
                                     attention)
    assert len(seen) == 4 * pp and all(seen), seen
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jnp.argmax(logits, axis=-1)))


@pytest.mark.parametrize("name,L,pp,tp,ep", LAYOUTS, ids=IDS)
def test_staged_prefix_prefill_matches_jax(name, L, pp, tp, ep):
    """prefill over a cached prefix through the stages, each reading its
    layers' prior KV from its own pages, against JAX
    ``prefill_with_prefix``."""
    jcfg, tcfg = f32(name, L)
    jp, full = seeded_params(name, L)
    sp = par.shard_params(full, tcfg, layout(pp, tp, ep))
    rng = np.random.default_rng(4)
    block = tcfg.kv_block_size
    shape = (tcfg.n_layers, 6, block, tcfg.n_kv_heads, tcfg.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    row = np.asarray([[3, 1, 4, 0]], np.int32)
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :5] = rng.integers(0, tcfg.vocab_size, 5)
    args = (suffix, np.asarray([5], np.int32), np.asarray([2 * block], np.int32))
    jl, jk, jv = jax_llama.prefill_with_prefix(
        jp, jcfg, *map(jnp.asarray, args), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(row), jnp.asarray(row[:, :2]))
    ks, vs = _split(kp, tp, pp), _split(vp, tp, pp)
    tl, _, _ = llama.prefill(sp, tcfg, _t(suffix), _t(args[1]), ks, vs, _t(row), _t(args[2]),
                             _t(row[:, :2]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(par.join_pages(ks, tp).numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
    np.testing.assert_allclose(par.join_pages(vs, tp).numpy()[:, 1:], np.asarray(jv)[:, 1:], **TOL)


@pytest.mark.parametrize("name,L", [("tiny", 4), ("tiny-moe", 2)])
def test_staged_prefill_rows_match_single_rows(name, L):
    """pp=2: rows with mixed prior and window lengths in one staged prefill
    equal single-row staged calls (logits, each stage's pages joined)."""
    _, tcfg = f32(name, L)
    _, full = seeded_params(name, L)
    sp = par.shard_params(full, tcfg, layout(2))
    batched, single, (bk, bv), (sk, sv) = prefill_rows_against_single(
        sp, tcfg, prefill_rows_case(tcfg, 12), lambda a: _split(a, 1, 2))
    np.testing.assert_allclose(batched.numpy(), single.numpy(), **TOL)
    for b, s_ in ((bk, sk), (bv, sv)):
        assert len(b) == 2
        np.testing.assert_allclose(par.join_pages(b, 1).numpy()[:, 1:],
                                   par.join_pages(s_, 1).numpy()[:, 1:], **TOL)


def test_staged_multimodal_splice_matches_jax():
    """The splice happens before stage 0: pp=2 forward with encoder rows at
    two positions against the JAX forward with the same rows."""
    jcfg, tcfg = f32("tiny", 4)
    jp, full = seeded_params("tiny", 4)
    sp = par.shard_params(full, tcfg, layout(2))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab_size, (1, 10)).astype(np.int32)
    mm = rng.normal(size=(1, 2, tcfg.d_model)).astype(np.float32)
    pos = np.asarray([[1, 2]], np.int32)
    jl, _ = jax_llama.forward(jp, jcfg, jnp.asarray(tokens), mm_embeds=jnp.asarray(mm),
                              mm_positions=jnp.asarray(pos))
    tl, _ = llama.forward(sp, tcfg, _t(tokens), mm_embeds=_t(mm), mm_positions=_t(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("pp", [2])
def test_grouped_moe_under_pp_matches_dense(pp):
    """Under pp alone each stage holds its layers' experts whole, so the
    grouped FFN runs per stage: forward, prefill (last logits and pages)
    and a decode step with ``moe_impl="grouped"`` (K2's plain version on
    the CPU) against the dense FFN on the same stages."""
    _, tcfg = f32("tiny-moe")
    _, full = seeded_params("tiny-moe")
    sp = par.shard_params(full, tcfg, layout(pp))
    grouped = dataclasses.replace(tcfg, moe_impl="grouped")
    tokens = _t(np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32))
    dl, _ = llama.forward(sp, tcfg, tokens)
    gl, _ = llama.forward(sp, grouped, tokens)
    np.testing.assert_allclose(gl.numpy(), dl.numpy(), **TOL)
    pages = {}
    for cfg in (tcfg, grouped):
        k, v = par.alloc_sharded_pages(cfg, sp.layout, 3, torch.float32)
        last, _, _ = llama.prefill(sp, cfg, tokens, _t(np.asarray([12, 12], np.int32)), k, v,
                                   _t(np.asarray([[1], [2]], np.int32)))
        pages[cfg.moe_impl] = (last, par.join_pages(k, 1))
    np.testing.assert_allclose(pages["grouped"][0].numpy(), pages["dense"][0].numpy(), **TOL)
    np.testing.assert_allclose(pages["grouped"][1].numpy(), pages["dense"][1].numpy(), **TOL)
    kp, vp, tables, positions, toks = _decode_case(tcfg, np.random.default_rng(7))
    dl, _, _ = llama.decode_step(sp, tcfg, _t(toks), _t(positions), _split(kp, 1, pp),
                                 _split(vp, 1, pp), _t(tables))
    gl, _, _ = llama.decode_step(sp, grouped, _t(toks), _t(positions), _split(kp, 1, pp),
                                 _split(vp, 1, pp), _t(tables))
    np.testing.assert_allclose(gl.numpy(), dl.numpy(), **TOL)


# ---- weights into stages --------------------------------------------------------


@pytest.mark.parametrize("name,pp,tp,ep", [("tiny-qwen", 2, 2, 1), ("tiny-moe", 2, 2, 2),
                                           ("tiny", 2, 1, 1)])
def test_converted_checkpoint_loads_into_stage_shards(tmp_path, name, pp, tp, ep):
    """``convert_state_dict`` and ``load_params`` with a pp x tp (x ep)
    layout give the split of the full conversion, tensor for tensor, and
    hold no tensor a stage does not own."""
    _, cfg = f32(name)
    sd = _hf_state_dict(cfg, 9)
    lay = layout(pp, tp, ep)
    full = convert_hf.convert_state_dict(sd, cfg, device="cpu")
    want = par.shard_params(full, cfg, lay)
    got = convert_hf.convert_state_dict(sd, cfg, device="cpu", layout=lay)
    checkpoint.save_params(str(tmp_path), full)
    (tmp_path / "model_config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    loaded = checkpoint.load_params(str(tmp_path), cfg, "cpu", layout=lay)
    for w, g, ld in zip(want.shards, got.shards, loaded.shards):
        wf = llama.flat_params(w)
        for mine in (g, ld):
            mf = llama.flat_params(mine)
            assert set(mf) == set(wf)
            for k, v in mf.items():
                torch.testing.assert_close(v, wf[k], rtol=0, atol=0)
    if name == "tiny":
        # Tied embeddings: stage 0's head is its embedding's transpose.
        sd.pop("lm_head.weight")
        tied = convert_hf.convert_state_dict(sd, cfg, device="cpu", layout=lay)
        torch.testing.assert_close(tied.shards[0]["lm_head"], tied.shards[0]["embed"].t())
        assert "lm_head" not in tied.shards[1]


def test_init_params_with_stages_splits_the_seeded_weights():
    """A seed gives the pp=1 weights, split by stage then tp/ep."""
    _, cfg = f32("tiny-moe")
    full = llama.init_params(cfg, "cpu", generator=torch.Generator().manual_seed(4))
    sp = llama.init_params(cfg, "cpu", generator=torch.Generator().manual_seed(4),
                           layout=layout(2, 1, 2))
    ref = par.shard_params(full, cfg, layout(2, 1, 2))
    for mine, want in zip(sp.shards, ref.shards):
        mf, wf = llama.flat_params(mine), llama.flat_params(want)
        assert set(mf) == set(wf)
        for k, v in wf.items():
            torch.testing.assert_close(mf[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="pp_size=3 does not divide n_layers=2"):
        llama.init_params(cfg, "cpu", layout=layout(3))


def test_pages_join_and_split_round_trip():
    """join_pages joins each stage's kv-head shards, then the stages along
    the layer axis; split_pages undoes it."""
    t = torch.arange(4 * 3 * 2 * 4 * 2, dtype=torch.float32).reshape(4, 3, 2, 4, 2)
    parts = par.split_pages(t, 2, 2)
    assert [p.shape for p in parts] == [(2, 3, 2, 2, 2)] * 4
    torch.testing.assert_close(parts[3], t[2:, :, :, 2:], rtol=0, atol=0)
    torch.testing.assert_close(par.join_pages(parts, 2), t, rtol=0, atol=0)
