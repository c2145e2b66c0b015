"""PyTorch port, model and sampler: parity with the JAX package on the CPU.

JAX ``init_params`` draws f32 weights; ``params_from_numpy`` carries them to
the port, so both stacks run the same model on the same seeded numpy inputs.
Tolerance for logits, K/V and pages: 1e-4 (abs and rel) — both sides are f32
and differ only in the summation order of the matmuls through two layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_inference_scheduler_tpu.engine.sampling import sample_tokens as jax_sample
from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu_torch.engine import sampling
from llm_d_inference_scheduler_tpu_torch.models import configs, llama
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = ["tiny", "tiny-qwen", "tiny-moe"]


def _f32(name):
    return (dataclasses.replace(jax_configs.get_config(name), dtype="float32"),
            dataclasses.replace(configs.get_config(name), dtype="float32"))


_PARAMS = {}


def _params(name):
    if name not in _PARAMS:
        jcfg, _ = _f32(name)
        jp = jax_llama.init_params(jcfg, jax.random.key(3))
        _PARAMS[name] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[name]


def _t(x):
    return torch.from_numpy(np.array(x))


def _pages(cfg, n_blocks, rng=None):
    shape = (cfg.n_layers, n_blocks, cfg.kv_block_size, cfg.n_kv_heads, cfg.head_dim)
    if rng is None:
        return np.zeros(shape, np.float32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_logits_and_kv_match_jax(name):
    """forward's logits and hidden states, and the K/V ``prefill`` writes
    for the same prompts (read back from the pages), against the JAX
    forward's."""
    jcfg, tcfg = _f32(name)
    jp, tp = _params(name)
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, (jk, jv) = jax_llama.forward(jp, jcfg, jnp.asarray(tokens), want_kv=True)
    tl, kv = llama.forward(tp, tcfg, _t(tokens))
    assert kv is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    hidden, _ = llama.forward(tp, tcfg, _t(tokens), want_hidden=True)
    jh, _ = jax_llama.forward(jp, jcfg, jnp.asarray(tokens), want_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), **TOL)
    # Row b's 12 tokens fill block 1 + b: its first 12 slots are the K/V.
    tk, tv = _t(_pages(tcfg, 3)), _t(_pages(tcfg, 3))
    last, _, _ = llama.prefill(tp, tcfg, _t(tokens), _t(np.asarray([12, 12], np.int32)),
                              tk, tv, _t(np.asarray([[1], [2]], np.int32)))
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **TOL)
    np.testing.assert_allclose(tk.numpy()[:, 1:, :12], np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:, :12], np.asarray(jv), **TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_write_prefill_kv_matches_jax(name):
    """The one KV scatter (``_write_kv``) against the JAX ``write_prefill_kv``
    on the same random K/V, bit for bit; then a batched prefill with a
    padded row: the pages ``prefill`` writes and its last-token logits
    against the JAX forward + ``write_prefill_kv``."""
    jcfg, tcfg = _f32(name)
    jp, tp = _params(name)
    rng = np.random.default_rng(1)
    L, B, S = tcfg.n_layers, 2, 20
    k_new = rng.normal(size=(L, B, S, tcfg.n_kv_heads, tcfg.head_dim)).astype(np.float32)
    v_new = rng.normal(size=k_new.shape).astype(np.float32)
    tables = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    seq_lens = np.asarray([20, 7], np.int32)
    jk, jv = jax_llama.write_prefill_kv(
        jnp.asarray(_pages(tcfg, 9)), jnp.asarray(_pages(tcfg, 9)), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(tables), jnp.asarray(seq_lens))
    tk, tv = _t(_pages(tcfg, 9)), _t(_pages(tcfg, 9))
    t = torch.arange(S, dtype=torch.int32)
    llama._write_kv(tk, tv, list(_t(k_new)), list(_t(v_new)), _t(tables), t.expand(B, S),
                    t < _t(seq_lens)[:, None])
    # Block 0 is the trash block: padding writes land there in an order
    # neither framework defines. Every other block must match exactly.
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])

    tokens = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    tokens[1, 7:] = 0                                  # row 1 is 7 tokens, padded
    jl, (k_new, v_new) = jax_llama.forward(jp, jcfg, jnp.asarray(tokens), want_kv=True)
    jk, jv = jax_llama.write_prefill_kv(
        jnp.asarray(_pages(tcfg, 9)), jnp.asarray(_pages(tcfg, 9)), k_new, v_new,
        jnp.asarray(tables), jnp.asarray(seq_lens))
    tk, tv = _t(_pages(tcfg, 9)), _t(_pages(tcfg, 9))
    tl, k_out, v_out = llama.prefill(tp, tcfg, _t(tokens), _t(seq_lens), tk, tv, _t(tables))
    assert k_out is tk and v_out is tv  # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[np.arange(B), seq_lens - 1], **TOL)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], **TOL)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("overshoot", [False, True])
def test_decode_step_matches_jax(name, overshoot):
    """Logits and pages after one paged decode step. With ``overshoot`` one
    lane stands past its block table (a finished lane still stepping in a
    fused chunk): JAX clamps the index silently, the port explicitly."""
    jcfg, tcfg = _f32(name)
    jp, tp = _params(name)
    rng = np.random.default_rng(2)
    block, maxB, B = tcfg.kv_block_size, 4, 3
    kp, vp = _pages(tcfg, 1 + B * maxB, rng), _pages(tcfg, 1 + B * maxB, rng)
    tables = np.arange(1, 1 + B * maxB, dtype=np.int32).reshape(B, maxB)
    tables[2] = 0  # padding lane on the trash block
    positions = np.asarray([maxB * block + 3 if overshoot else 37, 5, 0], np.int32)
    tokens = rng.integers(0, tcfg.vocab_size, B).astype(np.int32)
    jl, jk, jv = jax_llama.decode_step(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                                       jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables))
    tk, tv = _t(kp), _t(vp)
    tl, _, _ = llama.decode_step(tp, tcfg, _t(tokens), _t(positions), tk, tv, _t(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], **TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_with_prefix_matches_jax(name):
    jcfg, tcfg = _f32(name)
    jp, tp = _params(name)
    rng = np.random.default_rng(4)
    block = tcfg.kv_block_size
    prefix_len, suffix_len, S = 2 * block, 5, 8
    tokens = rng.integers(0, tcfg.vocab_size, (1, prefix_len + suffix_len)).astype(np.int32)
    row = np.asarray([[3, 1, 4, 0]], np.int32)
    # Prefix KV in the pages, from the JAX forward.
    _, (k_new, v_new) = jax_llama.forward(jp, jcfg, jnp.asarray(tokens[:, :prefix_len]),
                                          want_kv=True)
    kp, vp = jax_llama.write_prefill_kv(
        jnp.asarray(_pages(tcfg, 6)), jnp.asarray(_pages(tcfg, 6)), k_new, v_new,
        jnp.asarray(row), jnp.asarray([prefix_len], jnp.int32))
    kp, vp = np.asarray(kp), np.asarray(vp)
    suffix = np.zeros((1, S), np.int32)
    suffix[0, :suffix_len] = tokens[0, prefix_len:]
    args = (suffix, np.asarray([suffix_len], np.int32), np.asarray([prefix_len], np.int32))
    jl, jk, jv = jax_llama.prefill_with_prefix(
        jp, jcfg, *map(jnp.asarray, args), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(row), jnp.asarray(row[:, :2]))
    tk, tv = _t(kp), _t(vp)
    tl, _, _ = llama.prefill(tp, tcfg, _t(suffix), _t(args[1]), tk, tv, _t(row), _t(args[2]),
                             _t(row[:, :2]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], **TOL)
    # And the cached-prefix continuation equals the full forward's last logits.
    full, _ = llama.forward(tp, tcfg, _t(tokens))
    np.testing.assert_allclose(tl.numpy()[0], full.numpy()[0, -1], **TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_in_windows_matches_one_call(name):
    """A 50-token prompt prefilled in one call and in block-aligned windows
    (16, 16, 16 and 2 tokens, each over the blocks the ones before it
    wrote): the same pages and the same last logits."""
    _, tcfg = _f32(name)
    _, tp = _params(name)
    block, n = tcfg.kv_block_size, 50
    tokens = np.random.default_rng(10).integers(0, tcfg.vocab_size, (1, n)).astype(np.int32)
    row = _t(np.asarray([[2, 4, 1, 3]], np.int32))
    i32 = lambda *v: _t(np.asarray(v, np.int32))
    ok, ov = _t(_pages(tcfg, 5)), _t(_pages(tcfg, 5))
    whole, _, _ = llama.prefill(tp, tcfg, _t(tokens), i32(n), ok, ov, row)
    wk, wv = _t(_pages(tcfg, 5)), _t(_pages(tcfg, 5))
    for start in range(0, n, block):
        window = tokens[:, start:start + block]
        prior = {} if start == 0 else dict(prior_len=i32(start),
                                           prior_tables=row[:, :start // block])
        last, _, _ = llama.prefill(tp, tcfg, _t(window), i32(window.shape[1]), wk, wv, row,
                                   **prior)
    np.testing.assert_allclose(last.numpy(), whole.numpy(), **TOL)
    np.testing.assert_allclose(wk.numpy()[:, 1:], ok.numpy()[:, 1:], **TOL)
    np.testing.assert_allclose(wv.numpy()[:, 1:], ov.numpy()[:, 1:], **TOL)


def prefill_rows_case(tcfg, seed):
    """Three rows of one prefill call: a whole 20-token prompt, a 5-token
    window over 2 prior blocks and a 12-token one over 1, on disjoint
    block-table rows of pages whose prior blocks hold random K/V."""
    rng = np.random.default_rng(seed)
    block = tcfg.kv_block_size
    new_len = np.asarray([20, 5, 12], np.int32)
    prior_len = np.asarray([0, 2 * block, block], np.int32)
    tokens = rng.integers(0, tcfg.vocab_size, (3, 20)).astype(np.int32)
    tokens[np.arange(20)[None, :] >= new_len[:, None]] = 0
    tables = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
    kp, vp = _pages(tcfg, 13, rng), _pages(tcfg, 13, rng)
    return tokens, new_len, prior_len, tables, kp, vp


def prefill_rows_against_single(params, tcfg, case, split):
    """``prefill`` of the case's rows in one call and row by row (a row
    with no prior part takes none); returns both logits and both pages
    (``split`` lays full pages out as the params' ranks hold them, and
    joins them back)."""
    tokens, new_len, prior_len, tables, kp, vp = case
    block = tcfg.kv_block_size
    bk, bv = split(kp), split(vp)
    batched, _, _ = llama.prefill(params, tcfg, _t(tokens), _t(new_len), bk, bv, _t(tables),
                                  _t(prior_len), _t(tables[:, :2]))
    sk, sv = split(kp), split(vp)
    single = []
    for n in range(len(tokens)):
        P = prior_len[n] // block
        prior = {} if not P else dict(prior_len=_t(prior_len[n:n + 1]),
                                      prior_tables=_t(tables[n:n + 1, :P]))
        logits, _, _ = llama.prefill(params, tcfg, _t(tokens[n:n + 1, :new_len[n]]),
                                     _t(new_len[n:n + 1]), sk, sv, _t(tables[n:n + 1]),
                                     **prior)
        single.append(logits)
    return batched, torch.cat(single), (bk, bv), (sk, sv)


@pytest.mark.parametrize("name,impl", [("tiny", "dense"), ("tiny-moe", "dense"),
                                       ("tiny-moe", "grouped")])
def test_prefill_rows_match_single_rows(name, impl):
    """N rows with mixed prior_len and new_len in one call equal N
    single-row calls: logits and every block but the trash block."""
    _, tcfg = _f32(name)
    tcfg = dataclasses.replace(tcfg, moe_impl=impl)
    _, tp = _params(name)
    batched, single, (bk, bv), (sk, sv) = prefill_rows_against_single(
        tp, tcfg, prefill_rows_case(tcfg, 11), lambda a: _t(a))
    assert batched.shape == (3, tcfg.vocab_size)
    np.testing.assert_allclose(batched.numpy(), single.numpy(), **TOL)
    np.testing.assert_allclose(bk.numpy()[:, 1:], sk.numpy()[:, 1:], **TOL)
    np.testing.assert_allclose(bv.numpy()[:, 1:], sv.numpy()[:, 1:], **TOL)


def test_init_params_layout_matches_jax():
    for name in CONFIGS:
        jcfg, tcfg = _f32(name)
        jp = jax_llama.init_params(jcfg, jax.random.key(0))
        tp = llama.init_params(tcfg, "cpu", generator=torch.Generator().manual_seed(0))
        jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
        tshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]), tp)
        assert jshapes == tshapes


def test_params_from_numpy_carries_bf16():
    jcfg = jax_configs.get_config("tiny")  # bfloat16
    jp = jax_llama.init_params(jcfg, jax.random.key(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["layers"]["wq"].float().numpy(),
                                  np.asarray(jp["layers"]["wq"], np.float32))


def test_params_from_numpy_carries_moe_pytree():
    """The experts axis and the router carry over leaf by leaf: same keys,
    shapes, dtype and values."""
    jp = jax_llama.init_params(jax_configs.get_config("tiny-moe"), jax.random.key(6))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    L, E = 2, 4
    assert tp["layers"]["w1"].shape == (L, E, 128, 256)
    assert tp["layers"]["w2"].shape == (L, E, 256, 128)
    assert tp["layers"]["router"].shape == (L, 128, E)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, tp))
    for key in ("w1", "w3", "w2", "router"):
        assert tp["layers"][key].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp["layers"][key].float().numpy(),
                                      np.asarray(jp["layers"][key], np.float32))


@pytest.mark.parametrize("impl", ["dense", "grouped"])
def test_moe_decode_step_matches_jax_dense(impl):
    """tiny-moe decode step with the port's dense FFN and with its grouped
    path (K2's plain version on the CPU) against the JAX dense FFN."""
    jcfg, tcfg = _f32("tiny-moe")
    tcfg = dataclasses.replace(tcfg, moe_impl=impl)
    jp, tp = _params("tiny-moe")
    rng = np.random.default_rng(9)
    block, maxB, B = tcfg.kv_block_size, 4, 4
    kp, vp = _pages(tcfg, 1 + B * maxB, rng), _pages(tcfg, 1 + B * maxB, rng)
    tables = np.arange(1, 1 + B * maxB, dtype=np.int32).reshape(B, maxB)
    positions = np.asarray([37, 5, 0, 60], np.int32)
    tokens = rng.integers(0, tcfg.vocab_size, B).astype(np.int32)
    jl, _, _ = jax_llama.decode_step(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                                     jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables))
    tl, _, _ = llama.decode_step(tp, tcfg, _t(tokens), _t(positions), _t(kp), _t(vp),
                                 _t(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _knobs(temps, top_k, top_p):
    return sampling.SamplingKnobs.from_numpy(temps, top_k, top_p, "cpu")


def test_greedy_sampling_matches_jax_exactly():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(6, 300)).astype(np.float32)
    logits[3, [7, 40]] = 50.0  # a tie: argmax takes the first maximum
    temps = np.asarray([0.0, 0.0, -1.0, 0.0, 0.0, 0.0], np.float32)
    top_k = np.asarray([0, 5, 0, 0, 2, 0], np.int32)
    top_p = np.asarray([1.0, 1.0, 0.5, 1.0, 1.0, 0.3], np.float32)
    port = sampling.sample_tokens(_t(logits), torch.Generator().manual_seed(0),
                                  _knobs(temps, top_k, top_p)).numpy()
    ref = np.asarray(jax_sample(jnp.asarray(logits), jax.random.key(0), jnp.asarray(temps),
                                jnp.asarray(top_k), jnp.asarray(top_p)))
    np.testing.assert_array_equal(port, ref)
    assert port[3] == 7


def _kept_set(row, temp, k, p):
    """The rule in numpy: tempered, rank-based top-k, prefix-rule nucleus."""
    x = row / max(temp, 1e-4)
    order = np.argsort(-x, kind="stable")
    k = k if k > 0 else len(x)
    kept = list(order[:k])
    probs = np.exp(x[kept] - x[kept].max())
    probs /= probs.sum()
    cum = np.cumsum(probs)
    return {int(t) for t, c, q in zip(kept, cum, probs) if c - q < p}


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 3, 1.0), (0.7, 0, 0.6),
                                               (1.5, 4, 0.8), (1.0, 1, 1.0)])
def test_restricted_sampling_support_matches_jax(temp, top_k, top_p):
    """Random streams differ between frameworks: compare support sets. Both
    samplers' draws stay inside the rule's kept set, and the port's draws
    cover every kept token of probability >= 5 %."""
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(2, 40)) * 2).astype(np.float32)
    n = 300
    temps = np.full(2, temp, np.float32)
    tk = np.full(2, top_k, np.int32)
    tpp = np.full(2, top_p, np.float32)
    rows = np.repeat(logits, n // 2, axis=0)
    port = sampling.sample_tokens(
        _t(rows), torch.Generator().manual_seed(1),
        _knobs(np.repeat(temps, n // 2), np.repeat(tk, n // 2), np.repeat(tpp, n // 2))).numpy()
    ref = np.asarray(jax_sample(jnp.asarray(rows), jax.random.key(1),
                                jnp.asarray(np.repeat(temps, n // 2)),
                                jnp.asarray(np.repeat(tk, n // 2)),
                                jnp.asarray(np.repeat(tpp, n // 2))))
    for r in range(2):
        kept = _kept_set(logits[r], temp, top_k, top_p)
        sel = slice(r * (n // 2), (r + 1) * (n // 2))
        assert set(port[sel].tolist()) <= kept
        assert set(ref[sel].tolist()) <= kept
        x = logits[r] / temp
        probs = np.exp(x - x.max())
        probs = probs / probs[list(kept)].sum()
        likely = {t for t in kept if probs[t] >= 0.05}
        assert likely <= set(port[sel].tolist())
