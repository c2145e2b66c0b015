"""PyTorch port, ops: parity with the JAX package on the CPU.

The same numpy inputs (seeded) go through the JAX op and its port, in f32.
Tolerance 2e-5 (abs and rel) unless stated: both sides compute in f32 and
differ only in summation order.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import xxhash

from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.ops import attention as jax_attn
from llm_d_inference_scheduler_tpu.ops.norms import rms_norm as jax_rms_norm
from llm_d_inference_scheduler_tpu.ops.pallas_paged_attention import (
    paged_decode_attention_pallas,
)
from llm_d_inference_scheduler_tpu.ops.rope import apply_rope as jax_apply_rope
from llm_d_inference_scheduler_tpu.ops.rope import rope_table as jax_rope_table
from llm_d_inference_scheduler_tpu.utils import hashing as jax_hashing
from llm_d_inference_scheduler_tpu_torch.models import configs
from llm_d_inference_scheduler_tpu_torch.ops import attention, paged_attention
from llm_d_inference_scheduler_tpu_torch.ops.norms import rms_norm
from llm_d_inference_scheduler_tpu_torch.ops.rope import apply_rope, rope_table
from llm_d_inference_scheduler_tpu_torch.utils import hashing

TOL = dict(rtol=2e-5, atol=2e-5)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", sorted(jax_configs._REGISTRY))
def test_config_registry_matches_jax(name):
    assert configs.get_config(name).__dict__ == jax_configs.get_config(name).__dict__


def test_config_dir_lookup(tmp_path):
    import dataclasses
    import json

    fields = dataclasses.asdict(jax_configs.TINY) | {"dtype": "float32"}
    (tmp_path / "model_config.json").write_text(json.dumps(fields))
    assert configs.get_config(str(tmp_path)).__dict__ == \
        jax_configs.get_config(str(tmp_path)).__dict__
    with pytest.raises(ValueError):
        configs.get_config(str(tmp_path / "missing"))


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 15, 31, 32, 33, 63, 64, 65, 100, 1027])
def test_xxh64_matches_xxhash(n):
    rng = random.Random(n)
    for seed in (0, 1, 2**63 + 5):
        data = bytes(rng.getrandbits(8) for _ in range(n))
        assert hashing.xxh64(data, seed) == xxhash.xxh64(data, seed=seed).intdigest()


@pytest.mark.parametrize("n_tokens,block", [(0, 16), (15, 16), (16, 16), (100, 16), (2500, 16), (37, 4)])
def test_chain_block_hashes_matches_jax(n_tokens, block):
    rng = np.random.default_rng(n_tokens)
    ids = [int(t) for t in rng.integers(0, 128_256, n_tokens)]
    text = "".join(chr(97 + t % 26) for t in ids)
    for tokens in (ids, None):
        assert hashing.chain_block_hashes("llama3-8b", tokens, text, block) == \
            jax_hashing.chain_block_hashes("llama3-8b", tokens, text, block)


@pytest.mark.parametrize("shape,eps", [((3, 5, 64), 1e-5), ((2, 4, 48), 1e-6)])
def test_rms_norm_matches_jax(shape, eps):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    np.testing.assert_allclose(rms_norm(_t(x), _t(w), eps).numpy(),
                               _np(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), eps)), **TOL)


@pytest.mark.parametrize("head_dim,theta", [(32, 10_000.0), (128, 500_000.0), (48, 1_000_000.0)])
def test_rope_matches_jax(head_dim, theta):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    x = rng.normal(size=(2, 7, 4, head_dim)).astype(np.float32)
    cos, sin = rope_table(_t(pos), head_dim, theta)
    jcos, jsin = jax_rope_table(jnp.asarray(pos), head_dim, theta)
    # Angles up to 4096 rad: f32 cos/sin of large arguments differ by a few
    # ulps of the argument between libms -> 1e-4 absolute.
    np.testing.assert_allclose(cos.numpy(), _np(jcos), atol=1e-4)
    np.testing.assert_allclose(sin.numpy(), _np(jsin), atol=1e-4)
    np.testing.assert_allclose(apply_rope(_t(x), cos, sin).numpy(),
                               _np(jax_apply_rope(jnp.asarray(x), jcos, jsin)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_causal_attention_matches_jax(masked):
    rng = np.random.default_rng(2)
    B, S, T, H, Hkv, D = 2, 5, 9, 4, 2, 32
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    kw = {}
    if masked:
        qpos = np.broadcast_to(np.arange(4, 4 + S, dtype=np.int32), (B, S)).copy()
        kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
        valid = rng.random((B, T)) > 0.3
        valid[:, 0] = True
        kw = dict(q_positions=qpos, kv_positions=kpos, kv_valid=valid)
    else:
        k, v = k[:, :S], v[:, :S]
    out = attention.causal_attention(_t(q), _t(k), _t(v), **{n: _t(a) for n, a in kw.items()})
    ref = jax_attn.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    **{n: jnp.asarray(a) for n, a in kw.items()})
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def _paged_case(seq_lens, seed=0, H=8, Hkv=2, D=32, block=16, maxB=4):
    rng = np.random.default_rng(seed)
    B = len(seq_lens)
    N = 1 + B * maxB
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(q=f(B, H, D), k_pages=f(N, block, Hkv, D), v_pages=f(N, block, Hkv, D),
                block_tables=np.arange(1, 1 + B * maxB, dtype=np.int32).reshape(B, maxB),
                seq_lens=np.asarray(seq_lens, np.int32), cur_k=f(B, Hkv, D),
                cur_v=f(B, Hkv, D))


@pytest.mark.parametrize("seq_lens_spec", [[5], [17, 3], [33, 1, 16]])
def test_paged_decode_attention_matches_jax_and_pallas(seq_lens_spec):
    """The port's plain paged attention (the CPU path of the K1 wrapper)
    against the JAX gather version and the Pallas kernel, interpreted."""
    c = _paged_case(seq_lens_spec)
    args = [c[k] for k in ("q", "k_pages", "v_pages", "block_tables", "seq_lens")]
    out = paged_attention.paged_decode_attention_cuda(*map(_t, args), _t(c["cur_k"]),
                                                      _t(c["cur_v"])).numpy()
    plain = attention.paged_decode_attention(*map(_t, args), cur_k=_t(c["cur_k"]),
                                             cur_v=_t(c["cur_v"])).numpy()
    np.testing.assert_array_equal(out, plain)
    jax_plain = jax_attn.paged_decode_attention(*map(jnp.asarray, args),
                                                cur_k=jnp.asarray(c["cur_k"]),
                                                cur_v=jnp.asarray(c["cur_v"]))
    pallas = paged_decode_attention_pallas(*map(jnp.asarray, args), jnp.asarray(c["cur_k"]),
                                           jnp.asarray(c["cur_v"]), interpret=True)
    np.testing.assert_allclose(out, _np(jax_plain), **TOL)
    np.testing.assert_allclose(out, _np(pallas), **TOL)
    assert paged_attention.launches == 0  # CPU tensors never launch the kernel


def test_paged_decode_attention_without_cur_matches_jax():
    c = _paged_case([20, 7])
    args = [c[k] for k in ("q", "k_pages", "v_pages", "block_tables", "seq_lens")]
    np.testing.assert_allclose(attention.paged_decode_attention(*map(_t, args)).numpy(),
                               _np(jax_attn.paged_decode_attention(*map(jnp.asarray, args))),
                               **TOL)


def test_paged_trash_row_sees_only_its_own_token():
    """A padding lane (seq_len 1, table all trash) attends to cur_k only."""
    c = _paged_case([20, 1], seed=1, H=4, maxB=2)
    c["block_tables"][1] = 0
    out = paged_attention.paged_decode_attention_cuda(
        *(_t(c[k]) for k in ("q", "k_pages", "v_pages", "block_tables", "seq_lens",
                             "cur_k", "cur_v")))
    np.testing.assert_allclose(out[1].numpy(), np.repeat(c["cur_v"][1], 2, axis=0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["noncontig_pages", "dtype", "head_dim", "table_dtype",
                                 "cur_shape", "group"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """The CUDA wrapper's checks (device-independent): it raises instead of
    copying pages or coercing inputs."""
    c = {k: _t(v) for k, v in _paged_case([5, 9]).items()}
    if bad == "noncontig_pages":
        c["k_pages"] = c["k_pages"].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "dtype":
        c["k_pages"] = c["k_pages"].double()
    elif bad == "head_dim":
        c = {k: _t(v) for k, v in _paged_case([5, 9], D=40).items()}
    elif bad == "table_dtype":
        c["block_tables"] = c["block_tables"].long()
    elif bad == "cur_shape":
        c["cur_k"] = c["cur_k"][:1]
    elif bad == "group":
        c = {k: _t(v) for k, v in _paged_case([5, 9], H=6, Hkv=4).items()}
    with pytest.raises(ValueError):
        paged_attention._check(c["q"], c["k_pages"], c["v_pages"], c["block_tables"],
                               c["seq_lens"], c["cur_k"], c["cur_v"])


def test_kernel_wrapper_accepts_layer_view_of_stacked_pages():
    """k_pages[l] of the engine's [L, N, block, Hkv, D] pages is contiguous:
    the wrapper takes it without a copy."""
    c = {k: _t(v) for k, v in _paged_case([5, 9]).items()}
    stacked = torch.stack([c["k_pages"], c["k_pages"]])
    paged_attention._check(c["q"], stacked[1], stacked[0], c["block_tables"],
                           c["seq_lens"], c["cur_k"], c["cur_v"])


@pytest.mark.parametrize("B,Hkv,cap,n_sm", [(1, 8, 2048, 132), (4, 8, 2048, 132),
                                          (8, 8, 1024, 132), (64, 8, 2048, 132),
                                          (3, 2, 64, 132), (8, 8, 16, 132), (2, 1, 4096, 8)])
def test_kernel_splits_cover_the_table(B, Hkv, cap, n_sm):
    """The split-K choice covers every position of the table in whole tiles,
    each split holding at least MIN_SPLIT positions when the table does."""
    S, split_len = paged_attention.splits(B, Hkv, cap, n_sm)
    assert S >= 1 and split_len % paged_attention.TILE == 0
    assert S * split_len >= cap > (S - 1) * split_len
    assert split_len >= min(cap, paged_attention.MIN_SPLIT)


def _router_case(T, E, D=128, F=128):
    gen = torch.Generator().manual_seed(0)
    lp = {"router": torch.randn(D, E, generator=gen),
          "w1": torch.zeros(E, D, F), "w3": torch.zeros(E, D, F), "w2": torch.zeros(E, F, D)}
    return lp, torch.randn(T, D, generator=gen)


@pytest.mark.parametrize("dtype,T,path", [
    (torch.bfloat16, 1, "wgmma"), (torch.bfloat16, 1100, "wgmma"),
    (torch.float32, 1, "simt"), (torch.float32, 1100, "simt"),
])
def test_grouped_kernel_path_by_dtype_and_row_tile(dtype, T, path):
    """K2's launch count per path: bf16 on wgmma and f32 on CUDA cores, at
    decode and prefill sizes alike (the glue lays both out in the one row
    tile the kernel takes)."""
    from llm_d_inference_scheduler_tpu_torch.ops import grouped_moe, moe

    lp, x = _router_case(T, 8)
    g = moe.group_rows({n: t.to(dtype) for n, t in lp.items()}, x.to(dtype), 8, 2)
    assert g.tm == moe.TILE_ROWS and g.x_pad.dtype == dtype
    assert grouped_moe.kernel_path(dtype) == path


@pytest.mark.parametrize("T,E,k,tm", [(1, 8, 2, None), (4, 8, 2, None), (1100, 8, 2, None),
                                      (4, 8, 2, 16), (300, 8, 2, 128), (3, 4, 2, 16)])
def test_group_rows_picks_row_tile_by_rows_per_expert(T, E, k, tm):
    """The glue's static buffer of ceil(T*k / tm) + E - 1 tiles: the
    kernel's tile at every size unless a tile is given (the plain version
    takes any); each expert's rows start on a tile boundary, and the rows in
    use are whole tiles."""
    from llm_d_inference_scheduler_tpu_torch.ops import moe

    lp, x = _router_case(T, E)
    g = moe.group_rows(lp, x, E, k) if tm is None else moe.group_rows(lp, x, E, k, tm=tm)
    want = moe.TILE_ROWS if tm is None else tm
    assert g.tm == want
    assert g.x_pad.shape[0] == (-(-T * k // want) + E - 1) * want
    used = int(g.rows_used[0])
    assert used % want == 0 and used <= g.x_pad.shape[0]
    starts = torch.cat([torch.zeros(1, dtype=torch.long),
                        torch.cumsum((g.counts + want - 1) // want * want, 0)[:-1]])
    for e in range(E):
        if int(g.counts[e]):
            assert int(g.tile_expert[int(starts[e]) // want]) == e
