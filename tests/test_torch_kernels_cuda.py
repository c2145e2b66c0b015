"""PyTorch port, CUDA kernels on the card: each kernel against its plain
PyTorch version. Marked ``cuda``; skipped where torch sees no GPU (a CUDA
kernel has no interpret mode). ``chip_smoke.py`` runs the same comparisons at
full width on every chip run.

Tolerances: f32 1e-5 (summation order only); bf16 1e-3 abs + 1e-2 rel (both
versions compute in f32 and round the result to bf16 once, and one bf16 step
is at most 2**-7 of the value; the abs term covers outputs near zero).
The grouped MoE FFN (K2) rounds twice (act, then the output) and sums over
D then F: f32 within 1e-4 of rms(plain), bf16 within 1e-2 |plain| + 1e-2
rms(plain), the rms over the routed rows (an act value one bf16 step off
moves the output by that step times a weight).
The prefill attention (K3) is held against the plain version in f32 on the
same bf16 inputs (products of two bf16 values are exact in f32): its output
rounds once to bf16 (2**-8 of the value) and P rounds to bf16 before the
P.V product, which moves an output by at most 2**-9 * max|v| (the sum of
the rounding errors of weights that sum to one); 1e-5 more covers the order
of the sums. Its f32 path differs only in the order of the sums: 1e-5.
K4 (RMSNorm, QK-norm and RoPE) states its tolerances above its tests.
"""

import dataclasses

import pytest
import torch

from llm_d_inference_scheduler_tpu_torch import ops
from llm_d_inference_scheduler_tpu_torch.models import configs, llama
from llm_d_inference_scheduler_tpu_torch.ops import (
    attention,
    fused_norm,
    grouped_moe,
    moe,
    paged_attention,
    prefill_attention,
)
from llm_d_inference_scheduler_tpu_torch.ops.rope import rope_table

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 1e-2)}


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _case(gen, seq_lens, H, Hkv, D, dtype, block=16, maxB=8):
    B = len(seq_lens)
    N = 1 + B * maxB
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    tables = (torch.randperm(N - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    tables = tables.reshape(B, maxB).contiguous()
    for b, s in enumerate(seq_lens):
        if s == 1:
            tables[b] = 0
    return (r(B, H, D), r(N, block, Hkv, D), r(N, block, Hkv, D), tables,
            torch.tensor(seq_lens, dtype=torch.int32, device="cuda"),
            r(B, Hkv, D), r(B, Hkv, D))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq_lens,H,Hkv,D", [
    ([5], 8, 2, 32), ([17, 3], 8, 2, 32), ([33, 1, 16], 8, 2, 32),
    ([1, 17, 33, 128, 129], 32, 8, 128), ([64, 2, 100], 32, 8, 64),
    ([40, 7], 4, 2, 48), ([9, 130], 8, 8, 256),
])
def test_paged_decode_kernel_matches_plain(gpu, seq_lens, H, Hkv, D, dtype):
    args = _case(gpu, seq_lens, H, Hkv, D, dtype)
    before = paged_attention.launches
    out = paged_attention.paged_decode_attention_cuda(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = attention.paged_decode_attention(*args)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv", [(16, 4), (8, 2), (4, 1)])
def test_paged_decode_kernel_at_local_heads(gpu, H, Hkv, dtype):
    """One tp rank's heads of llama3-8b (tp = 2, 4, 8), head_dim 128."""
    args = _case(gpu, [1, 17, 33, 100, 128, 5], H, Hkv, 128, dtype, maxB=16)
    out = paged_attention.paged_decode_attention_cuda(*args)
    torch.cuda.synchronize()
    ref = attention.paged_decode_attention(*args)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("name,tp,ep", [("tiny", 2, 1), ("tiny-moe", 2, 2)])
def test_sharded_decode_step_on_one_card(gpu, name, tp, ep):
    """tp x ep ranks laid on the one card: the decode step launches K1 once
    per tp rank and layer and agrees with the single-device step in f32."""
    from llm_d_inference_scheduler_tpu_torch.parallel import serve as par

    cfg = dataclasses.replace(configs.get_config(name), dtype="float32")
    params = llama.init_params(cfg, "cuda", generator=gpu)
    sp = par.shard_params(params, cfg, par.make_serve_layout(["cuda:0"] * (tp * ep), tp, ep))
    B, maxB = 3, 4
    shape = (cfg.n_layers, 1 + B * maxB, cfg.kv_block_size, cfg.n_kv_heads, cfg.head_dim)
    kp = torch.randn(shape, generator=gpu, device="cuda")
    vp = torch.randn(shape, generator=gpu, device="cuda")
    tables = torch.arange(1, 1 + B * maxB, dtype=torch.int32, device="cuda").reshape(B, maxB)
    tokens = torch.tensor([5, 9, 300], device="cuda")
    positions = torch.tensor([37, 3, 50], dtype=torch.int32, device="cuda")
    ref, rk, rv = llama.decode_step(params, cfg, tokens, positions, kp.clone(), vp.clone(),
                                    tables)
    ks = [t.contiguous() for t in par.split_kv_heads(kp.clone(), tp)]
    vs = [t.contiguous() for t in par.split_kv_heads(vp.clone(), tp)]
    before = paged_attention.launches
    out, _, _ = llama.decode_step(sp, cfg, tokens, positions, ks, vs, tables)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + tp * cfg.n_layers
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(par.join_kv_heads(ks)[:, 1:], rk[:, 1:], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen"])
def test_decode_step_kernel_matches_plain(gpu, name):
    cfg = dataclasses.replace(configs.get_config(name), dtype="float32")
    params = llama.init_params(cfg, "cuda", generator=gpu)
    B, maxB = 3, 4
    shape = (cfg.n_layers, 1 + B * maxB, cfg.kv_block_size, cfg.n_kv_heads, cfg.head_dim)
    kp = torch.randn(shape, generator=gpu, device="cuda")
    vp = torch.randn(shape, generator=gpu, device="cuda")
    tables = torch.arange(1, 1 + B * maxB, dtype=torch.int32, device="cuda").reshape(B, maxB)
    tokens = torch.tensor([5, 9, 300], device="cuda")
    positions = torch.tensor([37, 3, 70], dtype=torch.int32, device="cuda")  # 70: overshoot
    kern, kk, kv = llama.decode_step(params, cfg, tokens, positions, kp.clone(), vp.clone(),
                                     tables)
    plain, pk, pv = llama.decode_step(params, cfg, tokens, positions, kp.clone(), vp.clone(),
                                      tables, paged_attention=attention.paged_decode_attention)
    torch.testing.assert_close(kern, plain, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(kk, pk, atol=1e-4, rtol=1e-4)


# seq_len values (cached positions + 1) around the kernel's share sizes:
# nothing cached, one position, a 64-position tile +-1, split_len +-1 and
# the full 256-position table.
def _length_pool(split_len, cap):
    return [1, 2, 64, 65, 66, split_len, split_len + 1, split_len + 2, cap, cap + 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D", [(8, 8, 64), (32, 8, 128), (16, 2, 256), (32, 4, 64),
                                     (64, 8, 128), (32, 1, 64)])
@pytest.mark.parametrize("B", [1, 2, 5, 8])
def test_paged_decode_kernel_lengths(gpu, B, H, Hkv, D, dtype):
    """One launch per call at every length class, batch 1-8 and q_per_kv 1,
    4, 8 and 32; the ticket buffer is left zero for the next call."""
    block, maxB = 16, 16
    cap = block * maxB
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    _, split_len = paged_attention.splits(B, Hkv, cap, n_sm)
    pool = _length_pool(split_len, cap)
    batches = ([[n] for n in pool] if B == 1 else
               [[pool[(i + j) % len(pool)] for i in range(B)] for j in (0, B)])
    atol, rtol = TOL[dtype]
    for seq_lens in batches:
        args = _case(gpu, seq_lens, H, Hkv, D, dtype, block=block, maxB=maxB)
        before = paged_attention.launches
        out = paged_attention.paged_decode_attention_cuda(*args)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        ref = attention.paged_decode_attention(*args)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
        assert int(paged_attention._tickets[torch.cuda.current_device()].count_nonzero()) == 0


def test_paged_decode_kernel_is_one_launch(gpu):
    from torch.profiler import ProfilerActivity, profile

    args = _case(gpu, [104, 2, 127, 100], 32, 8, 128, torch.bfloat16)
    paged_attention.paged_decode_attention_cuda(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            paged_attention.paged_decode_attention_cuda(*args)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0]
    kernels = [n for n in names if "paged_decode" in n]
    assert len(kernels) == 1 and "mma" in kernels[0], names
    assert sum(e.count for e in prof.key_averages() if e.key == kernels[0]) == 3


def test_kernel_rejects_cpu_pages_with_cuda_query(gpu):
    args = list(_case(gpu, [5], 8, 2, 32, torch.float32))
    args[1] = args[1].cpu()
    with pytest.raises(ValueError):
        paged_attention.paged_decode_attention_cuda(*args)


def _moe_case(gen, T, E, k, D, F, dtype, hot=None, empty=None):
    """Routed rows of T tokens over E experts: a random router, or every
    token on expert ``hot``, or expert ``empty`` never chosen."""
    r = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen, device="cuda")
                                   * scale).to(dtype)
    lp = {"router": r(D, E, scale=D ** -0.5), "w1": r(E, D, F, scale=D ** -0.5),
          "w3": r(E, D, F, scale=D ** -0.5), "w2": r(E, F, D, scale=F ** -0.5)}
    x = r(T, D)
    # Feature 0 is 1 in every token, so a bias on its router row moves every
    # token's logit for that expert the same way.
    x[:, 0] = 1.0
    if hot is not None:
        lp["router"][0, hot] += 100.0
    if empty is not None:
        lp["router"][0, empty] -= 100.0
    return lp, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,k,hot,empty", [
    (1, 4, 2, None, None),      # fewer rows than a tile, padding tiles
    (5, 8, 2, None, 3),         # an empty expert
    (40, 4, 1, 2, None),        # all rows on one expert
    (300, 8, 2, None, None),    # tm 64, several tiles per expert
])
def test_grouped_moe_kernel_matches_plain(gpu, T, E, k, hot, empty, dtype):
    lp, x = _moe_case(gpu, T, E, k, 256, 384, dtype, hot, empty)
    g = moe.group_rows(lp, x, E, k)
    x_pad, te, tm = g.x_pad, g.tile_expert, g.tm
    w1, w3, w2 = lp["w1"], lp["w3"], lp["w2"]
    before = grouped_moe.launches
    out = grouped_moe.grouped_ffn_cuda(x_pad, te, w1, w3, w2, tm, g.rows_used)
    torch.cuda.synchronize()
    assert grouped_moe.launches == before + 1
    ref = moe.grouped_ffn_reference(x_pad, te, w1, w3, w2, tm)
    routed = ref.float()[ref.float().abs().amax(-1) > 0]
    rms = float(routed.pow(2).mean().sqrt())
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-4 * rms
    else:
        assert bool((err <= 1e-2 * ref.float().abs() + 1e-2 * rms).all())
    # Padding tiles are skipped and come out zero.
    assert (out[int(g.rows_used[0]):] == 0).all()


def _check_grouped(lp, x, E, k, dtype):
    g = moe.group_rows(lp, x, E, k)
    w1, w3, w2 = lp["w1"], lp["w3"], lp["w2"]
    path = grouped_moe.kernel_path(dtype)
    before = grouped_moe.path_launches[path]
    out = grouped_moe.grouped_ffn_cuda(g.x_pad, g.tile_expert, w1, w3, w2, g.tm, g.rows_used)
    torch.cuda.synchronize()
    assert grouped_moe.path_launches[path] == before + 1
    ref = moe.grouped_ffn_reference(g.x_pad, g.tile_expert, w1, w3, w2, g.tm).float()
    routed = ref[ref.abs().amax(-1) > 0]
    rms = float(routed.pow(2).mean().sqrt())
    err = (out.float() - ref).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-4 * rms
    else:
        assert bool((err <= 1e-2 * ref.abs() + 1e-2 * rms).all())
    used = int(g.rows_used[0])
    assert (out[used:] == 0).all()
    return g


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,E,k,D,F,hot,empty", [
    (1, 8, 2, 256, 384, None, None),     # decode: 2 routed rows, 2 live tiles
    (4, 8, 2, 512, 1024, None, None),    # decode: 8 routed rows
    (700, 8, 2, 256, 384, None, None),   # several tiles per expert; F = 3 x 128
    (200, 8, 2, 256, 384, None, 5),      # an empty expert
    (2200, 8, 1, 256, 384, 6, None),     # all 2200 rows on one expert
    (150, 4, 2, 384, 256, None, None),   # D = 3 x 128: the down kernel's column tail
    (90, 8, 2, 512, 1024, None, None),   # whole 256-wide column tiles
])
def test_grouped_moe_prefill_path_matches_plain(gpu, T, E, k, D, F, hot, empty, dtype):
    """Decode and prefill sizes on the wgmma path in bf16 (f32 on CUDA
    cores); where rows_used ends mid-buffer, the padding tiles come out
    zero."""
    lp, x = _moe_case(gpu, T, E, k, D, F, dtype, hot, empty)
    g = _check_grouped(lp, x, E, k, dtype)
    if T == 700:  # this routing leaves padding tiles past rows_used
        assert int(g.rows_used[0]) < g.x_pad.shape[0]
    if hot is not None:
        assert int(g.counts[hot]) == T * k
    if empty is not None:
        assert int(g.counts[empty]) == 0


def test_grouped_moe_glue_matches_dense(gpu):
    lp, x = _moe_case(gpu, 12, 8, 2, 256, 512, torch.float32)
    torch.testing.assert_close(moe.moe_ffn_grouped(lp, x, 8, 2),
                               llama._moe_ffn(configs.ModelConfig(
                                   name="t", vocab_size=8, d_model=256, n_layers=1,
                                   n_heads=2, n_kv_heads=1, d_ff=512, n_experts=8),
                                   lp, x), atol=1e-4, rtol=1e-4)


def test_moe_decode_step_grouped_matches_dense(gpu):
    cfg = dataclasses.replace(configs.get_config("tiny-moe"), dtype="float32")
    params = llama.init_params(cfg, "cuda", generator=gpu)
    B, maxB = 3, 4
    shape = (cfg.n_layers, 1 + B * maxB, cfg.kv_block_size, cfg.n_kv_heads, cfg.head_dim)
    kp = torch.randn(shape, generator=gpu, device="cuda")
    vp = torch.randn(shape, generator=gpu, device="cuda")
    tables = torch.arange(1, 1 + B * maxB, dtype=torch.int32, device="cuda").reshape(B, maxB)
    tokens = torch.tensor([5, 9, 300], device="cuda")
    positions = torch.tensor([37, 3, 20], dtype=torch.int32, device="cuda")
    before = grouped_moe.launches
    grouped, _, _ = llama.decode_step(params, dataclasses.replace(cfg, moe_impl="grouped"),
                                      tokens, positions, kp.clone(), vp.clone(), tables)
    assert grouped_moe.launches == before + cfg.n_layers
    dense, _, _ = llama.decode_step(params, cfg, tokens, positions, kp.clone(), vp.clone(),
                                    tables)
    torch.testing.assert_close(grouped, dense, atol=1e-4, rtol=1e-4)


# ---- K3: prefill attention ---------------------------------------------------


def _prefill_case(gen, B, S, P, H, Hkv, D, dtype):
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda").to(dtype)
    prior = (r(B, P, Hkv, D), r(B, P, Hkv, D)) if P else (None, None)
    return r(B, S, H, D), r(B, S, Hkv, D), r(B, S, Hkv, D), *prior


def _check_prefill(args, prior_len=None, new_len=None, via_causal=False):
    """K3 once (counted by path), against the plain version in f32 on the
    same inputs, within the tolerance of the module's docstring."""
    q, k, v, kp, vp = args
    path = prefill_attention.kernel_path(q.dtype)
    before = prefill_attention.launches, prefill_attention.path_launches[path]
    if via_causal:
        out = prefill_attention.causal(q, k, v)
    else:
        out = prefill_attention.prefill_attention(q, k, v, k_prior=kp, v_prior=vp,
                                                  prior_len=prior_len, new_len=new_len)
    torch.cuda.synchronize()
    assert prefill_attention.launches == before[0] + 1
    assert prefill_attention.path_launches[path] == before[1] + 1
    f = lambda t: None if t is None else t.float()
    ref = prefill_attention.prefill_attention_reference(
        f(q), f(k), f(v), f(kp), f(vp), prior_len, new_len)
    assert out.dtype == q.dtype and out.shape == q.shape
    if q.dtype == torch.float32:
        atol, rtol = 1e-5, 1e-5
    else:
        vmax = max(float(t.abs().max()) for t in (v, vp) if t is not None)
        atol, rtol = 2.0 ** -9 * vmax + 1e-5, 2.0 ** -8
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("H,Hkv", [(32, 8), (64, 8)])
@pytest.mark.parametrize("P", [0, 1024, 2048, 2976])
def test_prefill_attention_at_the_cell_shapes(gpu, P, H, Hkv):
    """The longprompt cells' heads, D 128: Mixtral's 32/8 and Qwen3-32B's
    64/8 (8 query heads a KV head), a 1024-row window over P prior
    columns."""
    lens = torch.tensor([P], dtype=torch.int32, device="cuda")
    full = torch.tensor([1024], dtype=torch.int32, device="cuda")
    _check_prefill(_prefill_case(gpu, 1, 1024, P, H, Hkv, 128, torch.bfloat16),
                   lens if P else None, full)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("P,prior_len,S,new_len", [
    (1024, 1024, 977, 900),   # ragged window, new_len < S
    (2048, 1500, 1024, 1024),  # prior_len < P, mid-tile
    (256, 0, 130, 1),          # no prior visible, one new column
    (0, 0, 977, 977),
])
def test_prefill_attention_ragged_edges(gpu, P, prior_len, S, new_len, dtype):
    lens = lambda n: torch.tensor([n], dtype=torch.int32, device="cuda")
    _check_prefill(_prefill_case(gpu, 1, S, P, 32, 8, 128, dtype),
                   lens(prior_len) if P else None, lens(new_len))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_attention_batched_with_trailing_padding(gpu, dtype):
    """Batched prefill: B = 4 rows of one length, padding at the end hidden
    by causality alone (the engine's form), and per-row lengths with
    per-row prior parts."""
    _check_prefill(_prefill_case(gpu, 4, 600, 0, 32, 8, 128, dtype), via_causal=True)
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")
    _check_prefill(_prefill_case(gpu, 4, 600, 384, 32, 8, 128, dtype),
                   i32([384, 200, 0, 129]), i32([600, 431, 77, 1]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,Hkv,D", [(16, 4, 128), (4, 1, 128), (4, 2, 32), (4, 2, 48),
                                     (8, 8, 64), (4, 2, 24)])
def test_prefill_attention_heads_and_head_dims(gpu, H, Hkv, D, dtype):
    """tp ranks' heads (16/4, 4/1), the tiny models' head dims (32, 48)
    and others the kernel pads (64, 24), with a prior part."""
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")
    _check_prefill(_prefill_case(gpu, 2, 300, 256, H, Hkv, D, dtype),
                   i32([256, 100]), i32([300, 250]))


def test_prefill_attention_refusals_on_cuda(gpu):
    q, k, v, _, _ = _prefill_case(gpu, 1, 64, 0, 4, 2, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="padding mask"):
        prefill_attention.causal(q, k, v, kv_valid=torch.ones(1, 64, dtype=torch.bool,
                                                               device="cuda"))
    with pytest.raises(ValueError, match="int32"):
        prefill_attention.prefill_attention(q, k, v, new_len=torch.tensor([64], device="cuda"))
    with pytest.raises(ValueError, match="dtype"):
        prefill_attention.prefill_attention(q, k.float(), v)


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen", "tiny-moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_forward_and_prefix_through_k3(gpu, name, dtype):
    """The serving forms on the card: a 32-token prefill with no prior part
    writes its KV into pages, a 16-token window over them attends through
    K3; its last logits against the plain forward over all 48 tokens (f32:
    the order of sums; bf16: 5 % of the largest logit, the rounding of 2
    layers' attention outputs)."""
    cfg = dataclasses.replace(configs.get_config(name), dtype=dtype)
    params = llama.init_params(cfg, "cuda", generator=gpu)
    prompt = torch.randint(1, cfg.vocab_size, (1, 48), generator=gpu, device="cuda")
    block = cfg.kv_block_size
    shape = (cfg.n_layers, 1 + 64 // block, block, cfg.n_kv_heads, cfg.head_dim)
    kp = torch.zeros(shape, dtype=params["embed"].dtype, device="cuda")
    vp = torch.zeros_like(kp)
    row = torch.arange(1, 1 + 64 // block, dtype=torch.int32, device="cuda")[None]
    i32 = lambda n: torch.tensor([n], dtype=torch.int32, device="cuda")
    before = prefill_attention.launches
    llama.prefill(params, cfg, prompt[:, :32], i32(32), kp, vp, row)
    kern, _, _ = llama.prefill(params, cfg, prompt[:, 32:], i32(16), kp, vp, row, i32(32),
                               row[:, :32 // block])
    assert prefill_attention.launches == before + 2 * cfg.n_layers
    plain, _ = llama.forward(params, cfg, prompt)
    plain = plain[:, -1]
    tol = 1e-4 if dtype == "float32" else 5e-2 * float(plain.abs().max())
    torch.testing.assert_close(kern, plain, atol=tol, rtol=1e-4 if dtype == "float32" else 0)


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen", "tiny-moe"])
def test_prefill_windows_match_one_call(gpu, name):
    """bf16 on the card: a 96-token prompt prefilled in one call and in
    three 32-token windows, each over the blocks the ones before it wrote
    (K3 with and without a prior part): the last logits, and every page
    the prompt wrote, within 5 % of the largest value (the rounding of 2
    layers' attention outputs, as above)."""
    cfg = dataclasses.replace(configs.get_config(name), dtype="bfloat16")
    params = llama.init_params(cfg, "cuda", generator=gpu)
    n, win, block = 96, 32, cfg.kv_block_size
    prompt = torch.randint(1, cfg.vocab_size, (1, n), generator=gpu, device="cuda")
    shape = (cfg.n_layers, 1 + n // block, block, cfg.n_kv_heads, cfg.head_dim)
    row = torch.arange(1, 1 + n // block, dtype=torch.int32, device="cuda")[None]
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device="cuda")
    pages = [torch.zeros(shape, dtype=torch.bfloat16, device="cuda") for _ in range(4)]
    whole, _, _ = llama.prefill(params, cfg, prompt, i32(n), pages[0], pages[1], row)
    before = prefill_attention.path_launches["wgmma"]
    for start in range(0, n, win):
        prior = {} if start == 0 else dict(prior_len=i32(start),
                                           prior_tables=row[:, :start // block])
        last, _, _ = llama.prefill(params, cfg, prompt[:, start:start + win], i32(win),
                                   pages[2], pages[3], row, **prior)
    assert prefill_attention.path_launches["wgmma"] == before + n // win * cfg.n_layers
    for got, want in ((last, whole), (pages[2], pages[0]), (pages[3], pages[1])):
        tol = 5e-2 * float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


# ---- K4: RMSNorm, QK-norm and RoPE -------------------------------------------
#
# K4 against the eager chain (``fused_norm.*_reference``) on the same CUDA
# inputs, in the working dtype. RoPE alone makes the eager chain's f32
# products and sums in the same order and rounds once: bit-equal. A norm
# differs only by the order of its f32 sum of squares, which moves 1/rms by
# a few f32 ulps: f32 within rtol 1e-5; bf16 within one bf16 step of the
# value (2**-7 relative), where that change tips a rounding. QK-norm then
# RoPE: a normed element one bf16 step off moves an output by at most 2**-7
# of its (pair) rotation's norm, at most 2**-6 of the largest output, and
# the output's own rounding may tip by 2**-7 of the value.


def _norm_tol(ref: torch.Tensor) -> dict:
    if ref.dtype == torch.float32:
        return dict(atol=1e-6, rtol=1e-5)
    return dict(atol=1e-6, rtol=2.0 ** -7)


def _qk_tol(ref: torch.Tensor) -> dict:
    top = float(ref.abs().max())
    if ref.dtype == torch.float32:
        return dict(atol=1e-5 * top, rtol=1e-5)
    return dict(atol=2.0 ** -6 * top, rtol=2.0 ** -7)


def _k4_counted(entry: str, fn):
    before = fused_norm.launches, fused_norm.path_launches[entry]
    out = fn()
    torch.cuda.synchronize()
    assert fused_norm.launches == before[0] + 1
    assert fused_norm.path_launches[entry] == before[1] + 1
    return out


def _norm_weight(gen, n, dtype):
    return (1 + 0.1 * torch.randn(n, generator=gen, device="cuda")).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (1, 1024, 5120),   # Qwen3-32B's window
    (1, 1024, 4096),   # Mixtral's window
    (4, 1, 5120),      # a decode batch
    (3, 7, 8192),      # Llama-3-70B's width
    (2, 5, 128),       # the tiny configs
    (1, 64, 64),       # the vision tower
    (3, 32768),        # the widest row the kernel takes
    (5, 8),
])
@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_kernel_matches_eager(gpu, shape, dtype, residual):
    """RMSNorm through K4 against the eager rms_norm (eps 1e-6 and 1e-5);
    with the residual, the sum is bit-equal to the eager bf16/f32 add."""
    x = (3 * torch.randn(shape, generator=gpu, device="cuda")).to(dtype)
    w = _norm_weight(gpu, shape[-1], dtype)
    r = torch.randn(shape, generator=gpu, device="cuda").to(dtype) if residual else None
    eps = 1e-6 if shape[-1] == 5120 else 1e-5
    got = _k4_counted("rms_norm", lambda: fused_norm.rms_norm(x, w, eps, residual=r))
    want = fused_norm.rms_norm_reference(x, w, eps, residual=r)
    if residual:
        assert torch.equal(got[0], want[0])
        got, want = got[1], want[1]
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got, want, **_norm_tol(want))


def _rope_case(gen, lead, Hq, Hk, D, dtype, theta, positions):
    q = torch.randn(*lead, Hq, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(*lead, Hk, D, generator=gen, device="cuda").to(dtype)
    cos, sin = rope_table(positions, D, theta)
    return q, k, cos, sin


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [
    "qwen3 window", "mixtral window", "qwen3 decode", "mixtral decode", "qwen3 tp rank",
    "mixtral tp rank", "tiny", "tiny-qwen", "past 4096",
])
def test_qk_norm_rope_kernel_matches_eager(gpu, case, dtype):
    """QK-norm and RoPE through K4 (one launch for q and k) against the
    eager rms_norm and apply_rope: Qwen3-32B's 64/8 heads with QK-norm (θ
    1e6, eps 1e-6) and Mixtral's 32/8 with RoPE alone (θ 1e6), over a
    1024-token window, a decode batch [4, 1] (cos/sin as decode_slab
    broadcasts them), one tp=2 rank's heads (32/4, 16/4), the tiny configs'
    head dims 32 (RoPE, θ 5e5) and 48 (QK-norm), and positions 4096-36863."""
    window = torch.arange(2048, 3072, device="cuda")[None]
    decode = torch.tensor([5, 900, 4095, 4100], device="cuda")
    Hq, Hk, D, norm, theta, pos, lead = {
        "qwen3 window": (64, 8, 128, True, 1e6, window, (1, 1024)),
        "mixtral window": (32, 8, 128, False, 1e6, window, (1, 1024)),
        "qwen3 decode": (64, 8, 128, True, 1e6, decode, (4, 1)),
        "mixtral decode": (32, 8, 128, False, 1e6, decode, (4, 1)),
        "qwen3 tp rank": (32, 4, 128, True, 1e6, window, (1, 1024)),
        "mixtral tp rank": (16, 4, 128, False, 1e6, window, (1, 1024)),
        "tiny": (4, 2, 32, False, 5e5, window[:, :37], (1, 37)),
        "tiny-qwen": (4, 2, 48, True, 1e6, window[:, :37], (1, 37)),
        "past 4096": (64, 8, 128, True, 1e6,
                      torch.randint(4096, 36864, (2, 300), generator=gpu, device="cuda"),
                      (2, 300)),
    }[case]
    q, k, cos, sin = _rope_case(gpu, lead, Hq, Hk, D, dtype, theta, pos)
    if pos is decode:  # decode_slab's [B, 1, D/2] tables
        cos, sin = cos[:, None], sin[:, None]
    qn = _norm_weight(gpu, D, dtype) if norm else None
    kn = _norm_weight(gpu, D, dtype) if norm else None
    eps = 1e-6
    got = _k4_counted("qk_norm_rope",
                      lambda: fused_norm.qk_norm_rope(q, k, cos, sin, qn, kn, eps))
    want = fused_norm.qk_norm_rope_reference(q, k, cos, sin, qn, kn, eps)
    for g, w_ in zip(got, want):
        assert g.dtype == dtype and g.shape == w_.shape
        if norm:
            torch.testing.assert_close(g, w_, **_qk_tol(w_))
        else:
            assert torch.equal(g, w_), float((g.float() - w_.float()).abs().max())


def test_k4_refusals_and_grad_on_cuda(gpu):
    """An unsupported width, head dim or dtype raises on the kernel's path,
    and so does an input that requires grad under grad mode (K4 has no
    backward; ``fused_norm.PLAIN``, the caller's choice, differentiates);
    under no_grad the kernel runs. An empty call launches nothing."""
    x = torch.randn(4, 100, device="cuda")
    with pytest.raises(ValueError, match="width 100"):
        fused_norm.rms_norm(x, torch.ones(100, device="cuda"))
    with pytest.raises(ValueError, match="dtype"):
        fused_norm.rms_norm(x[:, :96].half(), torch.ones(96, device="cuda").half())
    q, k, cos, sin = _rope_case(gpu, (1, 8), 4, 2, 24, torch.float32, 1e4,
                                torch.arange(8, device="cuda")[None])
    with pytest.raises(ValueError, match="head_dim 24"):
        fused_norm.qk_norm_rope(q, k, cos, sin)
    x = torch.randn(3, 128, device="cuda", requires_grad=True)
    w = torch.ones(128, device="cuda")
    before = fused_norm.launches
    with pytest.raises(ValueError, match="no backward"):
        fused_norm.rms_norm(x, w)
    q, k, cos, sin = _rope_case(gpu, (1, 8), 4, 2, 32, torch.float32, 1e4,
                                torch.arange(8, device="cuda")[None])
    with pytest.raises(ValueError, match="no backward"):
        fused_norm.qk_norm_rope(q.requires_grad_(True), k, cos, sin)
    fused_norm.PLAIN.rms_norm(x, w).sum().backward()
    assert fused_norm.launches == before and x.grad is not None
    with torch.no_grad():
        fused_norm.rms_norm(x, w)
    assert fused_norm.launches == before + 1
    empty = x.detach()[:0]
    assert fused_norm.rms_norm(empty, w, residual=empty)[1].shape == (0, 128)
    q, k, cos, sin = _rope_case(gpu, (1, 0), 4, 2, 32, torch.float32, 1e4,
                                torch.arange(0, device="cuda")[None])
    assert fused_norm.qk_norm_rope(q, k, cos, sin)[0].shape == (1, 0, 4, 32)
    assert fused_norm.launches == before + 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_served_qwen3_window_launches_k4(gpu, dtype):
    """One served window on Qwen3-32B's widths (2 of its 64 layers): a
    1024-token window through prefill over 512 cached tokens launches K4 3
    x L + 1 times (ln_attn, QK-norm and RoPE, the residual add and ln_mlp
    in each layer; the final norm), K3 L times, and its greedy token
    equals the eager chain's on the same pages (logits within 5 % of the
    largest in bf16: two layers' rounding; 1e-3 in f32)."""
    cfg = dataclasses.replace(configs.get_config("qwen3-32b"), n_layers=2, dtype=dtype)
    params = llama.init_params(cfg, "cuda", generator=gpu)
    block = cfg.kv_block_size
    prefix, S = 512, 1024
    n_blocks = (prefix + S) // block
    shape = (cfg.n_layers, 1 + n_blocks, block, cfg.n_kv_heads, cfg.head_dim)
    kp = torch.randn(shape, generator=gpu, device="cuda").to(params["embed"].dtype)
    vp = torch.randn(shape, generator=gpu, device="cuda").to(kp.dtype)
    row = torch.arange(1, 1 + n_blocks, dtype=torch.int32, device="cuda")[None]
    tokens = torch.randint(1, cfg.vocab_size, (1, S), generator=gpu, device="cuda")
    i32 = lambda n: torch.tensor([n], dtype=torch.int32, device="cuda")

    def window():
        return llama.prefill(params, cfg, tokens, i32(S), kp.clone(), vp.clone(), row,
                             i32(prefix), row[:, :prefix // block])[0]

    ops.reset_kernel_launches()
    with torch.no_grad():
        kern = window()
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    assert launches[fused_norm.KERNEL] == 3 * cfg.n_layers + 1, launches
    assert launches["fused_norm_rope.rms_norm"] == 2 * cfg.n_layers + 1, launches
    assert launches["fused_norm_rope.qk_norm_rope"] == cfg.n_layers, launches
    assert launches[prefill_attention.KERNEL] == cfg.n_layers, launches
    eager = pytest.MonkeyPatch()
    eager.setattr(fused_norm, "rms_norm", fused_norm.rms_norm_reference)
    eager.setattr(fused_norm, "qk_norm_rope", fused_norm.qk_norm_rope_reference)
    try:
        with torch.no_grad():
            plain = window()
    finally:
        eager.undo()
    tol = 1e-3 if dtype == "float32" else 5e-2 * float(plain.abs().max())
    torch.testing.assert_close(kern, plain, atol=tol, rtol=0)
    # Greedy tokens equal, unless the eager logits' top two lie closer than
    # twice the largest difference (a near-tie either may break).
    top2 = plain.topk(2, dim=-1).values[0]
    if float(top2[0] - top2[1]) > 2 * float((kern - plain).abs().max()):
        assert torch.equal(kern.argmax(-1), plain.argmax(-1))
