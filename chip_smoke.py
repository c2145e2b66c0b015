#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card      name and power limit from nvidia-smi
  2. build     nvcc builds every kernel of the serving paths from csrc/ (K1
               paged decode attention, K2 grouped-expert FFN, K3 prefill
               attention, K4 RMSNorm / QK-norm / RoPE), in parallel
  3. kernels   K1 (one launch; mma.sync in bf16) against its plain PyTorch
               version on the card, at llama3-8b shapes (and head_dim 64)
               and at one tp rank's heads (H/Hkv 16/4, 8/2, 4/1), and at
               Llama-3-70B's heads (64/8) and one of its tp=2 ranks' (32/4),
               bf16 and f32, with times of the kernel, the plain version and
               a library yardstick at the full and at each such shape
  4. decode    one full-width llama3-8b decode_step in bf16 (random weights),
               kernel against plain paged attention; the same on the first
               two layers in f32, with a tight tolerance
  5. serve     TorchEngine + the OpenAI server for llama3-8b on the card,
               4 concurrent /v1/completions requests; every kernel's launch
               count is set to 0 just before and read just after. Run twice:
               with kv_events_port=0, then (the main path) with KV events on
               and a raw /kv_events subscriber attached before the requests;
               decode tok/s of both. With events: stored covers every full
               block of the served prompts (publish-to-receipt lag median
               and max), a second subscriber joining afterwards learns the
               cache from the snapshot within 2 s; render = the tokenizer,
               greedy /v1/responses (plain and streamed) = the chat text,
               one /v1/embeddings call per ~1100-token prompt, timed and
               counted as a path of its own (no K1). Then a small engine (7
               usable blocks) whose ``removed`` events must name exactly
               the evicted hashes
  5b. pd      P/D KV handoff at llama3-8b width and depth: a prefill engine
               (prefill_chunk=256) and a decode engine behind their servers,
               driven over HTTP as the router's sidecar drives them, the
               serial 2-phase protocol and the chunk-streamed pipelined one
               (~1030-token prompts, 32 greedy tokens); imported pages equal
               the exporter's bitwise, tokens equal a monolithic engine's,
               the pipelined pull streams >= 4 chunks, no export is left,
               and K1 launched n_layers times per decode step of the decode
               engine; prints bytes, pull/exposed ms, the engine thread's
               staging stall, import ms and TTFTs
  5c. epd     E/P/D at llama3-8b width and depth: two encode servers (the
               three images round-robin, 0 and 2 on A, 1 on B), a prefill and
               a decode server whose legs name both in ec_sources (32 greedy
               tokens); each encoder's rows equal the tower run in-process,
               the decode server's rows come in item order, the tokens equal
               one E/D engine's, the splice moves the first-token logits, the
               tower launches no K1 and the decode leg launches it; /health
               reports each role; a cold cache_hit_threshold probe answers
               cache_threshold without allocating, a warm one answers; prints
               encode ms, /ec bytes and pull ms, the multimodal prefill ms,
               TTFT of E/P/D, E/D and text-only P/D, and the time to /health
               ok with and without --warmup
  6. moe       K2 against its plain version at full Mixtral width (decode
               and prefill sizes, skewed routing, an empty expert), bf16 and
               f32, with times of the kernel, the plain version and a
               per-expert cuBLAS yardstick at T=4 and T=1100; the routing
               glue under torch.cuda.set_sync_debug_mode("error")
  6b. prefill attention  K3 against its plain version (f32 on the same
               inputs) at the longprompt cell's windows (S 1024 over 0, 1024,
               2048, 2976 prior columns; 32/8 and one tp=2 rank's 16/4, D
               128) and ragged edges, bf16 and f32, each window timed with
               its bound (visible columns' operations or the bytes), the
               plain version and an SDPA yardstick; every serve phase's
               prefills (whole, batched, after a prefix hit, embeddings)
               must attend through K3's wgmma path once per layer
  6c. norms    K4 (rms_norm, its residual form, qk_norm_rope) against the
               eager chain at Qwen3-32B's and Mixtral's 1024-token windows
               and a decode batch of 4, bf16 and f32; each timed (bf16,
               order kernel, eager, kernel, eager) beside its bytes bound at
               3.35 TB/s, rms_norm also beside F.rms_norm as a yardstick
  7. moe decode  one Mixtral (16 of 32 layers) decode_step in bf16, grouped
               (K2) against dense on every lane, except a lane whose top-k
               routing differs between the two at a near-tie of its router
               logits; every layer's MoE FFN in bf16 on the dense step's
               inputs and the first two layers in f32, tight
  8. moe serve   TorchEngine (grouped_moe=True) + the OpenAI server for
               Mixtral (16 layers), the same 4 requests and the same event,
               surface and eviction checks as phase 5; K1 and K2 counted,
               K2 by path (every prefill and decode step on wgmma; the
               embeddings n_layers wgmma launches per call); the grouped
               embeddings held against an engine with the dense FFN; 8b: a
               4000-token prompt through the longprompt cell's prefill
               settings (1024-token windows): K3 once per layer and window,
               all on wgmma, K4 3 x 16 + 1 = 49 times a window, each
               window's engine-side ms; 8c: the same on Qwen3-32B whole (64
               layers, dense FFN, 65.5 GB; a 2048-token prompt, two
               windows): K3 64 and K4 3 x 64 + 1 = 193 times a window
  9. ckpt      converted HF checkpoints: an Orbax-shaped directory is
               refused; then, for Llama-3-8B (8 of 32 layers) and Mixtral-8x7B
               (2 of 32 layers, grouped_moe=True) at full width, an HF-layout
               checkpoint (HF names, [out, in], config.json, sharded) is
               written from a seed with the port's safetensors writer,
               converted by the port's CLI in a subprocess, and served by
               EngineServer from the server's own parser with --model <dir>
               --prefill-batch 4 and no in-memory params: the loaded weights
               equal the in-memory conversion bitwise, eight concurrent
               same-bucket prompts prefill in two batches of four, and their
               32 greedy tokens equal an in-memory prefill_batch=1 engine's
               up to reported near-tie flips; K1 (and K2 on wgmma, in every
               batched prefill) counted; x-request-timeout answers 504 and
               the slot and blocks come back; prints bytes, convert and
               load-to-ready seconds, and peak host RSS
  10. tp      llama3-8b at full width and depth with --tp-size 2 on an
               explicit device list naming the card twice, from the server's
               parser: phase 5's four requests, greedy tokens equal to a
               tp=1 engine's on the same weights up to reported near-ties,
               K1 launched tp x n_layers times per decode step; a P/D
               handoff from the tp=2 engine into a tp=1 decode engine (the
               imported pages equal each kv-head shard bitwise, tokens
               against a tp=1 monolithic engine); decode tok/s and the
               step's wall time, which are not a TP speed (two shards on
               one card). Then Mixtral (16 of 32 layers) with --ep-size 2,
               dense, against a tp=1 dense engine, the same way
  10b. tls    one https completion against a tp=2 engine served with
               --cert-path (a certificate from the cryptography package or
               the openssl CLI), one chaos http503 and a completion after it
  11. pp      pipeline-parallel serving from the server's parser, every
               stage on the one card (no pipeline speed): llama3-8b at full
               width and depth with --pp-size 2, phase 5's four requests
               (batch bucket 4: the lane-group interleave) and one
               single-lane request (the broadcast ring) against a pp=1
               engine on the same weights, greedy tokens equal up to
               reported near-ties, the last-position logits within 5e-2 of
               the largest, K1 tp x L a ring step and pp x tp x L an
               interleave step; a P/D handoff pp=2 -> tp=1 and tp=1 -> pp=2
               (pages per (stage, kv-head) shard bitwise); Llama-3-70B at
               full width cut to 16 of 80 layers with --pp-size 4 and with
               --pp-size 2 --tp-size 2, both views of one set of weights,
               against pp=1; Mixtral (16 layers) with --pp-size 2 and the
               grouped FFN against pp=1 grouped (K2 on wgmma, L launches
               per prefill and per layer stack a step runs), and with
               --pp-size 2 --ep-size 2 dense against pp=1 dense
  12. sim     the CPU simulator from the parser (--backend sim --platform
               cpu): one completion, one streamed request, /health and
               /metrics, and no kernel launch
  13. dist    multi-process engine groups (--dist-*), each of two processes
               on the one card: the leader in this process on the phase's
               weights, the follower from the server CLI (for a model
               directory, this script's --dist-follower, which draws its
               ranks' weights from the seed); the collective backend follows
               the port's rule (gloo: two ranks share the card) and is
               printed. Every group first holds K1 (and K2) to their plain
               versions inside each process at its own shapes, and its
               launches are counted in each process. 13a llama3-8b tp=2 over
               two processes against the single-process tp=1 engine (phase
               5's requests, tokens up to near-ties, the last-position
               logits, K1 once per layer and step in each process, the
               decode step's wall); 13d the drills: the follower killed
               under a request (the request ends, /health 503 "degraded", a
               new request ends at once), the leader of a CLI group killed
               (the follower exits nonzero); 13e the device wire (CUDA IPC)
               from a prefill server in its own process, then within this
               process: route "device", the imported pages bitwise the
               exporter's /kv bytes, tokens equal a monolithic engine's;
               13f P/D from a tp=2 group into a tp=2 group over the host
               shard wire and over the device wire (each process's imported
               pages bitwise its counterpart's staged shards, by digest);
               13b Llama-3-70B (16 of 80 layers) pp=2 over two processes
               and 13c Mixtral (8 of 32 layers, the grouped FFN selected by
               its model_config.json) pp=2 over two processes, both
               schedules, against pp=1 (K2 on wgmma in each process)
  14. train   the training slice, every rank on the one card (no parallel
               speed): 14a 10 AdamW steps (optax adamw's values) at llama3-8b
               width, 2 of 32 layers, in bf16 as JAX trains, on one seeded
               [2, 2048] batch: the loss finite and falling, the step wall,
               tokens/s and the peak device memory; 14b one step at tp=2 x
               sp=2 (ring attention) and one at dp=2 from the same weights and
               batch against the tp=1 step (loss, every gradient, the sign
               of every parameter's update); 14c ring attention and Ulysses
               (sp 2 and 4) against causal_attention at llama3-8b's heads
               32/8, D 128, S 2048, f32 and bf16, and ring's input gradients;
               14d the GPipe forward (4 layers) at pp=2 with M=2 and pp=4
               with M=4 against forward, f32 and bf16; no K1, K2 or K3
               launch, and no K4 launch in the train steps
The lines before the last carry the card's name and power limit and a JSON
object listing each kernel once for every serving path that launches it
(the P/D decode engine's K1 launches as path "llama3-8b P/D decode", the
E/P/D decode leg's as "llama3-8b E/P/D decode", K2's
launches of the Mixtral /v1/embeddings calls as path
"mixtral-8x7b-16l embeddings", the checkpoint phase's as "ckpt
llama3-8b-8l serve" and "ckpt mixtral-8x7b-2l serve", phase 10's as
"llama3-8b tp2 serve" (timed at one rank's heads, 16/4), "llama3-8b tp2
P/D decode (tp=1)" and "mixtral-8x7b-16l ep2 serve", phase 11's as
"llama3-8b pp2 serve", "llama3-8b pp2 P/D decode", "llama3-70b-16l pp4
serve" (timed at 64/8), "llama3-70b-16l pp2tp2 serve" (timed at 32/4),
"mixtral-8x7b-16l pp2 serve" (K1 and K2) and "mixtral-8x7b-16l pp2ep2
serve", phase 13's as "... dist ..." and "... device-wire P/D decode",
launches summed over the group's processes), with that path's launch count (K2's entry also by kernel path, and its
prefill-size times under prefill_*); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
F32_FLOPS = 67e12                # f32 outside the tensor cores
# bf16 (atol, rtol): both versions compute in f32 and round the result to
# bf16 once; f32 sums taken in another order can move a value across one
# rounding boundary, and one bf16 step is at most 2**-7 (< 1e-2) of the value.
# The 1e-3 abs term covers outputs near zero, where the relative term
# vanishes; it is 2x the largest error seen on sound runs (4.9e-4).
# f32: only the summation order differs -> 1e-5.
TOL = {torch.bfloat16: (1e-3, 1e-2), torch.float32: (1e-5, 1e-5)}
# Logits after 32 bf16 layers: the attention outputs of the two paths differ
# by up to a bf16 step, which the residual stream carries to the logits;
# allow 5 % of the logits' largest magnitude. A coarse gate: sound runs read
# 3.5-4 % (0.17-0.20 against 4.84).
LOGITS_REL_TOL = 5e-2
# Logits after the first two layers in f32 (TF32 off): only the attention's
# summation order differs (~1e-6 relative per layer) -> 1e-4 of the largest.
LOGITS_F32_REL_TOL = 1e-4
# K2 against its plain version; rms(plain) is taken over the routed rows
# (padding rows are zero in both). f32: one thread sums D = 4096 then
# F = 14336 products in order, the plain version in cuBLAS's order; such
# sums drift by ~sqrt(K) * eps of their terms, and sound runs read up to
# 2.8e-5 of rms(plain) at full width: allow 1e-4 * rms(plain). bf16: both
# versions round act and the output to bf16; an act value one bf16 step off
# moves the output by that step times a weight, so 1e-2 * |plain| +
# 1e-2 * rms(plain) (sound runs read at most 0.031 at values up to ~4, one
# bf16 step there).
MOE_F32_TOL = 1e-4
MOE_BF16_TOL = 1e-2
# Mixtral decode_step, grouped (K2) against dense, after 16 bf16 layers: the
# two FFNs round at other points (dense rounds up and gate to bf16 before
# silu, K2 keeps them in f32), which the residual stream carries to the
# logits; a coarse 5 % of max |logit|, as for K1. In f32 on two layers only
# summation order differs -> 1e-4 of max |logit|.
MOE_LOGITS_REL_TOL = 5e-2
# Each layer's MoE FFN output in bf16, grouped (K2) against dense, on the
# dense decode step's input of that layer: the dense path rounds up, gate, silu and
# their product to bf16 where K2 rounds act once, so act differs by a few
# bf16 steps; elementwise within 3e-2 * |dense| + 3e-2 * rms(dense) (sound
# runs read 1.7e-2; a row on the wrong expert would be off by about the
# output's own size).
MOE_FFN_BF16_TOL = 3e-2
# A decode lane whose top-k routing differs between grouped and dense is
# left out of the logits gate only at a near-tie: its k-th and (k+1)-th
# router logits (bf16 values, from the dense step) within this many bf16
# steps of their magnitude. The two paths' FFN outputs differ by a few bf16
# steps per layer, which moves the router logits of later layers by up to
# ~10 steps (at magnitudes ~1, on this script's seeded lanes), while the
# k-th and (k+1)-th of 8 router logits of unit scale lie ~0.3 apart, ~40
# steps: a lane moved off its expert by a fault flips at such a margin.
MOE_ROUTE_TIE_STEPS = 8
MODEL = "llama3-8b"
# llama3-8b's (H, Hkv) on one tp rank at tp = 2, 4 and 8.
LOCAL_HEADS = [(16, 4), (8, 2), (4, 1)]
# Llama-3-70B's (H, Hkv), GQA group 8, and one tp=2 rank's (phase 11).
PP_HEADS = [(64, 8), (32, 4)]
MOE_MODEL = "mixtral-8x7b"
MOE_LAYERS = 16   # of 32: 93.4 GB in bf16 do not fit in 80 GB; 16 take 47 GB
MOE_SERVED = "mixtral-8x7b-16l"
QWEN3 = "qwen3-32b"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---- phase 3: paged decode attention (K1) ------------------------------


def make_attention_case(gen, B, H, Hkv, D, seq_lens, dtype, *, block=16,
                        max_blocks=128, layers=1):
    """Random q, pages ([layers, N, block, Hkv, D]), cur K/V; each row's
    block table holds distinct random blocks; a seq_len-1 row is a padding
    lane pointing at the trash block 0."""
    N = 1 + B * max_blocks
    dev = "cuda"

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    perm = torch.randperm(N - 1, generator=gen, device=dev)[: B * max_blocks] + 1
    tables = perm.to(torch.int32).reshape(B, max_blocks).contiguous()
    for b, s in enumerate(seq_lens):
        if s == 1:
            tables[b] = 0
    return dict(q=r(B, H, D), k_pages=r(layers, N, block, Hkv, D),
                v_pages=r(layers, N, block, Hkv, D), block_tables=tables,
                seq_lens=torch.tensor(seq_lens, dtype=torch.int32, device=dev),
                cur_k=r(B, Hkv, D), cur_v=r(B, Hkv, D))


def attention_bound_ms(case) -> tuple[float, str]:
    """Least time for the work of this call: bytes it must move (the K/V
    rows of each row's cached positions, q, cur K/V, the table entries it
    reads, the output) over HBM bandwidth, against its flops over the
    peak rate of the input type."""
    q = case["q"]
    B, H, D = q.shape
    _, _, block, Hkv, _ = case["k_pages"].shape
    isz = q.element_size()
    cached = (case["seq_lens"].long() - 1).clamp(min=0)
    n_cached = int(cached.sum())
    n_pages = int(((cached + block - 1) // block).sum())
    nbytes = (2 * n_cached * Hkv * D * isz + 2 * B * H * D * isz
              + 2 * B * Hkv * D * isz + n_pages * 4 + B * 4)
    flops = 4 * H * D * (n_cached + B)
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sdpa_yardstick(case):
    """scaled_dot_product_attention over the same KV pre-gathered to a
    contiguous [B, Hkv, T+1, D] (the gather excluded from its time), with a
    mask for the ragged lengths — a yardstick only; the port never calls it."""
    import torch.nn.functional as F

    q, kp, vp = case["q"], case["k_pages"][0], case["v_pages"][0]
    bt, sl = case["block_tables"].long(), case["seq_lens"].long()
    B, H, D = q.shape
    Hkv = kp.shape[2]
    T = bt.shape[1] * kp.shape[1]
    k = torch.cat([kp[bt].reshape(B, T, Hkv, D), case["cur_k"][:, None]], 1)
    v = torch.cat([vp[bt].reshape(B, T, Hkv, D), case["cur_v"][:, None]], 1)
    k = k.transpose(1, 2).contiguous()
    v = v.transpose(1, 2).contiguous()
    pos = torch.arange(T + 1, device=q.device)
    mask = (pos[None] < (sl - 1)[:, None]) | (pos[None] == T)
    mask = mask[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def check_attention(name: str, args: tuple) -> float:
    """Kernel against its plain version on ``args``; fails on a mismatch
    beyond TOL of the inputs' dtype, else returns the max abs error."""
    from llm_d_inference_scheduler_tpu_torch.ops import paged_attention as pa
    from llm_d_inference_scheduler_tpu_torch.ops.attention import paged_decode_attention

    dtype = args[0].dtype
    atol, rtol = TOL[dtype]
    out = pa.paged_decode_attention_cuda(*args)
    torch.cuda.synchronize()
    ref = paged_decode_attention(*args)
    err = (out.float() - ref.float()).abs()
    max_err = float(err.max())
    ok = bool(torch.isfinite(out.float()).all()) and bool(
        (err <= atol + rtol * ref.float().abs()).all())
    log(f"[kernels] paged_decode_attention {name} {str(dtype)[6:]}: "
        f"max_abs_err={max_err:.3e} (atol={atol}, rtol={rtol}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"paged_decode_attention disagrees with its plain version on {name} {dtype}")
    return max_err


def lane_groups(seq_lens: list[int], B: int) -> list[list[int]]:
    """``seq_lens`` cut into contiguous groups of B lanes: the lane groups
    of a pp interleave at B = bucket / pp (``pp_serve.interleaved_chunk``
    slices its batch so), or the lanes of a ring step at a smaller bucket."""
    return [seq_lens[i:i + B] for i in range(0, len(seq_lens), B)]


# K1's timed shapes, by kernels-line key: (H, Hkv, lanes per launch). B=4
# is the serve bucket (pp=1, tp and ep paths); the pp paths launch mostly
# at their interleave's groups: llama3-8b and Mixtral pp=2 at 32/8 B=2,
# Llama-3-70B pp=4 at 64/8 B=1, its pp2tp2 at 32/4 B=2; "pd" is the P/D
# decode lane at 32/8 B=1 (the broadcast ring of one request).
# Phase 13: Llama-3-70B pp=2 at 64/8 B=2, a tp=2 group's P/D decode lane
# at 16/4 B=1.
K1_TIMED = [(32, 8, 4)] + [(H, Hkv, 4) for H, Hkv in LOCAL_HEADS + PP_HEADS] + [
    (32, 8, 2), (64, 8, 1), (32, 4, 2), (64, 8, 2), (16, 4, 1)]


def phase_kernels(serve_seq_lens: list[int], pd_seq_len: int) -> dict:
    """K1 against its plain version on every case, and timed at the serve
    shape with the full model's heads and with each LOCAL_HEADS pair, and
    at each pp path's launch shape (K1_TIMED); returns K1's kernels-line
    entry for each timed key, and "pd" for the P/D decode lane."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = [
        ("llama3-8b B=1", 1, 32, 8, 128, [1000]),
        # trash row (1), block boundaries (17 -> 16 cached, 33 -> 32), full
        # table (2048 -> 2047 cached), ragged rest.
        ("llama3-8b B=8", 8, 32, 8, 128, [1, 17, 33, 100, 257, 1000, 2048, 5]),
        ("head_dim 64 B=8", 8, 32, 8, 64, [1, 16, 17, 64, 200, 513, 1024, 2]),
        # The serving phase's decode batch (a split layout of its own).
        ("serve shape B=4", len(serve_seq_lens), 32, 8, 128, serve_seq_lens),
    ]
    # One tp rank's heads of llama3-8b (phase 10): H/Hkv at tp = 2, 4, 8;
    # Llama-3-70B's and one tp=2 rank's (phase 11): 64/8 and 32/4.
    cases += [(f"local H={H} Hkv={Hkv} B=8", 8, H, Hkv, 128,
               [1, 17, 33, 100, 257, 1000, 2048, 5]) for H, Hkv in LOCAL_HEADS + PP_HEADS]
    # The pp paths' launches (phase 11): interleave groups and small-bucket
    # ring steps of B=1 and B=2 lanes at the serve lengths; the split-KV
    # layout depends on B and Hkv, so each is a layout of its own.
    cases += [(f"pp H={H} Hkv={Hkv} B={B} lanes {sl}", B, H, Hkv, 128, sl)
              for H, Hkv in [(32, 8)] + PP_HEADS for B in (1, 2)
              for sl in lane_groups(serve_seq_lens, B)]
    cases.append(("P/D decode lane B=1", 1, 32, 8, 128, [pd_seq_len]))
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, H, Hkv, D, sl in cases:
            c = make_attention_case(gen, B, H, Hkv, D, sl, dtype)
            err = check_attention(name, (c["q"], c["k_pages"][0], c["v_pages"][0],
                                         c["block_tables"], c["seq_lens"],
                                         c["cur_k"], c["cur_v"]))
            if dtype == torch.bfloat16:
                worst = max(worst, err)

    timing = {(H, Hkv, B): lane_groups(serve_seq_lens, B) for H, Hkv, B in K1_TIMED}
    timing["pd"] = [[pd_seq_len]]
    for key, groups in timing.items():
        H, Hkv = (32, 8) if key == "pd" else key[:2]
        timing[key] = time_attention(gen, groups, H, Hkv)
        worst = max(worst, timing[key].pop("max_abs_err"))
    entry = {"name": "paged_decode_attention", "route": "cuda",
             "source": "llm_d_inference_scheduler_tpu_torch/csrc/paged_decode_attention.cu",
             "replaces": "llm_d_inference_scheduler_tpu/ops/pallas_paged_attention.py:139",
             "launches": None, "max_abs_err": worst}
    return {key: {**entry, **t} for key, t in timing.items()}


def time_attention(gen, groups: list[list[int]], H: int, Hkv: int) -> dict:
    """K1, its plain version and SDPA timed with H query and Hkv KV heads
    (the full model's, or one tp rank's) over ``groups``, the lane groups
    one path launches at (the serve phase's four lanes midway through their
    32 tokens: one bucket of 4, or a pp interleave's groups). Calls rotate
    over the groups, so a time is the mean of one launch over them, and the
    bound is the mean of theirs. Eight layers' pages per group (> the 50 MB
    L2) rotate as in a decode step, so reads are cold."""
    from llm_d_inference_scheduler_tpu_torch.ops import paged_attention as pa
    from llm_d_inference_scheduler_tpu_torch.ops.attention import paged_decode_attention
    from llm_d_inference_scheduler_tpu_torch.tools.timing import device_ms, kernel_times

    L = 8
    cs = [make_attention_case(gen, len(sl), H, Hkv, 128, sl, torch.bfloat16, layers=L)
          for sl in groups]
    G = len(cs)
    it = {"i": 0}

    def pick():
        it["i"] = (it["i"] + 1) % (L * G)
        return cs[it["i"] % G], it["i"] // G

    def args():
        c, i = pick()
        return (c["q"], c["k_pages"][i], c["v_pages"][i], c["block_tables"],
                c["seq_lens"], c["cur_k"], c["cur_v"])

    sdpas = [sdpa_yardstick(c) for c in cs]
    err = max(check_attention(f"lanes {sl} H={H} Hkv={Hkv}, timed pages",
                              (c["q"], c["k_pages"][0], c["v_pages"][0], c["block_tables"],
                               c["seq_lens"], c["cur_k"], c["cur_v"]))
              for sl, c in zip(groups, cs))
    kernel = lambda: pa.paged_decode_attention_cuda(*args())
    plain = lambda: paged_decode_attention(*args())
    k1, k1_wall, prof_ok = device_ms(kernel)
    p1, p1_wall, _ = device_ms(plain)
    k2, k2_wall, _ = device_ms(kernel)
    p2, p2_wall, _ = device_ms(plain)
    turn = {"g": 0}

    def library():
        turn["g"] = (turn["g"] + 1) % G
        return sdpas[turn["g"]]()

    library_ms, lib_wall, _ = device_ms(library)
    kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
    bounds = [attention_bound_ms(c) for c in cs]
    bound_ms = sum(b for b, _ in bounds) / G
    bound_by = "bytes" if all(by == "bytes" for _, by in bounds) else "operations"
    src = "device time (profiler)" if prof_ok else "CUDA events (profiler saw no device time)"
    log(f"[kernels] paged_decode_attention timing at H={H} Hkv={Hkv} lane groups "
        f"{groups} (mean of one launch over the groups) "
        f"bf16, {src}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms "
        f"(order kernel, plain, kernel, plain), sdpa over pre-gathered KV "
        f"(gather excluded) {library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
        f"by {bound_by}; wall per call by CUDA events, host launch included: "
        f"kernel {k1_wall:.4f}/{k2_wall:.4f} ms, plain {p1_wall:.4f}/{p2_wall:.4f} ms, "
        f"sdpa {lib_wall:.4f} ms")
    if (H, Hkv, G) == (32, 8, 1) and len(groups[0]) == 4:
        for name, ms in kernel_times(kernel).items():
            log(f"[kernels]   {ms * 1e3:8.2f} us  {name[:100]}")
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


# ---- phase 4: full-width decode step ------------------------------------


SEQ_LENS = [1, 16, 33, 100, 257, 512, 777, 1024]  # decode lanes, B = 8


def decode_inputs(cfg, dtype):
    """Random tokens and KV pages for a B=8 decode_step at SEQ_LENS; each
    lane's block table holds distinct random blocks, lane 0 pads on the
    trash block."""
    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(7)
    B, max_blocks = len(SEQ_LENS), 64
    N = 1 + B * max_blocks
    shape = (cfg.n_layers, N, cfg.kv_block_size, cfg.n_kv_heads, cfg.head_dim)
    k_pages = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    v_pages = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    tables = (torch.randperm(N - 1, generator=gen, device=device)[: B * max_blocks]
              + 1).to(torch.int32).reshape(B, max_blocks).contiguous()
    tables[0] = 0  # a padding lane on the trash block
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=device)
    positions = torch.tensor(SEQ_LENS, device=device, dtype=torch.int32) - 1
    return tokens, positions, k_pages, v_pages, tables


def first_layers_f32(params, n: int) -> dict:
    """The first n layers of params (and the embedding, norm, head) in f32."""
    return {"embed": params["embed"].float(), "final_norm": params["final_norm"].float(),
            "lm_head": params["lm_head"].float(),
            "layers": {k: v[:n].float() for k, v in params["layers"].items()}}


def phase_decode(cfg, params) -> None:
    from llm_d_inference_scheduler_tpu_torch.models import llama
    from llm_d_inference_scheduler_tpu_torch.ops.attention import paged_decode_attention

    seq_lens = SEQ_LENS
    B = len(seq_lens)
    dtype = params["embed"].dtype
    tokens, positions, k_pages, v_pages, tables = decode_inputs(cfg, dtype)
    kern, _, _ = llama.decode_step(params, cfg, tokens, positions, k_pages,
                                   v_pages, tables)
    plain, _, _ = llama.decode_step(params, cfg, tokens, positions, k_pages,
                                    v_pages, tables,
                                    paged_attention=paged_decode_attention)
    if kern.shape != (B, cfg.vocab_size) or not bool(torch.isfinite(kern).all()):
        fail(f"decode_step logits malformed: {tuple(kern.shape)}")
    diff = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    ok = diff <= LOGITS_REL_TOL * scale
    log(f"[decode] {cfg.name} decode_step {str(dtype)[6:]} B={B} seq_lens={seq_lens}: logits "
        f"max_abs_diff={diff:.4f} vs max|logit|={scale:.2f} "
        f"(tolerance {LOGITS_REL_TOL} x max|logit|) {'ok' if ok else 'MISMATCH'}; "
        f"argmax agreement {agree}/{B}")
    if not ok:
        fail("full-width decode_step: kernel and plain paged attention disagree")

    # The bf16 gate above is coarse: bf16 rounding alone moves the logits by
    # ~0.2. The wiring (positions -> seq_lens, each layer's pages) is held
    # tightly in f32 on the first two layers at full width: with TF32 off,
    # the paths differ only by the kernel's summation order (~1e-6 relative).
    cut = dataclasses.replace(cfg, n_layers=2)
    p32 = first_layers_f32(params, 2)
    kp32, vp32 = k_pages[:2].float(), v_pages[:2].float()
    kern, _, _ = llama.decode_step(p32, cut, tokens, positions, kp32, vp32, tables)
    plain, _, _ = llama.decode_step(p32, cut, tokens, positions, kp32, vp32, tables,
                                    paged_attention=paged_decode_attention)
    diff = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    ok = bool(torch.isfinite(kern).all()) and diff <= LOGITS_F32_REL_TOL * scale
    log(f"[decode] {cfg.name} first 2 layers decode_step float32 B={B}: logits "
        f"max_abs_diff={diff:.3e} vs max|logit|={scale:.2f} "
        f"(tolerance {LOGITS_F32_REL_TOL} x max|logit|) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("two-layer f32 decode_step: kernel and plain paged attention disagree")
    del p32, kp32, vp32

    decode_breakdown("decode", step=lambda: llama.decode_step(
        params, cfg, tokens, positions, k_pages, v_pages, tables), B=B,
        n_layers=cfg.n_layers)
    del k_pages, v_pages


def decode_breakdown(tag: str, step, B: int, n_layers: int) -> None:
    """Where a decode step's time goes: host clock with a sync, the host's
    enqueue time alone, and the device time of its kernels by class."""
    from llm_d_inference_scheduler_tpu_torch.tools.timing import kernel_times

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    enqueue_ms = (time.perf_counter() - t0) * 100
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 100
    kt = kernel_times(step, iters=5, warmup=0)
    busy = sum(kt.values())
    k1 = sum(ms for name, ms in kt.items() if "paged_decode" in name)
    k2 = sum(ms for name, ms in kt.items() if "grouped_" in name)
    gemm = sum(ms for name, ms in kt.items() if "gemm" in name or "nvjet" in name
               or "cutlass" in name)
    log(f"[{tag}] decode_step B={B}: wall {wall_ms:.2f} ms/step, host enqueue "
        f"{enqueue_ms:.2f} ms/step, device busy {busy:.2f} ms/step "
        f"({100 * busy / wall_ms:.0f}% of wall): matmuls {gemm:.2f} ms, "
        f"paged attention {k1:.2f} ms ({n_layers} launches), grouped MoE FFN "
        f"{k2:.2f} ms, other kernels {busy - gemm - k1 - k2:.2f} ms")


# ---- phase 5: serve ------------------------------------------------------

SHARED = ("The engine keeps a paged cache of keys and values for every "
          "sequence it serves; a request whose prompt begins with blocks that "
          "are already cached skips recomputing them and prefills only the "
          "rest. This paragraph is the shared system prompt of two requests, "
          "long enough to fill sixteen blocks of sixteen tokens each.")


def serve_prompts(model: str = MODEL) -> list[dict]:
    long_a = SHARED + " Request A asks about throughput. " + "alpha beta gamma " * 40
    long_b = SHARED + " Request B asks about latency. " + "delta epsilon zeta " * 38
    short_c = "Short streamed prompt about decoding tokens, one by one, quickly."
    short_d = "Short sampled prompt: temperature 0.8 with a nucleus of 0.9 ok."
    common = {"model": model, "max_tokens": 32, "ignore_eos": True}
    return [
        {**common, "prompt": long_a, "temperature": 0},
        {**common, "prompt": long_b, "temperature": 0},
        {**common, "prompt": short_c, "temperature": 0, "stream": True},
        {**common, "prompt": short_d, "temperature": 0.8, "top_p": 0.9},
    ]


def http_post(port: int, body: dict) -> dict:
    t0 = time.monotonic()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(), headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        headers = {k.lower(): v for k, v in r.headers.items()}
        if not body.get("stream"):
            return {"headers": headers, "json": json.loads(r.read()),
                    "ttft_s": None, "e2e_s": time.monotonic() - t0}
        text, finish, ttft = "", None, None
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[6:])
            choice = chunk["choices"][0]
            if choice.get("text") and ttft is None:
                ttft = time.monotonic() - t0
            text += choice.get("text", "")
            finish = choice.get("finish_reason") or finish
        return {"headers": headers,
                "json": {"choices": [{"text": text, "finish_reason": finish}]},
                "ttft_s": ttft, "e2e_s": time.monotonic() - t0}


def http_get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.read().decode()


async def serve(cfg_model, params, card: str, *, tag: str = "serve",
                model: str = MODEL, served: str | None = None,
                kernels: tuple[str, ...] = ("paged_decode_attention",),
                events: bool = True, surface: bool = True, device: str = "cuda",
                **engine_kw) -> dict:
    """Serve ``model`` (a registry name or a model_config.json directory)
    through TorchEngine and the HTTP server; fail unless each of ``kernels``
    launched at least n_layers times per decode step and, where K2 is among
    them, its bf16 wgmma path n_layers times per prefill and decode step.
    With ``events`` a /kv_events subscriber is attached before the counted
    requests and the events are checked after them (``check_events``), and
    with ``surface`` too the rest of the router-facing surface
    (``check_surface``); without ``events``, the engine runs with
    ``kv_events_port=0``. Returns the launch counts of this run, K2's
    launches by kernel path, the decode rate and, with ``events``, the
    surface's results."""
    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
    from llm_d_inference_scheduler_tpu_torch.ops import grouped_moe

    cfg = EngineConfig(model=model, served_model_name=served, device=device, port=0,
                       max_batch=8, max_model_len=2048, decode_chunk=8,
                       kv_events_port=-1 if events else 0, **engine_kw)
    name = cfg.model_name
    engine = TorchEngine(cfg, params=params)
    published = tap_publish(engine) if events else None
    server = EngineServer(cfg, engine=engine)
    await server.start()
    subscriber = None
    surface_res = None
    try:
        # Warm-up request (cuBLAS handles, allocator pools) before the count.
        await asyncio.to_thread(http_post, server.port, {
            "prompt": "warm up", "max_tokens": 9, "temperature": 0})
        if events:
            subscriber = SseReader(server.port)
            await asyncio.to_thread(wait_for, lambda: engine.kv_events.hub.subscribers == 1,
                                    10, "the /kv_events subscriber")
            published["armed"] = True
        tel = engine.telemetry
        before = (engine.decode_steps, tel.decode_step.sum, tel.generation_tokens.value,
                  tel.ttft.sum, tel.ttft.count)
        ops.reset_kernel_launches()
        t0 = time.monotonic()
        results = await asyncio.gather(*[asyncio.to_thread(http_post, server.port, b)
                                         for b in serve_prompts(name)])
        wall = time.monotonic() - t0
        launches = ops.kernel_launches()
        paths = dict(grouped_moe.path_launches)
        steps = engine.decode_steps - before[0]
        after = (tel.decode_step.sum, tel.generation_tokens.value, tel.ttft.sum,
                 tel.ttft.count)
        metrics = await asyncio.to_thread(http_get, server.port, "/metrics")
        models = json.loads(await asyncio.to_thread(http_get, server.port, "/v1/models"))
        if events:
            await asyncio.to_thread(check_events, engine, subscriber, published, tag, card)
            if surface:
                surface_res = await check_surface(server, cfg_model, tag, card)
    finally:
        await server.stop()
        if subscriber is not None:
            subscriber.close()

    for i, res in enumerate(results):
        choice = res["json"]["choices"][0]
        log(f"[{tag}] request {i}: finish_reason={choice['finish_reason']} "
            f"text_chars={len(choice['text'])} "
            f"x-kv-hit-tokens={res['headers'].get('x-kv-hit-tokens')} "
            f"e2e={res['e2e_s']:.3f}s")
        if not choice["text"] or choice["finish_reason"] not in ("length", "stop"):
            fail(f"request {i} returned no text or no finish reason: {choice}")
    hits = [int(r["headers"].get("x-kv-hit-tokens", 0)) for r in results[:2]]
    if max(hits) < 256:
        fail(f"the shared-prefix requests took no prefix-cache hit: {hits}")
    names = ("jetstream:num_requests_waiting", "jetstream:num_requests_running",
             "jetstream:kv_cache_usage_perc", "jetstream:lora_requests_info",
             "jetstream:cache_config_info")
    missing = [n for n in names if n not in metrics]
    if missing:
        fail(f"/metrics lacks {missing}")
    if models["data"][0]["id"] != name:
        fail(f"/v1/models: {models}")
    n_layers = cfg_model.n_layers
    need = n_layers * steps
    log(f"[{tag}] decode steps {steps}, launches {launches}, grouped_moe_ffn by "
        f"path {paths} (n_layers x steps = {need})")
    if steps <= 0:
        fail(f"{tag}: the serving run made no decode step")
    for kernel in kernels:
        if launches[kernel] < need:
            fail(f"{tag}: the serving decode did not go through {kernel} "
                 f"({launches[kernel]} launches < {need})")
    # Every request's prefill and every decode step runs each layer's MoE
    # FFN once, all of them on the wgmma path.
    need_wgmma = n_layers * (len(results) + steps)
    if grouped_moe.KERNEL in kernels and paths["wgmma"] < need_wgmma:
        fail(f"{tag}: the prefills and decode steps did not all go through "
             f"grouped_moe_ffn's wgmma path ({paths} < {need_wgmma})")
    # Every request's prefill (whole or after a prefix hit) attends through
    # K3 once per layer, on wgmma (the weights are bf16).
    k3_paths = {p: launches[f"prefill_attention.{p}"] for p in ("wgmma", "simt")}
    if k3_paths["wgmma"] < n_layers * len(results) or k3_paths["simt"]:
        fail(f"{tag}: the prefills did not all attend through prefill_attention's "
             f"wgmma path ({k3_paths}, want >= {n_layers * len(results)} on wgmma)")
    dec_s = after[0] - before[1]
    dec_tokens = after[1] - before[2] - len(results)
    ttft_mean = (after[2] - before[3]) / max(after[3] - before[4], 1)
    stream_ttft = results[2]["ttft_s"]
    rate = dec_tokens / dec_s
    log(f"[{tag}] {name}, {card}, KV events {'on, one subscriber' if events else 'off'}: "
        f"4 requests in {wall:.3f}s; engine TTFT mean "
        f"{ttft_mean * 1e3:.1f} ms (streamed request, client side "
        f"{stream_ttft * 1e3:.1f} ms); decode {dec_tokens:.0f} tokens in "
        f"{dec_s:.3f}s of decode chunks = {rate:.1f} tok/s")
    return {"launches": launches, "paths": paths, "tok_s": rate, "surface": surface_res}


def serve_in_turns(cfg_model, params, card: str, tag: str, **kw) -> tuple[dict, dict]:
    """Four serve runs in the order events off, on (the main path, with
    the surface checks), on, off; returns the main run's result and the
    decode tok/s of each setting in run order."""
    rates: dict[bool, list[float]] = {False: [], True: []}
    main_run = None
    for i, events in enumerate((False, True, True, False)):
        res = asyncio.run(serve(
            cfg_model, params, card, events=events, surface=i == 1,
            tag=tag if i == 1 else f"{tag}-{'events' if events else 'no-events'}-{i}",
            **kw))
        rates[events].append(round(res["tok_s"], 1))
        if i == 1:
            main_run = res
    return main_run, rates


# ---- phases 5 and 8: the router-facing surface ----------------------------

# The second subscriber, joining an idle engine after the requests, must
# learn the cache from the snapshot within this (the snapshot's period is
# 1 s).
SNAPSHOT_WAIT_S = 2.0
# Mixtral embeddings, grouped (K2) against the dense-over-experts FFN on the
# same bf16 weights, 16 layers, each pooled over a ~1100-token prompt: each
# token's final-norm hidden state carries the two FFNs' rounding differences
# (a few bf16 steps per layer, as in phase 7), and a token whose top-2
# routing flips at a near-tie carries another expert's output; the mean over
# ~1100 tokens dilutes both. Allow 5e-2 of the dense vector's largest
# magnitude, the coarse gate phase 7 holds the logits to (MOE_LOGITS_REL_TOL).
EMBED_REL_TOL = 5e-2
EVICT_PROMPT_BYTES = 99   # BOS + 99 bytes = 100 tokens: 6 full blocks
EVICT_TOKENS = 8          # 100 + 8 tokens need 7 blocks, the small pool's all


class SseReader:
    """A raw ``http.client`` subscriber of /kv_events on a thread of its own,
    recording (receipt time, event document) for each data frame."""

    def __init__(self, port: int):
        import http.client
        import threading

        self.events: list[tuple[float, dict]] = []
        self.status = None
        self._conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self) -> None:
        try:
            self._conn.request("GET", "/kv_events")
            r = self._conn.getresponse()
            self.status = r.status
            while True:
                line = r.fp.readline()
                if not line:
                    return
                if line.startswith(b"data: "):
                    self.events.append((time.monotonic(), json.loads(line[6:])))
        except (OSError, ValueError, AttributeError):
            pass  # the stream was closed under the reader

    def hashes(self, event: str) -> set[int]:
        return {h for _, e in list(self.events) if e["event"] == event
                for h in e["hashes"]}

    def close(self) -> None:
        import socket

        if self._conn.sock is not None:
            try:
                self._conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._thread.join(10)
        self._conn.close()


def wait_for(pred, timeout: float, what: str) -> float:
    """Poll ``pred`` until it holds; returns the seconds it took."""
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            fail(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.005)
    return time.monotonic() - t0


def tap_publish(engine) -> dict:
    """The publish times of the engine's KV events by content, recorded from
    the moment ``armed`` is set."""
    import collections

    rec = {"armed": False, "times": collections.defaultdict(collections.deque)}
    publish = engine.kv_events.publish

    def tap(event, hashes):
        if rec["armed"] and hashes:
            rec["times"][(event, tuple(hashes))].append(time.monotonic())
        publish(event, hashes)

    engine.kv_events.publish = tap
    return rec


def event_lags_ms(subscriber: SseReader, published: dict) -> list[float]:
    """Publish-to-receipt lag of each received event that was published
    after arming (each receipt takes the earliest unmatched publish of the
    same content at or before it)."""
    lags = []
    for t_recv, doc in list(subscriber.events):
        q = published["times"].get((doc["event"], tuple(doc["hashes"])))
        if q and q[0] <= t_recv:
            lags.append((t_recv - q.popleft()) * 1e3)
    return lags


def check_events(engine, subscriber: SseReader, published: dict, tag: str,
                 card: str) -> None:
    """The served prompts' full blocks reached the subscriber as stored; a
    second subscriber joining now learns the cache from the snapshot."""
    from llm_d_inference_scheduler_tpu_torch.utils.hashing import chain_block_hashes

    block = engine.mcfg.kv_block_size
    want = {h for b in serve_prompts(engine.model_name)
            for h in chain_block_hashes(engine.model_name,
                                        engine.tokenizer.encode(b["prompt"]), "", block)}
    wait_for(lambda: want <= subscriber.hashes("stored"), 10,
             f"{tag}: stored events for every full block of the served prompts")
    if subscriber.status != 200:
        fail(f"{tag}: /kv_events answered {subscriber.status}")
    lags = sorted(event_lags_ms(subscriber, published))
    if not lags:
        fail(f"{tag}: no event could be matched to its publish")
    cached = set(engine.allocator.cached_hashes())
    late = SseReader(engine.advertised_port)
    try:
        took = wait_for(lambda: cached <= late.hashes("stored"), SNAPSHOT_WAIT_S,
                        f"{tag}: the snapshot to reach a subscriber that joined late")
    finally:
        late.close()
    log(f"[{tag}] KV events, {card}: {len(subscriber.events)} events to the "
        f"subscriber, stored covers all {len(want)} full blocks of the served "
        f"prompts; publish-to-receipt lag median {lags[len(lags) // 2]:.3f} ms, "
        f"max {lags[-1]:.3f} ms over {len(lags)} events; a late subscriber had "
        f"the {len(cached)} cached hashes after {took * 1e3:.0f} ms")


def http_json(port: int, path: str, body: dict) -> tuple[dict, object, float]:
    """POST ``body``; returns (headers, the JSON reply or, for an SSE reply,
    its list of data documents, seconds)."""
    t0 = time.monotonic()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        headers = {k.lower(): v for k, v in r.headers.items()}
        raw = r.read().decode()
    if headers.get("content-type", "").startswith("text/event-stream"):
        docs = [json.loads(line[6:]) for line in raw.splitlines()
                if line.startswith("data: ") and line != "data: [DONE]"]
        return headers, docs, time.monotonic() - t0
    return headers, json.loads(raw), time.monotonic() - t0


async def check_surface(server, cfg_model, tag: str, card: str) -> dict:
    """Render, responses and embeddings on the serving engine. The embed
    calls are a path of their own: the kernel counts are set to 0 just
    before them and read just after. Returns the embeddings' vectors and
    launches."""
    import numpy as np

    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.ops import grouped_moe

    engine, port = server.engine, server.port
    tok = engine.tokenizer
    bodies = serve_prompts(engine.model_name)
    for b in bodies:
        _, r, _ = await asyncio.to_thread(http_json, port, "/v1/completions/render",
                                          {"prompt": b["prompt"]})
        if r["token_ids"] != tok.encode(b["prompt"]) or r["count"] != len(r["token_ids"]):
            fail(f"{tag}: /v1/completions/render differs from the tokenizer")
    messages = [{"role": "system", "content": "Answer in one short sentence."},
                {"role": "user", "content": "What does a paged KV cache hold?"}]
    _, r, _ = await asyncio.to_thread(http_json, port, "/v1/chat/completions/render",
                                      {"messages": messages})
    if r["token_ids"] != tok.encode(r["rendered"]):
        fail(f"{tag}: /v1/chat/completions/render differs from the tokenizer")

    # Greedy chat and responses on the same messages. A primer request
    # caches the prompt's full blocks first, so that both prefill over the
    # same cached prefix (a prefill with and without a prior part rounds
    # differently in bf16).
    gen = {"temperature": 0, "ignore_eos": True}
    await asyncio.to_thread(http_json, port, "/v1/chat/completions",
                            {"messages": messages, "max_tokens": 1, **gen})
    _, chat, _ = await asyncio.to_thread(http_json, port, "/v1/chat/completions",
                                         {"messages": messages, "max_tokens": 16, **gen})
    resp_body = {"instructions": messages[0]["content"], "input": messages[1]["content"],
                 "max_output_tokens": 16, **gen}
    _, resp, _ = await asyncio.to_thread(http_json, port, "/v1/responses", resp_body)
    _, streamed, _ = await asyncio.to_thread(http_json, port, "/v1/responses",
                                             {**resp_body, "stream": True})
    chat_text = chat["choices"][0]["message"]["content"]
    resp_text = resp["output"][0]["content"][0]["text"]
    stream_text = "".join(d["delta"] for d in streamed
                          if d["type"] == "response.output_text.delta")
    if (resp_text != chat_text or stream_text != chat_text
            or resp["usage"]["output_tokens"] != 16
            or streamed[-1]["type"] != "response.completed"):
        fail(f"{tag}: /v1/responses {resp_text!r} (streamed {stream_text!r}) differs "
             f"from the chat text {chat_text!r}")

    # Embeddings of the two ~1100-token prompts, one call each, counted.
    long_prompts = [b["prompt"] for b in bodies[:2]]
    embed_calls: list[tuple[float, float]] = []
    timed(engine, "_op_embed", embed_calls, sync=engine.device.type == "cuda")
    ops.reset_kernel_launches()
    vecs, http_ms = [], []
    for prompt in long_prompts:
        _, r, dt = await asyncio.to_thread(http_json, port, "/v1/embeddings",
                                           {"input": prompt})
        vecs.append(np.asarray(r["data"][0]["embedding"], np.float32))
        http_ms.append(dt * 1e3)
        if r["usage"]["prompt_tokens"] != len(tok.encode(prompt)):
            fail(f"{tag}: /v1/embeddings usage {r['usage']}")
    launches = ops.kernel_launches()
    paths = dict(grouped_moe.path_launches)
    embed_ms = [round(c, 2) for _, c in embed_calls]
    for v in vecs:
        if v.shape != (cfg_model.d_model,) or not np.isfinite(v).all():
            fail(f"{tag}: an embedding of shape {v.shape} with non-finite values")
    if np.allclose(vecs[0], vecs[1]):
        fail(f"{tag}: two different prompts pooled to the same vector")
    n = len(long_prompts)
    if launches["paged_decode_attention"] != 0:
        fail(f"{tag}: embeddings launched K1 ({launches})")
    if launches["prefill_attention.wgmma"] != cfg_model.n_layers * n:
        fail(f"{tag}: embeddings did not attend through K3 on wgmma n_layers times "
             f"per call ({launches}, want {cfg_model.n_layers * n})")
    if cfg_model.n_experts and engine.mcfg.moe_impl == "grouped" and (
            launches[grouped_moe.KERNEL] != cfg_model.n_layers * n
            or paths["wgmma"] != cfg_model.n_layers * n):
        fail(f"{tag}: embeddings did not run K2 on wgmma n_layers times per "
             f"call ({launches}, by path {paths}, want {cfg_model.n_layers * n})")
    log(f"[{tag}] surface, {card}: render = tokenizer on {len(bodies)} prompts + "
        f"chat; greedy /v1/responses (plain and streamed) = chat text "
        f"({len(chat_text)} chars); embeddings of {n} prompts "
        f"({[len(tok.encode(p)) for p in long_prompts]} tokens): engine "
        f"{embed_ms} ms, HTTP {[round(t, 1) for t in http_ms]} ms; launches "
        f"{launches}, grouped_moe_ffn by path {paths}")
    return {"vecs": vecs, "ids": [tok.encode(p) for p in long_prompts],
            "launches": launches, "paths": paths, "embed_ms": embed_ms}


async def check_eviction(params, card: str, *, tag: str, model: str = MODEL,
                         served: str | None = None, device: str = "cuda",
                         **engine_kw) -> None:
    """A small engine whose page pool (7 usable blocks) holds one request:
    three ~100-token prompts in turn each evict the previous one's 6 parked
    blocks, so ``removed`` must name exactly the first two prompts' hashes
    and ``stored`` all three's."""
    from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
    from llm_d_inference_scheduler_tpu_torch.utils.hashing import chain_block_hashes

    cfg = EngineConfig(model=model, served_model_name=served, device=device, port=0,
                       max_batch=1, max_model_len=128, hbm_kv_blocks=8,
                       decode_chunk=8, **engine_kw)
    engine = TorchEngine(cfg, params=params)
    server = EngineServer(cfg, engine=engine)
    prompts = [(f"[eviction {i}] " + "The pool keeps one request's blocks. " * 4)
               [:EVICT_PROMPT_BYTES] for i in range(3)]
    chains = [chain_block_hashes(cfg.model_name, engine.tokenizer.encode(p), "",
                                 engine.mcfg.kv_block_size) for p in prompts]
    await server.start()
    sub = SseReader(server.port)
    try:
        await asyncio.to_thread(wait_for, lambda: engine.kv_events.hub.subscribers == 1,
                                10, f"{tag}: the eviction engine's subscriber")
        for p in prompts:
            await asyncio.to_thread(http_post, server.port, {
                "prompt": p, "max_tokens": EVICT_TOKENS, "temperature": 0,
                "ignore_eos": True})
        want_removed = set(chains[0]) | set(chains[1])
        await asyncio.to_thread(
            wait_for, lambda: set(chains[2]) <= sub.hashes("stored")
            and want_removed <= sub.hashes("removed"), 10,
            f"{tag}: the eviction engine's events")
        removed, stored = sub.hashes("removed"), sub.hashes("stored")
    finally:
        await server.stop()
        sub.close()
    if removed != want_removed or stored != want_removed | set(chains[2]):
        fail(f"{tag}: removed names {len(removed)} hashes "
             f"({len(removed & want_removed)} of the {len(want_removed)} evicted), "
             f"stored {len(stored)}")
    log(f"[{tag}] eviction, {card}: removed = exactly the {len(want_removed)} "
        f"evicted hashes of the first two prompts; stored all {len(stored)}")


def check_moe_embed_dense(surface: dict, params, model_dir: str, card: str, *,
                          device: str = "cuda") -> None:
    """The grouped (K2) embeddings of the serve run against an engine with
    the dense-over-experts FFN on the same weights and prompts."""
    import numpy as np

    from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine

    cfg = EngineConfig(model=model_dir, served_model_name=MOE_SERVED, device=device,
                       max_batch=1, max_model_len=2048, kv_events_port=0)
    dense = TorchEngine(cfg, params=params)
    if dense.mcfg.moe_impl != "dense":
        fail(f"moe-serve: the comparison engine runs {dense.mcfg.moe_impl}")
    calls: list[tuple[float, float]] = []
    timed(dense, "_op_embed", calls, sync=dense.device.type == "cuda")
    asyncio.run(dense.start())
    try:
        ref = [dense.embed(ids) for ids in surface["ids"]]
    finally:
        asyncio.run(dense.stop())
    errs = []
    for got, want in zip(surface["vecs"], ref):
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        errs.append((err, scale))
        if not err <= EMBED_REL_TOL * scale:
            fail(f"moe-serve: grouped embedding differs from dense by {err} "
                 f"(> {EMBED_REL_TOL} x {scale})")
    log(f"[moe-serve] embeddings grouped (K2) against dense, {card}: max abs "
        f"difference / max |dense| = "
        f"{[f'{e:.4g}/{m:.4g}' for e, m in errs]} (limit {EMBED_REL_TOL} x max); "
        f"engine ms grouped {surface['embed_ms']}, dense "
        f"{[round(c, 2) for _, c in calls]}")


# ---- phase 5b: P/D KV handoff ---------------------------------------------

PD_PREFILL_CHUNK = 256
PD_TOKENS = 32


def pd_prompts() -> dict[str, str]:
    """Three ~1030-token prompts (BOS + 1029 bytes) whose first blocks
    differ, so no prefill takes a prefix hit from another."""
    body = ("The decode engine pulls the keys and values of every prompt block "
            "from the prefill engine, chunk by chunk while later chunks are "
            "still being computed, and then decodes from them. ")
    out = {}
    for name in ("serial", "pipelined", "staged"):
        text = f"[{name} handoff] " + body * 8
        out[name] = text[:1029]
    return out


def tap_engine(engine) -> tuple[dict, dict]:
    """Token ids each request emitted, and the monotonic time of its first
    token (the engine thread's emit)."""
    tokens: dict[str, list[int]] = {}
    first_at: dict[str, float] = {}
    emit = engine._emit

    def tap(slot, ev):
        if ev.token_id is not None:
            first_at.setdefault(ev.request_id, time.monotonic())
            tokens.setdefault(ev.request_id, []).append(ev.token_id)
        emit(slot, ev)

    engine._emit = tap
    return tokens, first_at


def timed(engine, name: str, record: list, *, sync: bool):
    """Wrap engine.<name>: each call appends (ms waiting for the queued
    device work, ms of the call itself); both end in a synchronize on the
    card. The first is what the call would also wait for unwrapped."""
    fn = getattr(engine, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        if sync:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        record.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        return out

    setattr(engine, name, wrapper)


def http_status(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def first_divergence(a: list[int], b: list[int]) -> int | None:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


async def phase_pd(cfg_model, params, card: str, *, model: str = MODEL,
                   device: str = "cuda") -> int:
    """Serve the two P/D protocols between two port engines over HTTP and
    hold them against a monolithic engine; returns K1's launches over the
    P/D run (the decode engine's)."""
    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer

    # The host /kv path (phase 13e drives the device wire).
    kw = dict(model=model, device=device, port=0, max_batch=8,
              max_model_len=2048, decode_chunk=8, kv_transfer="host")
    prompts = pd_prompts()
    sync = device == "cuda"

    def request(prompt, rid, max_tokens=PD_TOKENS, ktp=None):
        body = {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0,
                "ignore_eos": True, "request_id": rid}
        if ktp is not None:
            body["kv_transfer_params"] = ktp
        return body

    # The monolithic reference, alone on the card with the pair's
    # prefill_chunk (its KV pages leave before the pair's arrive).
    cfg_m = EngineConfig(**kw, prefill_chunk=PD_PREFILL_CHUNK)
    engine = TorchEngine(cfg_m, params=params)
    mono_tokens, mono_first = tap_engine(engine)
    server = EngineServer(cfg_m, engine=engine)
    await server.start()
    mono_ttft = {}
    try:
        await asyncio.to_thread(http_post, server.port, request("warm up", "warm", 9))
        for name, prompt in prompts.items():
            t0 = time.monotonic()
            await asyncio.to_thread(http_post, server.port, request(prompt, f"mono-{name}"))
            mono_ttft[name] = (mono_first[f"mono-{name}"] - t0) * 1e3
    finally:
        await server.stop()
    del engine, server
    gc.collect()
    if sync:
        torch.cuda.empty_cache()

    cfg_p = EngineConfig(**kw, prefill_chunk=PD_PREFILL_CHUNK)
    cfg_d = EngineConfig(**kw)
    pre, dec = TorchEngine(cfg_p, params=params), TorchEngine(cfg_d, params=params)
    dec_tokens, dec_first = tap_engine(dec)
    chunk_stalls, export_stalls, imports, windows = [], [], [], []
    # Host time of each prefill dispatch (no sync): the engine thread's
    # enqueue, which the other threads of this one process contend with.
    timed(pre, "_run_prefill", windows, sync=False)
    timed(pre, "_maybe_stage_chunk", chunk_stalls, sync=sync)
    timed(pre, "_op_stage_kv", export_stalls, sync=sync)
    timed(dec, "_import_into_slot", imports, sync=sync)
    # Each import is held bitwise against the exporter's pages right away
    # (the exporter's blocks park in its prefix cache, untouched meanwhile).
    exported: dict[str, list[int]] = {}
    page_checks: list[tuple[str, bool]] = []
    stage_kv = pre._op_stage_kv

    def record_ids(**kwargs):
        exported[kwargs["request_id"]] = kwargs["idx"][: kwargs["meta"]["num_blocks"]].tolist()
        return stage_kv(**kwargs)

    pre._op_stage_kv = record_ids
    import_into = dec._import_into_slot

    def check_pages(idx, pi, blocks):
        import_into(idx, pi, blocks)
        src = exported[pi.req.kv_transfer_params["remote_request_id"]]
        d_ids = torch.tensor(blocks[: len(src)], device=dec.device)
        p_ids = torch.tensor(src, device=pre.device)
        same = (torch.equal(dec.k_pages[:, d_ids], pre.k_pages[:, p_ids])
                and torch.equal(dec.v_pages[:, d_ids], pre.v_pages[:, p_ids]))
        page_checks.append((pi.req.request_id, same))

    dec._import_into_slot = check_pages
    chunks_at_release: dict[str, int] = {}
    release = pre.release_kv_export

    def count_release(rid, **kwargs):
        rec = pre.get_kv_export(rid)
        if rec is not None:
            chunks_at_release[rid] = rec.get("chunks_staged", 0)
        release(rid, **kwargs)

    pre.release_kv_export = count_release

    p_srv, d_srv = EngineServer(cfg_p, engine=pre), EngineServer(cfg_d, engine=dec)
    await p_srv.start()
    await d_srv.start()
    res = {}
    try:
        for srv in (p_srv, d_srv):
            await asyncio.to_thread(http_post, srv.port, request("warm up", "warm", 9))
        steps0 = dec.decode_steps
        windows.clear()  # the warm-up's prefill
        ops.reset_kernel_launches()
        # (a) serial: prefill leg -> kv_transfer_params -> decode leg
        t0 = time.monotonic()
        r1 = await asyncio.to_thread(http_post, p_srv.port, request(
            prompts["serial"], "p-serial", 1, {"do_remote_decode": True}))
        ktp = r1["json"]["kv_transfer_params"]
        r2 = await asyncio.to_thread(http_post, d_srv.port, request(
            prompts["serial"], "d-serial", ktp=ktp))
        res["serial"] = (r2, (dec_first["d-serial"] - t0) * 1e3)
        serial_windows = [round(c, 1) for _, c in windows]
        # (b) pipelined, as the sidecar: pre-assigned id, prefill leg in
        # flight, first-chunk ack, then the decode leg pulling chunks
        chunk_stalls.clear()  # the serial prefill's calls staged nothing
        windows.clear()
        t0 = time.monotonic()
        rid = "p-pipelined"
        prefill = asyncio.create_task(asyncio.to_thread(http_post, p_srv.port, request(
            prompts["pipelined"], rid, 1,
            {"do_remote_decode": True, "stream_chunks": True})))
        while await asyncio.to_thread(http_status, p_srv.port,
                                      f"/kv/{rid}?ack=1&wait_ms=500") != 200:
            if prefill.done() or time.monotonic() - t0 > 120:
                fail("pd: the prefill engine never acked a first chunk")
        ack_ms = (time.monotonic() - t0) * 1e3
        r3 = await asyncio.to_thread(http_post, d_srv.port, request(
            prompts["pipelined"], "d-pipelined", ktp={
                "remote_host": "127.0.0.1", "remote_port": p_srv.port,
                "remote_request_id": rid, "stream_chunks": True,
                "remote_scheme": "http"}))
        prefill_ms = ((await prefill)["e2e_s"]) * 1e3  # leg started ~t0
        res["pipelined"] = (r3, (dec_first["d-pipelined"] - t0) * 1e3)
        pipelined_windows = [round(c, 1) for _, c in windows]
        # (c) chunk-staged, pulled only once the prefill leg has answered:
        # the staging's cost to the windows without a puller in the
        # process, and the chunked pull's own time without waiting.
        windows.clear()
        t0 = time.monotonic()
        await asyncio.to_thread(http_post, p_srv.port, request(
            prompts["staged"], "p-staged", 1,
            {"do_remote_decode": True, "stream_chunks": True}))
        staged_prefill_ms = (time.monotonic() - t0) * 1e3
        r4 = await asyncio.to_thread(http_post, d_srv.port, request(
            prompts["staged"], "d-staged", ktp={
                "remote_host": "127.0.0.1", "remote_port": p_srv.port,
                "remote_request_id": "p-staged", "stream_chunks": True,
                "remote_scheme": "http"}))
        res["staged"] = (r4, None)
        launches = ops.kernel_launches()["paged_decode_attention"]
        steps = dec.decode_steps - steps0
        left = dict(pre.kv_exports)
    finally:
        await p_srv.stop()
        await d_srv.stop()

    for name in prompts:
        want = mono_tokens[f"mono-{name}"]
        got = dec_tokens[f"d-{name}"]
        at = first_divergence(got, want)
        log(f"[pd] {name}: {len(got)} tokens, monolithic {len(want)}; "
            f"{'equal' if at is None else f'first divergence at position {at}'}")
        if at is not None or len(want) != PD_TOKENS:
            fail(f"pd {name}: decode tokens differ from the monolithic engine's at "
                 f"position {at}: {got[:at + 3 if at is not None else None]} vs "
                 f"{want[:at + 3 if at is not None else None]}")
    log(f"[pd] imported pages equal the exporter's bitwise: {page_checks}")
    if len(page_checks) != len(prompts) or not all(ok for _, ok in page_checks):
        fail(f"pd: imported pages differ from the exporter's: {page_checks}")
    h_s, h_p = res["serial"][0]["headers"], res["pipelined"][0]["headers"]
    h_c = res["staged"][0]["headers"]
    if h_s.get("x-kv-pull-route") != "host":
        fail(f"pd serial: pull route {h_s.get('x-kv-pull-route')}")
    n_chunks = chunks_at_release.get(rid, 0)
    pull_ms, exposed_ms = float(h_p["x-kv-pull-ms"]), float(h_p["x-kv-pull-exposed-ms"])
    if h_p.get("x-kv-pull-route") != "host-chunked" or n_chunks < 4 or exposed_ms > pull_ms:
        fail(f"pd pipelined: route {h_p.get('x-kv-pull-route')}, {n_chunks} chunks, "
             f"exposed {exposed_ms} ms of {pull_ms} ms")
    if left:
        fail(f"pd: the prefill engine still holds exports {list(left)}")
    need = cfg_model.n_layers * steps
    if steps <= 0 or launches < need:
        fail(f"pd: the decode engine's steps did not go through K1 "
             f"({launches} launches < {need}, {steps} steps)")
    stall = [round(c, 3) for w, c in chunk_stalls]
    waits = [round(w, 3) for w, c in chunk_stalls]
    log(f"[pd] {model}, {card}: bytes pulled serial {h_s['x-kv-pull-bytes']} "
        f"(pow2-padded blocks), pipelined {h_p['x-kv-pull-bytes']} "
        f"({n_chunks} chunks, real blocks); pull ms serial {h_s['x-kv-pull-ms']}, "
        f"pipelined {pull_ms} (exposed {exposed_ms})")
    log(f"[pd] {model}, {card}: engine-thread staging per chunk (gather + D2H; "
        f"pipelined, then staged) {stall} ms after waiting {waits} ms for the window's queued work; "
        f"full export staging {[round(c, 3) for w, c in export_stalls]} ms "
        f"(after {[round(w, 3) for w, c in export_stalls]} ms); import "
        f"(H2D + scatter) {[round(c, 3) for w, c in imports]} ms")
    log(f"[pd] {model}, {card}: TTFT (request start to the decode engine's "
        f"first token) serial {res['serial'][1]:.1f} ms, pipelined "
        f"{res['pipelined'][1]:.1f} ms; monolithic {mono_ttft['serial']:.1f} / "
        f"{mono_ttft['pipelined']:.1f} ms (serial / pipelined prompt); decode "
        f"steps {steps}, K1 launches {launches} (n_layers x steps = {need})")
    log(f"[pd] {model}, {card}: prefill windows' host ms (enqueue, no sync) "
        f"serial {serial_windows}, pipelined {pipelined_windows}, staged without "
        f"a puller {[round(c, 1) for _, c in windows]}; prefill leg answered "
        f"after {prefill_ms:.1f} ms pipelined (first-chunk ack at {ack_ms:.1f} "
        f"ms), {staged_prefill_ms:.1f} ms staged; the staged export pulled "
        f"afterwards: {h_c.get('x-kv-pull-route')} {h_c.get('x-kv-pull-bytes')} "
        f"bytes in {h_c.get('x-kv-pull-ms')} ms (exposed "
        f"{h_c.get('x-kv-pull-exposed-ms')})")
    return launches


# ---- phase 5c: E/P/D multimodal --------------------------------------------

EPD_TOKENS = 32
EPD_IMAGES = 3
EPD_TEXT = ("Three images follow the placeholders: say what each one shows, "
            "then compare them in one short paragraph. ") * 3
EPD_PROBE = "A prompt no engine has seen, for the cold shared-storage probe. " * 3


def epd_items() -> list[dict]:
    """Three seeded 32 x 32 x 3 images as inline pixels (the tower's size)."""
    import numpy as np

    rng = np.random.default_rng(6)
    return [{"type": "image_url",
             "pixels": rng.standard_normal((32, 32, 3)).astype(np.float32).tolist()}
            for _ in range(EPD_IMAGES)]


def health(port: int) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


async def time_to_ready(cfg, params) -> float:
    """Seconds from an engine server's start to /health 200 ok."""
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer

    t0 = time.monotonic()
    server = EngineServer(cfg, engine=TorchEngine(cfg, params=params))
    await server.start()
    try:
        while (await asyncio.to_thread(health, server.port))[0] != 200:
            if server.engine.failure is not None:
                fail(f"warm-up failed: {server.engine.failure!r}")
            if time.monotonic() - t0 > 300:
                fail("an engine server was not ready after 300 s")
            await asyncio.sleep(0.01)
        return time.monotonic() - t0
    finally:
        await server.stop()


async def phase_epd(cfg_model, params, card: str, *, model: str = MODEL,
                    device: str = "cuda") -> int:
    """E/P/D at llama3-8b width and depth, as the router's sidecar drives it:
    two encode servers (the items round-robin, 0 and 2 on A, 1 on B), then a
    prefill leg and a decode leg that both name the encoders in
    ``ec_sources``; held against the tower run here, the items' order, one
    E/D engine given the same sources, and the text-only prompt. Also the
    shared-storage probe and the time to ready with and without warm-up.
    Returns K1's launches on the E/P/D decode leg."""
    import numpy as np

    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
    from llm_d_inference_scheduler_tpu_torch.models import llama, vision

    kw = dict(model=model, device=device, port=0, max_batch=8, max_model_len=2048,
              decode_chunk=8, kv_transfer="host")
    sync = device == "cuda"
    # Encode workers share the served model's weights (their tower projects
    # into its d_model) and hold a few KV blocks only.
    cfgs = {"enc_a": EngineConfig(**kw, role="encode", hbm_kv_blocks=4),
            "enc_b": EngineConfig(**kw, role="encode", hbm_kv_blocks=4),
            "pre": EngineConfig(**kw, role="prefill", prefill_chunk=PD_PREFILL_CHUNK),
            "dec": EngineConfig(**kw, role="decode"),
            "mono": EngineConfig(**kw, prefill_chunk=PD_PREFILL_CHUNK)}
    srv = {n: EngineServer(c, engine=TorchEngine(c, params=params))
           for n, c in cfgs.items()}
    dec_tokens, dec_first = tap_engine(srv["dec"].engine)
    mono_tokens, mono_first = tap_engine(srv["mono"].engine)
    prefill_ms: list = []
    timed(srv["pre"].engine, "_run_prefill", prefill_ms, sync=sync)
    tower_ms: list = []  # the tower's own share of each encode request
    for n in ("enc_a", "enc_b"):
        timed(srv[n].engine, "encode_images", tower_ms, sync=sync)
    pulls: list[tuple[str, int, float]] = []
    resolved: dict[str, np.ndarray] = {}
    fetch_ec, resolve = srv["dec"]._fetch_ec, srv["dec"]._resolve_multimodal

    def timed_fetch(source, rid, headers):
        t0 = time.perf_counter()
        payload = fetch_ec(source, rid, headers)
        pulls.append((source, len(payload or b""), (time.perf_counter() - t0) * 1e3))
        return payload

    async def recorded_resolve(body, prompt_ids):
        t0 = time.perf_counter()
        out = await resolve(body, prompt_ids)
        if out[1] is not None:
            resolved[body.get("request_id")] = out[1]
            resolved["ms"] = (time.perf_counter() - t0) * 1e3
        return out

    srv["dec"]._fetch_ec = timed_fetch
    srv["dec"]._resolve_multimodal = recorded_resolve
    for s in srv.values():
        await s.start()
    try:
        roles = {n: (await asyncio.to_thread(health, s.port))[1]["role"]
                 for n, s in srv.items()}
        if [roles[n] for n in ("enc_a", "enc_b", "pre", "dec")] != [
                "encode", "encode", "prefill", "decode"]:
            fail(f"epd: /health roles {roles}")
        for s in srv.values():
            await asyncio.to_thread(http_post, s.port, {
                "prompt": "warm up", "max_tokens": 9, "temperature": 0})

        # Encode, as the sidecar's fan-out: both encoders at once. The
        # tower must launch no K1.
        rid = "epd-1"
        items = epd_items()
        shares = {"enc_a": [0, 2], "enc_b": [1]}
        ops.reset_kernel_launches()
        enc_res = await asyncio.gather(*[asyncio.to_thread(
            http_json, srv[n].port, "/v1/encode",
            {"request_id": rid, "items": [items[i] for i in idx], "item_indices": idx})
            for n, idx in shares.items()])
        tower_k1 = ops.kernel_launches()["paged_decode_attention"]
        enc_ms = [round(r[2] * 1e3, 3) for r in enc_res]
        # Each encoder's staged rows against the tower run here on the same
        # pixels (same device, same ops, same batch: exact).
        vcfg = dataclasses.replace(vision.VIT_TINY, out_dim=cfg_model.d_model)
        gen = torch.Generator(device=device).manual_seed(cfgs["enc_a"].seed)
        vparams = vision.init_vision_params(vcfg, device, gen)
        for n, idx in shares.items():
            px = torch.tensor(np.stack([np.asarray(items[i]["pixels"], np.float32)
                                        for i in idx]), device=device)
            with torch.no_grad():
                want = vision.encode_image(vparams, vcfg, px)
            want = want.reshape(-1, want.shape[-1]).float().cpu().numpy()
            got = srv[n].ec_store[rid]["embeds"]
            if got.shape != want.shape or not np.array_equal(got, want):
                fail(f"epd: {n}'s staged rows differ from the tower run here "
                     f"({got.shape} vs {want.shape})")
        sources = [f"127.0.0.1:{srv[n].port}" for n in ("enc_a", "enc_b")]
        body = {"prompt": EPD_TEXT, "max_tokens": EPD_TOKENS, "temperature": 0,
                "ignore_eos": True, "request_id": rid, "ec_sources": sources}

        # E/P/D: the prefill leg, then the decode leg with its
        # kv_transfer_params; K1 counted over exactly these two legs.
        ops.reset_kernel_launches()
        steps0 = srv["dec"].engine.decode_steps
        prefill_ms.clear()
        t0 = time.monotonic()
        r1 = await asyncio.to_thread(http_post, srv["pre"].port, {
            **body, "kv_transfer_params": {"do_remote_decode": True}})
        ktp = r1["json"]["kv_transfer_params"]
        r2 = await asyncio.to_thread(http_post, srv["dec"].port, {
            **body, "kv_transfer_params": ktp})
        epd_ttft = (dec_first[rid] - t0) * 1e3
        epd_launches = ops.kernel_launches()["paged_decode_attention"]
        epd_steps = srv["dec"].engine.decode_steps - steps0
        mm_prefill = [round(c, 3) for _, c in prefill_ms]
        epd_pulls = list(pulls)

        # E/D: one engine that prefills and decodes, the same sources.
        t0 = time.monotonic()
        await asyncio.to_thread(http_post, srv["mono"].port, body)
        ed_ttft = (mono_first[rid] - t0) * 1e3

        # Text-only P/D: the same text, no images.
        text = {k: v for k, v in body.items() if k != "ec_sources"}
        t0 = time.monotonic()
        r3 = await asyncio.to_thread(http_post, srv["pre"].port, {
            **text, "request_id": "pd-text",
            "kv_transfer_params": {"do_remote_decode": True}})
        await asyncio.to_thread(http_post, srv["dec"].port, {
            **text, "request_id": "pd-text",
            "kv_transfer_params": r3["json"]["kv_transfer_params"]})
        text_ttft = (dec_first["pd-text"] - t0) * 1e3

        # The shared-storage probe: cold on a prompt nobody served (no block
        # moves), warm on the text prompt the decode engine just imported.
        alloc = srv["dec"].engine.allocator
        free0 = (alloc.free_blocks, alloc.reusable_blocks)
        cold = await asyncio.to_thread(http_post, srv["dec"].port, {
            "prompt": EPD_PROBE, "max_tokens": 1, "cache_hit_threshold": 0.5})
        free1 = (alloc.free_blocks, alloc.reusable_blocks)
        warm = await asyncio.to_thread(http_post, srv["dec"].port, {
            "prompt": EPD_TEXT, "max_tokens": 1, "temperature": 0,
            "ignore_eos": True, "cache_hit_threshold": 0.5})
        # The splice's effect on the first token's logits: the multimodal
        # prompt against the same placeholder prompt without embeddings.
        mm = resolved[rid]
        ids = [0] * mm.shape[0] + srv["dec"].engine.tokenizer.encode(EPD_TEXT)
        tok = torch.tensor([ids], device=device)
        with torch.no_grad():
            h_mm, _ = llama.forward(params, cfg_model, tok, want_hidden=True,
                                    mm_embeds=torch.tensor(mm[None], device=device),
                                    mm_positions=torch.arange(mm.shape[0], device=device)[None])
            h_0, _ = llama.forward(params, cfg_model, tok, want_hidden=True)
        lm = params["lm_head"]
        l_mm = (h_mm[0, -1].to(lm.dtype) @ lm).float()
        l_0 = (h_0[0, -1].to(lm.dtype) @ lm).float()
        logit_diff = (l_mm - l_0).abs().max().item()
        del h_mm, h_0
    finally:
        for s in srv.values():
            await s.stop()
    if sync:
        torch.cuda.empty_cache()

    a, b = (srv[n].ec_store[rid]["embeds"] for n in ("enc_a", "enc_b"))
    per = a.shape[0] // 2
    # The /ec wire's JSON cost on this host, alone: encoder A's two images.
    t0 = time.perf_counter()
    payload = json.dumps({"embeddings": a.tolist()}).encode()
    t1 = time.perf_counter()
    json.loads(payload)
    json_ms = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3, len(payload))
    if not np.array_equal(mm, np.concatenate([a[:per], b, a[per:]])):
        fail("epd: the decode server's embeddings are not A0, B1, A2 in that order")
    if tower_k1:
        fail(f"epd: the tower launched K1 {tower_k1} times")
    got, want = dec_tokens[rid], mono_tokens[rid]
    at = first_divergence(got, want)
    log(f"[epd] E/P/D {len(got)} tokens, E/D {len(want)}; "
        f"{'equal' if at is None else f'first divergence at position {at}'}")
    if at is not None or len(want) != EPD_TOKENS:
        fail(f"epd: E/P/D tokens differ from the E/D engine's at {at}")
    if r2["headers"].get("x-kv-pull-route") != "host":
        fail(f"epd: the decode leg pulled no KV ({r2['headers']})")
    need = cfg_model.n_layers * epd_steps
    if epd_steps <= 0 or epd_launches < need:
        fail(f"epd: the decode leg did not go through K1 ({epd_launches} < {need})")
    if not logit_diff > 0:
        fail("epd: the spliced embeddings left the first-token logits unchanged")
    if (cold["json"]["choices"][0]["finish_reason"] != "cache_threshold"
            or free1 != free0):
        fail(f"epd: cold probe {cold['json']['choices'][0]} moved blocks {free0} -> {free1}")
    if warm["json"]["choices"][0]["finish_reason"] != "length":
        fail(f"epd: warm probe answered {warm['json']['choices'][0]}")

    # Time to ready. Phase 2 built the kernels, so the warm-up is its trial
    # runs (one prefill, decode chunks at 1, 2, 4, 8 lanes).
    ready = {}
    for warmup in (False, True, True, False):
        cfg = EngineConfig(**kw, role="decode", warmup=warmup)
        ready.setdefault(warmup, []).append(round(await time_to_ready(cfg, params), 3))
    if sync:
        torch.cuda.empty_cache()

    log(f"[epd] {model}, {card}: encode ms per request (host clock; A: items 0, 2; "
        f"B: item 1) {enc_ms}; /ec pulls by the decode leg (source, bytes, ms) "
        f"{[(src, n, round(ms, 3)) for src, n, ms in epd_pulls]}; its resolve "
        f"(pulls + JSON parse + reorder) {resolved['ms']:.3f} ms; JSON of A's "
        f"rows alone, {json_ms[2]} bytes: tolist + dumps {json_ms[0]:.3f} ms, "
        f"loads {json_ms[1]:.3f} ms; the tower inside the encode requests "
        f"(synchronised; the first call draws it) {[round(c, 3) for _, c in tower_ms]} ms")
    log(f"[epd] {model}, {card}: multimodal prefill ms (synchronised) {mm_prefill}, "
        f"{mm.shape[0]} spliced rows + {len(ids) - mm.shape[0]} text tokens; first-token "
        f"logits max |with - without embeddings| {logit_diff:.4f}")
    log(f"[epd] {model}, {card}: TTFT (request start to the first token) E/P/D "
        f"{epd_ttft:.1f} ms, E/D {ed_ttft:.1f} ms, text-only P/D {text_ttft:.1f} ms; "
        f"K1 launches on the E/P/D decode leg {epd_launches} (n_layers x "
        f"{epd_steps} steps = {need}), by the tower {tower_k1}")
    log(f"[epd] {model}, {card}: start to /health ok, s: without warm-up "
        f"{ready[False]}, with --warmup {ready[True]}; probe 0.5 cold -> "
        f"cache_threshold (free blocks {free0} -> {free1}), warm -> "
        f"{warm['json']['choices'][0]['finish_reason']}")
    return epd_launches


# ---- phase 6: grouped-expert FFN (K2) -----------------------------------


def make_moe_layer(gen, cfg, dtype, *, hot=None, empty=None) -> dict:
    """One MoE layer at the config's width, scaled as init_params draws it;
    ``hot`` biases every token onto one expert, ``empty`` keeps an expert
    unchosen."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def w(*shape, fan_in):
        t = torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)
        return t.mul_(fan_in ** -0.5)

    lp = {"router": w(D, E, fan_in=D), "w1": w(E, D, F, fan_in=D),
          "w3": w(E, D, F, fan_in=D), "w2": w(E, F, D, fan_in=F)}
    # Inputs of these cases carry SKEW_FEATURE in feature 0 (moe_tokens), so
    # the bias moves every token's logit the same way.
    if hot is not None:
        lp["router"][0, hot] += 1.0
    if empty is not None:
        lp["router"][0, empty] -= 1.0
    return lp


SKEW_FEATURE = 64.0


def moe_tokens(gen, T, D, dtype, skew=False):
    x = torch.randn(T, D, generator=gen, device="cuda")
    if skew:
        x[:, 0] = SKEW_FEATURE
    return x.to(dtype)


def routed_args(lp, x, E, k) -> tuple[tuple, torch.Tensor]:
    """The kernel's arguments for tokens x as the routing glue lays them
    out, (x_pad, tile_expert, w1, w3, w2, tm, rows_used), and the routed
    rows per expert."""
    from llm_d_inference_scheduler_tpu_torch.ops import moe

    g = moe.group_rows(lp, x, E, k)
    return (g.x_pad, g.tile_expert, lp["w1"], lp["w3"], lp["w2"], g.tm,
            g.rows_used), g.counts


def check_moe(name: str, args: tuple) -> float:
    """K2 against its plain version on ``args``; fails on a mismatch beyond
    the dtype's tolerance or on a padding row that is not zero; returns the
    max abs error."""
    from llm_d_inference_scheduler_tpu_torch.ops import grouped_moe, moe

    dtype = args[0].dtype
    out = grouped_moe.grouped_ffn_cuda(*args)
    torch.cuda.synchronize()
    ref = moe.grouped_ffn_reference(*args[:6]).float()
    err = (out.float() - ref).abs()
    routed = ref[ref.abs().amax(-1) > 0]
    rms = float(routed.pow(2).mean().sqrt())
    if dtype == torch.float32:
        limit = MOE_F32_TOL * rms
        ok = float(err.max()) <= limit
        rule = f"{MOE_F32_TOL} x rms(plain) = {limit:.2e}"
    else:
        ok = bool((err <= MOE_BF16_TOL * ref.abs() + MOE_BF16_TOL * rms).all())
        rule = f"{MOE_BF16_TOL} x |plain| + {MOE_BF16_TOL} x rms(plain)"
    used = int(args[6][0])
    ok = ok and bool(torch.isfinite(out.float()).all()) and bool((out[used:] == 0).all())
    max_err = float(err.max())
    log(f"[moe] grouped_moe_ffn {name} {str(dtype)[6:]} tm={args[5]} rows "
        f"{used}/{args[0].shape[0]}: max_abs_err={max_err:.3e} rms(plain) over "
        f"{routed.shape[0]} routed rows={rms:.3e} "
        f"(tolerance {rule}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"grouped_moe_ffn disagrees with its plain version on {name} {dtype}")
    return max_err


def moe_bound_ms(args, counts, k: int) -> tuple[float, str]:
    """Least time for this call's work: the weights of every expert that
    holds a row (3 * D * F each) plus the routed rows in and out over HBM
    bandwidth, against 6 * D * F flops per routed row (padding excluded)
    over the peak rate of the input type."""
    x_pad, _, w1 = args[:3]
    D, F = w1.shape[1], w1.shape[2]
    isz = x_pad.element_size()
    rows = int(counts.sum())
    hit = int((counts > 0).sum())
    nbytes = hit * 3 * D * F * isz + 2 * rows * D * isz
    flops = 6 * D * F * rows
    peak = BF16_FLOPS if x_pad.dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cublas_yardstick(lp, x, k: int):
    """Per-expert torch.matmul SwiGLU over each expert's routed rows, the
    routing split made before timing. A yardstick only: no single PyTorch
    call computes this function, and the port never calls this."""
    import torch.nn.functional as F

    from llm_d_inference_scheduler_tpu_torch.ops import moe

    _, idx = moe.top_k_gates((x @ lp["router"]).float(), k)
    groups = []
    for e in range(lp["w1"].shape[0]):
        tok = (idx == e).any(-1).nonzero().squeeze(1)
        if tok.numel():
            groups.append((e, x[tok].contiguous()))
    return lambda: [(F.silu(xe @ lp["w1"][e]) * (xe @ lp["w3"][e])) @ lp["w2"][e]
                    for e, xe in groups]


def phase_moe_kernels(cfg) -> tuple[dict, dict]:
    """K2 against its plain version on every case; returns its kernels-line
    entry timed at the serve bucket (T=4, prefill_* at T=1100) and the
    same entry timed at a pp=2 interleave group (T=2)."""
    from llm_d_inference_scheduler_tpu_torch.ops import grouped_moe, moe
    from llm_d_inference_scheduler_tpu_torch.tools.timing import device_ms, kernel_times

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4321)
    E, k = cfg.n_experts, cfg.experts_per_token
    D = cfg.d_model
    lp16 = make_moe_layer(gen, cfg, torch.bfloat16)
    lp32 = {n: t.float() for n, t in lp16.items()}
    worst = 0.0
    timed = {}
    # Decode sizes (one token per lane), the prefill of a ~1100-token
    # prompt; then T=2, a pp=2 interleave group of the serve bucket (drawn
    # last, so the others' inputs are the ones earlier runs timed).
    for T in (1, 4, 8, 1100, 2):
        x16 = moe_tokens(gen, T, D, torch.bfloat16)
        for lp, x in ((lp16, x16), (lp32, x16.float())):
            args, counts = routed_args(lp, x, E, k)
            err = check_moe(f"T={T} k={k} experts hit {int((counts > 0).sum())}/{E}",
                            args)
            if x.dtype == torch.bfloat16:
                worst = max(worst, err)
                if T in (2, 4, 1100):
                    timed[T] = (lp, x, args, counts)
    del lp32
    # Skewed routing (every token on one expert, k=1) and an empty expert.
    hot, empty = E - 3, 3
    for label, kw, kk in ((f"skewed: all on expert {hot}, k=1", {"hot": hot}, 1),
                          (f"expert {empty} empty", {"empty": empty}, k)):
        for dtype in (torch.bfloat16, torch.float32):
            lp = make_moe_layer(gen, cfg, dtype, **kw)
            x = moe_tokens(gen, 64, D, dtype, skew=True)
            args, counts = routed_args(lp, x, E, kk)
            if "hot" in kw and int(counts[hot]) != 64:
                fail(f"skewed case routed {counts.tolist()}, not all on expert {hot}")
            if "empty" in kw and int(counts[empty]) != 0:
                fail(f"empty-expert case routed {counts.tolist()} onto expert {empty}")
            err = check_moe(f"T=64 {label} (rows per expert {counts.tolist()})", args)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            del lp

    # The glue makes no host sync (the decode chunk reads back once).
    x = moe_tokens(gen, 8, D, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe.moe_ffn_grouped(lp16, x, E, k)
    except RuntimeError as exc:
        fail(f"moe_ffn_grouped synchronised with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[moe] moe_ffn_grouped (routing glue + K2) at T=8 ran under "
        "set_sync_debug_mode('error'): no host sync")

    # Times at the serve phase's decode bucket (T=4), at a pp=2 interleave
    # group of it (T=2) and at prefill size.
    res = {}
    for T, (lp, x, args, counts) in timed.items():
        kernel = lambda: grouped_moe.grouped_ffn_cuda(*args)
        plain = lambda: moe.grouped_ffn_reference(*args[:6])
        k1, k1_wall, prof_ok = device_ms(kernel)
        p1, p1_wall, _ = device_ms(plain, iters=5)
        k2, k2_wall, _ = device_ms(kernel)
        p2, p2_wall, _ = device_ms(plain, iters=5)
        lib, lib_wall, _ = device_ms(cublas_yardstick(lp, x, k))
        bound_ms, bound_by = moe_bound_ms(args, counts, k)
        src = "device time (profiler)" if prof_ok else "CUDA events (profiler saw no device time)"
        log(f"[moe] grouped_moe_ffn timing T={T} k={k} bf16 (rows per expert "
            f"{counts.tolist()}, tm={args[5]}), {src}: kernel {k1:.4f}/{k2:.4f} ms, "
            f"plain {p1:.4f}/{p2:.4f} ms (order kernel, plain, kernel, plain), "
            f"cuBLAS yardstick (per-expert torch.matmul SwiGLU, routing split "
            f"before timing; no single PyTorch call computes this) {lib:.4f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by}; wall per call by CUDA events: "
            f"kernel {k1_wall:.4f}/{k2_wall:.4f} ms, plain {p1_wall:.4f}/{p2_wall:.4f} "
            f"ms, yardstick {lib_wall:.4f} ms")
        flops = 6 * D * lp["w1"].shape[2] * int(counts.sum())
        log(f"[moe]   {flops / min(k1, k2) / 1e9:.1f} TFLOP/s over the routed rows "
            f"(padding excluded); per kernel:")
        for kname, ms in kernel_times(kernel).items():
            log(f"[moe]   {ms * 1e3:9.2f} us  {kname[:100]}")
        res[T] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bound_ms,
                  "bound_by": bound_by, "yardstick_ms": lib}
    # ms, plain_ms and bound_ms are the serve decode bucket's (T=4); the
    # prefill_* keys hold T=1100, the prefill of a ~1100-token prompt.
    row = {"name": "grouped_moe_ffn", "route": "cuda",
           "source": "llm_d_inference_scheduler_tpu_torch/csrc/grouped_moe_ffn.cu",
           "replaces": "llm_d_inference_scheduler_tpu/ops/pallas_moe.py:76",
           "launches": None, "max_abs_err": worst,
           "ms": res[4]["ms"], "plain_ms": res[4]["plain_ms"],
           "bound_ms": res[4]["bound_ms"], "bound_by": res[4]["bound_by"],
           "library_ms": None, "yardstick_ms": res[4]["yardstick_ms"],
           "prefill_ms": res[1100]["ms"], "prefill_plain_ms": res[1100]["plain_ms"],
           "prefill_bound_ms": res[1100]["bound_ms"],
           "prefill_bound_by": res[1100]["bound_by"],
           "prefill_yardstick_ms": res[1100]["yardstick_ms"]}

    row["max_abs_err"] = worst
    del timed, lp16
    # The Mixtral pp=2 path launches K2 mostly at its interleave's groups.
    pp_row = {**row, **{key: res[2][key] for key in ("ms", "plain_ms", "bound_ms",
                                                     "bound_by", "yardstick_ms")}}
    return row, pp_row


# ---- phase 6b: prefill attention (K3) --------------------------------------

# The longprompt cells' windows: 1024 new rows over 0-2976 prior columns, at
# Mixtral's heads (32/8), one tp=2 rank's (16/4) and Qwen3-32B's (64/8), D 128.
K3_PRIORS = (0, 1024, 2048, 2976)
K3_HEADS = [(32, 8), (16, 4), (64, 8)]
# K3 against the plain version in f32 on the same bf16 inputs: the output
# rounds once to bf16 (2**-8 of the value) and P rounds to bf16 before the
# P.V product (at most 2**-9 * max|v|); 1e-5 for the order of sums. f32:
# the order of sums only.
K3_F32_TOL = 1e-5


def prefill_case(gen, B, S, P, H, Hkv, D, dtype):
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda").to(dtype)
    lens = lambda n: torch.full((B,), n, dtype=torch.int32, device="cuda")
    return dict(q=r(B, S, H, D), k=r(B, S, Hkv, D), v=r(B, S, Hkv, D),
                k_prior=r(B, P, Hkv, D) if P else None, v_prior=r(B, P, Hkv, D) if P else None,
                prior_len=lens(P) if P else None, new_len=lens(S))


def check_prefill(name: str, case: dict) -> float:
    """K3 against its plain version (f32, same inputs); fails beyond the
    tolerance, else returns the max abs error."""
    from llm_d_inference_scheduler_tpu_torch.ops import prefill_attention as k3

    out = k3.prefill_attention(**case)
    torch.cuda.synchronize()
    f = {n: (t.float() if t is not None and t.is_floating_point() else t)
         for n, t in case.items()}
    ref = k3.prefill_attention_reference(f["q"], f["k"], f["v"], f["k_prior"], f["v_prior"],
                                         f["prior_len"], f["new_len"])
    err = (out.float() - ref).abs()
    if out.dtype == torch.float32:
        atol, rtol = K3_F32_TOL, K3_F32_TOL
    else:
        vmax = max(float(case[n].abs().max()) for n in ("v", "v_prior") if case[n] is not None)
        atol, rtol = 2.0 ** -9 * vmax + 1e-5, 2.0 ** -8
    ok = bool(torch.isfinite(out.float()).all()) and bool((err <= atol + rtol * ref.abs()).all())
    max_err = float(err.max())
    log(f"[prefill-attn] prefill_attention {name} {str(out.dtype)[6:]}: max_abs_err="
        f"{max_err:.3e} (atol={atol:.2e}, rtol={rtol:.2e}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"prefill_attention disagrees with its plain version on {name} {out.dtype}")
    return max_err


def prefill_bound_ms(case) -> tuple[float, str, float]:
    """Least time for the call's work: 4 * D flops per visible (row,
    column) pair and q head (QK and PV), over the bf16 peak, against Q, K,
    V, the prior K/V and O over HBM bandwidth; and the flops."""
    q, kp = case["q"], case["k_prior"]
    B, S, H, D = q.shape
    Hkv = case["k"].shape[2]
    P = 0 if kp is None else kp.shape[1]
    isz = q.element_size()
    pairs = B * (S * P + S * (S + 1) // 2)
    flops = 4 * D * H * pairs
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D + 2 * B * P * Hkv * D) * isz
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", flops


def sdpa_prefill_yardstick(case):
    """scaled_dot_product_attention on the same masked inputs, K/V heads
    repeated and the two column parts joined before timing (the copies
    excluded): causal (P = 0) or causal from the bottom right. A yardstick
    only; the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    q, k, v = case["q"], case["k"], case["v"]
    H, Hkv = q.shape[2], k.shape[2]
    if case["k_prior"] is not None:
        k = torch.cat([case["k_prior"], k], 1)
        v = torch.cat([case["v_prior"], v], 1)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    S, T = qt.shape[2], kt.shape[2]
    if S == T:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    bias = causal_lower_right(S, T)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)


def phase_prefill_kernels() -> dict:
    """K3 against its plain version on the cell's shapes and the ragged
    edges, bf16 and f32; timed at each of the cell's windows (K3_PRIORS)
    at each of K3_HEADS; returns its kernels-line entry (ms, bound_ms,
    plain_ms, library_ms at the cell's last window, P = 2976, 32/8) with
    every timed shape under ``timed``."""
    from llm_d_inference_scheduler_tpu_torch.ops import prefill_attention as k3
    from llm_d_inference_scheduler_tpu_torch.tools.timing import device_ms, kernel_times

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5678)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for H, Hkv in K3_HEADS:
            for P in K3_PRIORS:
                err = check_prefill(f"H={H} Hkv={Hkv} S=1024 P={P}",
                                    prefill_case(gen, 1, 1024, P, H, Hkv, 128, dtype))
                worst = max(worst, err) if dtype == torch.bfloat16 else worst
        # Ragged: a last window shorter than a tile, a prior part cut
        # mid-tile, batched rows of other lengths.
        c = prefill_case(gen, 3, 977, 1024, 32, 8, 128, dtype)
        c["prior_len"] = torch.tensor([1024, 700, 0], dtype=torch.int32, device="cuda")
        c["new_len"] = torch.tensor([977, 500, 1], dtype=torch.int32, device="cuda")
        check_prefill("ragged B=3 S=977 P=1024", c)
    timed = {}
    for H, Hkv in K3_HEADS:
        for P in K3_PRIORS:
            case = prefill_case(gen, 1, 1024, P, H, Hkv, 128, torch.bfloat16)
            kernel = lambda: k3.prefill_attention(**case)
            plain = lambda: k3.prefill_attention_reference(*case.values())
            a1, a1_wall, prof_ok = device_ms(kernel)
            p1, _, _ = device_ms(plain, iters=5)
            a2, a2_wall, _ = device_ms(kernel)
            p2, _, _ = device_ms(plain, iters=5)
            lib, _, _ = device_ms(sdpa_prefill_yardstick(case))
            bound_ms, bound_by, flops = prefill_bound_ms(case)
            ms = min(a1, a2)
            src = "device time (profiler)" if prof_ok else "CUDA events (profiler saw no device time)"
            log(f"[prefill-attn] timing H={H} Hkv={Hkv} S=1024 P={P} bf16, {src}: kernel "
                f"{a1:.4f}/{a2:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s on the visible "
                f"columns, {100 * bound_ms / ms:.1f} % of the bound), plain {p1:.4f}/{p2:.4f} "
                f"ms (order kernel, plain, kernel, plain), sdpa yardstick {lib:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by}; wall per call by CUDA events, host launch "
                f"included: kernel {a1_wall:.4f}/{a2_wall:.4f} ms")
            if (H, P) == (32, 2976):
                for kname, kms in kernel_times(kernel).items():
                    log(f"[prefill-attn]   {kms * 1e3:9.2f} us  {kname[:100]}")
            timed[f"{H}/{Hkv} P={P}"] = {"ms": ms, "plain_ms": min(p1, p2),
                                         "bound_ms": bound_ms, "bound_by": bound_by,
                                         "library_ms": lib}
    last = timed["32/8 P=2976"]
    return {"name": "prefill_attention", "route": "cuda",
            "source": "llm_d_inference_scheduler_tpu_torch/csrc/prefill_attention.cu",
            "replaces": None, "launches": None, "max_abs_err": worst, **last,
            "timed": timed}


# ---- phase 6c: K4, the served layer's RMSNorm, QK-norm and RoPE ----------

# (name, tokens, width, Hq, Hk, head_dim, QK-norm): the longprompt cells'
# 1024-token windows and a decode batch of 4, θ 1e6 (both models').
K4_SHAPES = [
    ("qwen3-32b window", 1024, 5120, 64, 8, 128, True),
    ("mixtral window", 1024, 4096, 32, 8, 128, False),
    ("qwen3-32b decode B=4", 4, 5120, 64, 8, 128, True),
    ("mixtral decode B=4", 4, 4096, 32, 8, 128, False),
]
K4_THETA = 1e6
K4_EPS = 1e-6


def norm_bytes(T: int, width: int, Hq: int, Hk: int, D: int, qk_norm: bool,
               isz: int) -> dict[str, int]:
    """Bytes each K4 entry must move at a shape (each input read once, each
    output written once): rms_norm the rows in and out and the weight; its
    residual form two rows in and two out; qk_norm_rope q and k in and out,
    the tokens' cos/sin (f32) and, with QK-norm, the two norm weights."""
    return {"rms_norm": (2 * T * width + width) * isz,
            "rms_norm+residual": (4 * T * width + width) * isz,
            "qk_norm_rope": (2 * T * (Hq + Hk) * D * isz + 2 * T * (D // 2) * 4
                             + (2 * D * isz if qk_norm else 0))}


def norm_case(gen, T: int, width: int, Hq: int, Hk: int, D: int, qk_norm: bool, dtype) -> dict:
    from llm_d_inference_scheduler_tpu_torch.ops.rope import rope_table

    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda").to(dtype)
    w = lambda n: (1 + 0.1 * torch.randn(n, generator=gen, device="cuda")).to(dtype)
    pos = torch.randint(0, 4096, (T,), generator=gen, device="cuda")
    cos, sin = rope_table(pos, D, K4_THETA)
    return dict(x=3 * r(T, width), res=r(T, width), w=w(width), q=r(T, Hq, D), k=r(T, Hk, D),
                cos=cos, sin=sin, qn=w(D) if qk_norm else None, kn=w(D) if qk_norm else None)


def check_norms(name: str, c: dict) -> float:
    """K4's three forms against the eager chain on the same inputs, within
    the tolerances of tests/test_torch_kernels_cuda.py (RoPE alone and the
    residual sum bit-equal; a norm within one bf16 step, or rtol 1e-5 in
    f32; QK-norm then RoPE within 2**-6 of the largest output); fails
    beyond them, else returns the largest abs difference."""
    from llm_d_inference_scheduler_tpu_torch.ops import fused_norm as k4

    got = {"rms_norm": k4.rms_norm(c["x"], c["w"], K4_EPS),
           "rms_norm+residual": k4.rms_norm(c["x"], c["w"], K4_EPS, residual=c["res"]),
           "qk_norm_rope": k4.qk_norm_rope(c["q"], c["k"], c["cos"], c["sin"], c["qn"], c["kn"],
                                           K4_EPS)}
    torch.cuda.synchronize()
    want = {"rms_norm": k4.rms_norm_reference(c["x"], c["w"], K4_EPS),
            "rms_norm+residual": k4.rms_norm_reference(c["x"], c["w"], K4_EPS,
                                                       residual=c["res"]),
            "qk_norm_rope": k4.qk_norm_rope_reference(c["q"], c["k"], c["cos"], c["sin"],
                                                      c["qn"], c["kn"], K4_EPS)}
    f32 = c["x"].dtype == torch.float32
    worst = 0.0
    for form in got:
        pairs = list(zip(got[form], want[form])) if form != "rms_norm" else [
            (got[form], want[form])]
        for i, (g, w_) in enumerate(pairs):
            err = float((g.float() - w_.float()).abs().max())
            exact = (form == "rms_norm+residual" and i == 0) or (
                form == "qk_norm_rope" and c["qn"] is None)
            if exact:
                ok = torch.equal(g, w_)
            elif form == "qk_norm_rope":
                top = float(w_.abs().max())
                atol, rtol = (1e-5 * top, 1e-5) if f32 else (2.0 ** -6 * top, 2.0 ** -7)
                ok = bool(((g.float() - w_.float()).abs() <= atol + rtol * w_.float().abs()).all())
            else:
                atol, rtol = (1e-6, 1e-5) if f32 else (1e-6, 2.0 ** -7)
                ok = bool(((g.float() - w_.float()).abs() <= atol + rtol * w_.float().abs()).all())
            worst = max(worst, err)
            log(f"[norms] {form} {name} {str(g.dtype)[6:]} out {i}: max_abs_err={err:.3e} "
                f"{'(bit-equal required) ' if exact else ''}{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"fused_norm_rope {form} disagrees with the eager chain on {name} "
                     f"{g.dtype}")
    return worst


def phase_norm_kernels() -> dict:
    """K4 against the eager chain at K4_SHAPES, bf16 and f32; each entry
    timed in bf16 (kernel, eager, kernel, eager) beside its bytes bound and,
    for rms_norm, F.rms_norm (a yardstick the port never calls). Returns
    K4's kernels-line entry (qk_norm_rope at Qwen3-32B's window) with every
    timed shape and form under ``timed``."""
    import torch.nn.functional as F

    from llm_d_inference_scheduler_tpu_torch.ops import fused_norm as k4
    from llm_d_inference_scheduler_tpu_torch.tools.timing import device_ms

    gen = torch.Generator(device="cuda").manual_seed(4321)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, *shape in K4_SHAPES:
            err = check_norms(name, norm_case(gen, *shape, dtype=dtype))
            worst = max(worst, err) if dtype == torch.bfloat16 else worst
    timed = {}
    for name, T, width, Hq, Hk, D, qk_norm in K4_SHAPES:
        nbytes = norm_bytes(T, width, Hq, Hk, D, qk_norm, 2)
        # Each call takes the next of enough cases to hold three times the
        # 50 MB L2, so every call reads its inputs from HBM (12 at the
        # decode shapes, where launch latency rules anyway).
        cases = [norm_case(gen, T, width, Hq, Hk, D, qk_norm, torch.bfloat16)
                 for _ in range(min(12, max(2, -(-150_000_000 // nbytes["rms_norm"]))))]
        turn = iter(range(1 << 62))
        nxt = lambda: cases[next(turn) % len(cases)]
        forms = {
            "rms_norm": (lambda c: k4.rms_norm(c["x"], c["w"], K4_EPS),
                         lambda c: k4.rms_norm_reference(c["x"], c["w"], K4_EPS),
                         lambda c: F.rms_norm(c["x"], (width,), c["w"], K4_EPS)),
            "rms_norm+residual": (
                lambda c: k4.rms_norm(c["x"], c["w"], K4_EPS, residual=c["res"]),
                lambda c: k4.rms_norm_reference(c["x"], c["w"], K4_EPS, residual=c["res"]),
                None),
            "qk_norm_rope": (
                lambda c: k4.qk_norm_rope(c["q"], c["k"], c["cos"], c["sin"], c["qn"], c["kn"],
                                          K4_EPS),
                lambda c: k4.qk_norm_rope_reference(c["q"], c["k"], c["cos"], c["sin"],
                                                    c["qn"], c["kn"], K4_EPS),
                None),
        }
        for form, fns in forms.items():
            kernel, plain, library = (None if f is None else (lambda f=f: f(nxt()))
                                      for f in fns)
            a1, a1_wall, prof_ok = device_ms(kernel)
            p1, _, _ = device_ms(plain)
            a2, a2_wall, _ = device_ms(kernel)
            p2, _, _ = device_ms(plain)
            lib = device_ms(library)[0] if library is not None else None
            ms = min(a1, a2)
            bound_ms = nbytes[form] / HBM_BYTES_PER_S * 1e3
            src = "device time (profiler)" if prof_ok else "CUDA events (profiler saw no device time)"
            log(f"[norms] timing {form} {name} bf16, {src}: kernel {a1:.4f}/{a2:.4f} ms "
                f"({nbytes[form] / ms / 1e6:.0f} GB/s, {100 * bound_ms / ms:.1f} % of the "
                f"bound), eager {p1:.4f}/{p2:.4f} ms (order kernel, eager, kernel, eager), "
                f"bound {bound_ms:.4f} ms by bytes ({nbytes[form] / 1e6:.2f} MB)"
                + (f", F.rms_norm yardstick {lib:.4f} ms" if lib is not None else "")
                + f"; wall per call by CUDA events, host launch included: kernel "
                f"{a1_wall:.4f}/{a2_wall:.4f} ms")
            timed[f"{form} {name}"] = {"ms": ms, "plain_ms": min(p1, p2), "bound_ms": bound_ms,
                                       "bound_by": "bytes", "library_ms": lib}
    return {"name": "fused_norm_rope", "route": "cuda",
            "source": "llm_d_inference_scheduler_tpu_torch/csrc/fused_norm_rope.cu",
            "replaces": None, "launches": None, "max_abs_err": worst,
            **timed["qk_norm_rope qwen3-32b window"], "timed": timed}


async def check_prefill_windows(params, model_dir: str, n_layers: int, card: str, *,
                                served: str = MOE_SERVED, grouped: bool = True,
                                n_tokens: int = 4000, vocab: int = 32_000) -> dict:
    """8b: one prompt of the longprompt cell's longest length (4000 tokens)
    through an engine with the cell's prefill settings (1024-token windows,
    the grouped FFN), every window through ``llama.prefill``, the first
    with no prior part, three over one; K3
    must launch once per layer and window, all on wgmma, and nothing else
    of the prefill may attend; K4 3 x n_layers + 1 times a window (each
    layer's attention norm, QK-norm and RoPE, residual add and MLP norm;
    the final norm). 8c calls it on Qwen3-32B (``served``, dense FFN).
    Returns K3's and K4's launches and the windows' engine-side
    milliseconds."""
    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest
    from llm_d_inference_scheduler_tpu_torch.ops import fused_norm

    window = 1024
    cfg = EngineConfig(model=model_dir, served_model_name=served, device="cuda",
                       max_batch=4, max_model_len=4096, prefill_chunk=window,
                       decode_chunk=8, grouped_moe=grouped, kv_events_port=0)
    engine = TorchEngine(cfg, params=params)
    windows: list[float] = []
    timed(engine, "_run_prefill", windows, sync=True)
    await engine.start()
    try:
        ops.reset_kernel_launches()
        ids = torch.randint(1, vocab, (n_tokens,), generator=torch.Generator().manual_seed(8))
        out = engine.submit(EngineRequest(request_id="windows", prompt_token_ids=ids.tolist(),
                                          max_tokens=1, temperature=0.0, ignore_eos=True))
        while (await asyncio.wait_for(out.get(), timeout=300)).finish_reason is None:
            pass
        launches = ops.kernel_launches()
    finally:
        await engine.stop()
    n_windows = -(-n_tokens // window)
    want = n_layers * n_windows
    k4_want = (3 * n_layers + 1) * n_windows
    ms = [round(c, 2) for _, c in windows]
    log(f"[prefill-windows] {served}, {card}: a {n_tokens}-token prompt in "
        f"{n_windows} windows of {window} ({ms} ms each, engine side, synchronised); "
        f"launches {launches}")
    if (launches["prefill_attention"] != want or launches["prefill_attention.wgmma"] != want
            or len(ms) != n_windows):
        fail(f"prefill windows: K3 launched {launches}, want {want} = {n_layers} layers x "
             f"{n_windows} windows, all on wgmma")
    K4 = fused_norm.KERNEL
    if (launches[K4] != k4_want or launches[f"{K4}.qk_norm_rope"] != want
            or launches[f"{K4}.rms_norm"] != (2 * n_layers + 1) * n_windows):
        fail(f"prefill windows: K4 launched {launches}, want {k4_want} = (3 x {n_layers} + 1) "
             f"x {n_windows} windows")
    return {"launches": launches["prefill_attention"], "k4_launches": launches[K4],
            "window_ms": ms}


def phase_qwen3_windows(card: str) -> dict:
    """8c: Qwen3-32B whole (64 layers, dense FFN, random bf16 weights, 65.5
    GB) through 8b's check with a 2048-token prompt (two windows): K3 64
    and K4 193 launches a window."""
    from llm_d_inference_scheduler_tpu_torch.models import llama
    from llm_d_inference_scheduler_tpu_torch.models.configs import get_config

    cfg = get_config(QWEN3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.monotonic()
    params = llama.init_params(cfg, "cuda", "bfloat16", gen)
    torch.cuda.synchronize()
    log(f"[prefill-windows] random {QWEN3} weights drawn on the card in "
        f"{time.monotonic() - t0:.1f}s")
    try:
        return asyncio.run(check_prefill_windows(params, QWEN3, cfg.n_layers, card,
                                                 served=QWEN3, grouped=False,
                                                 n_tokens=2048, vocab=cfg.vocab_size))
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()


# ---- phase 7: Mixtral decode step, grouped against dense ------------------


def recorded(fn):
    """fn() with every MoE layer's routing and FFN input recorded: returns
    (fn's result, [(router logits [T, E] f32, top-k expert ids [T, k]
    sorted) per layer], [FFN input h per layer]), in call order."""
    from llm_d_inference_scheduler_tpu_torch.models import llama
    from llm_d_inference_scheduler_tpu_torch.ops import moe

    routes, inputs = [], []
    top_k, ffn = moe.top_k_gates, llama._ffn

    def rec_top_k(logits, k):
        gates, idx = top_k(logits, k)
        routes.append((logits.clone(), idx.sort(-1).values))
        return gates, idx

    def rec_ffn(cfg, lp, h, *rank):
        inputs.append(h.clone())
        return ffn(cfg, lp, h, *rank)

    llama.top_k_gates = moe.top_k_gates = rec_top_k
    llama._ffn = rec_ffn
    try:
        out = fn()
    finally:
        llama.top_k_gates = moe.top_k_gates = top_k
        llama._ffn = ffn
    return out, routes, inputs


def phase_moe_decode(cfg, params) -> None:
    from llm_d_inference_scheduler_tpu_torch.models import llama

    grouped_cfg = dataclasses.replace(cfg, moe_impl="grouped")
    dense_cfg = dataclasses.replace(cfg, moe_impl="dense")
    B = len(SEQ_LENS)
    dtype = params["embed"].dtype
    tokens, positions, k_pages, v_pages, tables = decode_inputs(cfg, dtype)
    (kern, _, _), routes_g, _ = recorded(lambda: llama.decode_step(
        params, grouped_cfg, tokens, positions, k_pages, v_pages, tables))
    (plain, _, _), routes_d, inputs_d = recorded(lambda: llama.decode_step(
        params, dense_cfg, tokens, positions, k_pages, v_pages, tables))
    if kern.shape != (B, cfg.vocab_size) or not bool(torch.isfinite(kern).all()):
        fail(f"MoE decode_step logits malformed: {tuple(kern.shape)}")
    # A lane whose top-k expert set differs between the two paths at some
    # layer follows another model from there on. It is left out of the
    # logits gate only where, at the first layer it differs, the dense
    # step's router logits of its k-th and (k+1)-th experts lie within
    # MOE_ROUTE_TIE_STEPS bf16 steps (a near-tie that the paths' rounding can
    # tip); a lane that flips at a wider margin fails the phase. The
    # per-layer check below holds K2 on every layer, excused lanes included.
    k = cfg.experts_per_token
    excused, ties = [], []
    for b in range(B):
        layer = next((i for i, ((_, rg), (_, rd)) in enumerate(zip(routes_g, routes_d))
                      if bool((rg[b] != rd[b]).any())), None)
        if layer is None:
            continue
        logits_g, logits_d = routes_g[layer][0][b], routes_d[layer][0][b]
        top = logits_d.sort(descending=True).values
        margin = float(top[k - 1] - top[k])
        step = 2.0 ** (torch.frexp(top[k - 1:k + 1].abs().max()).exponent.item() - 8)
        moved = float((logits_g - logits_d).abs().max())
        alike = [i for i in range(B) if bool((routes_g[layer][1][i]
                                               == routes_d[layer][1][i]).all())]
        moved_alike = float((routes_g[layer][0][alike] - routes_d[layer][0][alike])
                            .abs().amax(-1).max()) if alike else float("nan")
        ties.append(f"lane {b} at layer {layer}: top-{k} margin {margin:.4e} = "
                    f"{margin / step:.1f} bf16 steps of {step:.4e}; router logits "
                    f"moved up to {moved:.4e} on this lane, {moved_alike:.4e} on "
                    f"the {len(alike)} lanes routed alike there")
        if margin > MOE_ROUTE_TIE_STEPS * step:
            fail(f"Mixtral decode_step: lane {b}'s routing differs between grouped "
                 f"(K2) and dense at layer {layer}, at no near-tie ({ties[-1]})")
        excused.append(b)
    rows = (kern - plain).abs().amax(-1)
    scale = float(plain.abs().max())
    held = [b for b in range(B) if b not in excused]
    diff = float(rows[held].max()) if held else float("inf")
    agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    ok = len(held) * 2 >= B and diff <= MOE_LOGITS_REL_TOL * scale
    log(f"[moe-decode] {cfg.name} ({cfg.n_layers} layers) decode_step {str(dtype)[6:]} "
        f"B={B} seq_lens={SEQ_LENS}, grouped (K2) vs dense: logits max_abs_diff="
        f"{diff:.4f} over {len(held)} lanes vs max|logit|={scale:.2f} (tolerance "
        f"{MOE_LOGITS_REL_TOL} x max|logit|, every lane but a near-tie flip, at least "
        f"half) {'ok' if ok else 'MISMATCH'}; per lane "
        f"{[round(float(r), 4) for r in rows]}; routing flips (tie limit "
        f"{MOE_ROUTE_TIE_STEPS} steps): {ties or 'none'}; argmax agreement {agree}/{B}")
    if not ok:
        fail("Mixtral decode_step: grouped (K2) and dense MoE disagree")

    # The logits gate is coarse; the bf16 K2 is held tightly on its own in
    # phase 6, and here at the model level on every layer's MoE FFN, both
    # paths fed the dense step's input of that layer.
    worst, worst_abs, rms_of = 0.0, 0.0, 0.0
    for layer, h in enumerate(inputs_d):
        lp = {n: t[layer] for n, t in params["layers"].items()}
        kern_l = llama._ffn(grouped_cfg, lp, h).float()
        plain_l = llama._ffn(dense_cfg, lp, h).float()
        rms = float(plain_l.pow(2).mean().sqrt())
        err = (kern_l - plain_l).abs()
        rel = float((err / (plain_l.abs() + rms)).max())
        if not bool(torch.isfinite(kern_l).all()):
            rel = float("inf")
        if rel >= worst:
            worst, worst_abs, rms_of = rel, float(err.max()), rms
    ok = worst <= MOE_FFN_BF16_TOL
    log(f"[moe-decode] {cfg.name} MoE FFN of each of {len(inputs_d)} layers bfloat16 "
        f"B={B}, grouped (K2) vs dense on the dense step's layer inputs: worst layer "
        f"max |diff| / (|dense| + rms(dense)) = {worst:.4e} (max_abs_diff="
        f"{worst_abs:.4e}, rms(dense)={rms_of:.4f}; tolerance {MOE_FFN_BF16_TOL}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("Mixtral MoE FFN in bf16: grouped (K2) and dense disagree on a layer")

    cut = 2
    p32 = first_layers_f32(params, cut)
    kp32, vp32 = k_pages[:cut].float(), v_pages[:cut].float()
    kern, _, _ = llama.decode_step(p32, dataclasses.replace(grouped_cfg, n_layers=cut),
                                   tokens, positions, kp32, vp32, tables)
    plain, _, _ = llama.decode_step(p32, dataclasses.replace(dense_cfg, n_layers=cut),
                                    tokens, positions, kp32, vp32, tables)
    diff = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    ok = bool(torch.isfinite(kern).all()) and diff <= LOGITS_F32_REL_TOL * scale
    log(f"[moe-decode] {cfg.name} first {cut} layers decode_step float32 B={B}, "
        f"grouped vs dense: logits max_abs_diff={diff:.3e} vs max|logit|={scale:.2f} "
        f"(tolerance {LOGITS_F32_REL_TOL} x max|logit|) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("two-layer f32 Mixtral decode_step: grouped (K2) and dense MoE disagree")
    del p32, kp32, vp32

    decode_breakdown("moe-decode", step=lambda: llama.decode_step(
        params, grouped_cfg, tokens, positions, k_pages, v_pages, tables), B=B,
        n_layers=cfg.n_layers)
    del k_pages, v_pages


# ---- phase 9: converted HF checkpoints -------------------------------------

# Published configs (the models' config.json on the HF hub), cut in depth
# only: every layer has the full model's shapes. The weights exist twice on
# disk (HF layout and converted), which bounds the depth: Llama-3-8B at 8 of
# 32 layers is ~5.6 GB a copy, Mixtral-8x7B at 2 of 32 layers ~6.3 GB.
HF_CONFIGS = {
    "llama3-8b": {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32,
        "num_key_value_heads": 8, "num_hidden_layers": 8, "vocab_size": 128256,
        "rope_theta": 500000.0, "rms_norm_eps": 1e-5, "max_position_embeddings": 8192,
        "bos_token_id": 128000, "eos_token_id": 128001, "hidden_act": "silu",
        "tie_word_embeddings": False, "torch_dtype": "bfloat16"},
    "mixtral-8x7b": {
        "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
        "hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32,
        "num_key_value_heads": 8, "num_hidden_layers": 2, "vocab_size": 32000,
        "rope_theta": 1e6, "rms_norm_eps": 1e-5, "max_position_embeddings": 32768,
        "num_local_experts": 8, "num_experts_per_tok": 2, "bos_token_id": 1,
        "eos_token_id": 2, "hidden_act": "silu", "tie_word_embeddings": False,
        "torch_dtype": "bfloat16"},
}
CKPT_PROMPTS = 8       # concurrent requests, one bucket (65-128 tokens)
CKPT_TOKENS = 32
CKPT_PREFILL_BATCH = 4
# A served token may leave the in-memory single-path engine's only at a
# near-tie: there, both tokens' logits (bf16 values) lie within this many
# bf16 steps of the top logit (random weights over a 128k vocab put many
# logits within a step or two of the top). The batched [N, S] prefill runs
# other cuBLAS algorithms than [1, S] (another summation order, rounded to
# bf16 at every layer), which moves logits by a few steps; a wrong row, a
# wrong position or padding leaking into a real row moves them by whole
# units (hundreds of steps). The same limit as MOE_ROUTE_TIE_STEPS.
TOKEN_TIE_STEPS = 8


def hf_state_dict(hf: dict, seed: int, device: str = "cuda") -> dict:
    """Seeded bf16 weights on the card under HF names, in HF's [out, in]
    layout: N(0, 1) * fan_in**-0.5 projections, norms near 1 (so that a
    swapped norm would show)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    D, F, V = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    H, Hkv = hf["num_attention_heads"], hf["num_key_value_heads"]
    Dh = D // H

    def w(out_f, in_f):
        t = torch.randn((out_f, in_f), generator=gen, device=device, dtype=torch.bfloat16)
        return t.mul_(in_f ** -0.5)

    def norm():
        return (1 + 0.1 * torch.randn((D,), generator=gen, device=device)).bfloat16()

    sd = {"model.embed_tokens.weight": w(V, D)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd |= {p + "self_attn.q_proj.weight": w(H * Dh, D),
               p + "self_attn.k_proj.weight": w(Hkv * Dh, D),
               p + "self_attn.v_proj.weight": w(Hkv * Dh, D),
               p + "self_attn.o_proj.weight": w(D, H * Dh),
               p + "input_layernorm.weight": norm(),
               p + "post_attention_layernorm.weight": norm()}
        if hf.get("num_local_experts"):
            moe = p + "block_sparse_moe."
            sd[moe + "gate.weight"] = w(hf["num_local_experts"], D)
            for e in range(hf["num_local_experts"]):
                sd |= {f"{moe}experts.{e}.w1.weight": w(F, D),
                       f"{moe}experts.{e}.w3.weight": w(F, D),
                       f"{moe}experts.{e}.w2.weight": w(D, F)}
        else:
            sd |= {p + "mlp.gate_proj.weight": w(F, D), p + "mlp.up_proj.weight": w(F, D),
                   p + "mlp.down_proj.weight": w(D, F)}
    sd |= {"model.norm.weight": norm(), "lm_head.weight": w(V, D)}
    return sd


def write_hf_checkpoint(sd: dict, hf: dict, path: str) -> int:
    """An HF checkpoint directory written with the port's safetensors
    writer: one shard per layer (and one for the rest), the shard index
    and config.json; returns the bytes of the shards."""
    from llm_d_inference_scheduler_tpu_torch.models import safetensors_io

    os.makedirs(path)
    groups: dict[str, list] = {}
    for name, t in sd.items():
        key = name.split(".")[2] if name.startswith("model.layers.") else "rest"
        groups.setdefault(key, []).append((name, t))
    n, weight_map, total = len(groups), {}, 0
    for j, items in enumerate(groups.values()):
        shard = f"model-{j + 1:05d}-of-{n:05d}.safetensors"
        total += safetensors_io.save_file(items, os.path.join(path, shard),
                                          metadata={"format": "pt"})
        weight_map |= {name: shard for name, _ in items}
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f, indent=2)
    return total


def check_disk(need: int) -> None:
    """Fail with the byte counts when the temp dir lacks ``need`` bytes."""
    import shutil

    root = tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    log(f"[ckpt] {free} bytes free at {root}; the two copies need {need}")
    if free < need:
        fail(f"ckpt: {need} bytes of disk needed for the HF and converted "
             f"checkpoints, {free} free at {root}")


def ckpt_prompts(vocab: int) -> list[list[int]]:
    """Token-id prompts of 90-120 tokens (one prefill bucket, 128), seeded."""
    gen = torch.Generator().manual_seed(9)
    return [torch.randint(3, min(vocab, 32000), (90 + 4 * i,), generator=gen).tolist()
            for i in range(CKPT_PROMPTS)]


def host_rss_gb() -> tuple[float | None, float]:
    """This process's resident host memory now (VmRSS; None where /proc
    does not give it) and its peak over the process's life, GB."""
    import resource

    now = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1]) / 1e6
    return now, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def run_measured(cmd: list[str], cwd: str) -> tuple[int, str, float]:
    """Run ``cmd``; its exit code, output and peak resident memory, GB."""
    with tempfile.TemporaryFile() as out:
        p = subprocess.Popen(cmd, cwd=cwd, stdout=out, stderr=subprocess.STDOUT)
        _, status, usage = os.wait4(p.pid, 0)
        p.returncode = os.waitstatus_to_exitcode(status)
        out.seek(0)
        return p.returncode, out.read().decode(errors="replace"), usage.ru_maxrss / 1e6


def excuse_flip(params, mcfg, prompt: list[int], want: list[int], got: list[int],
                at: int, tag: str = "ckpt", moe_route: bool = False) -> str:
    """Where the served tokens leave the reference's (position ``at``), both
    tokens' logits must lie within TOKEN_TIE_STEPS bf16 steps of the top
    logit of the reference's model there (a whole-sequence forward over the
    prompt and the reference's tokens so far); returns the report, or
    fails. With ``moe_route`` (an MoE model whose two runs batched their
    decode steps differently) a wider gap passes too where, at a decoded
    position before ``at``, some layer's router logits of the k-th and
    (k+1)-th experts lie within MOE_ROUTE_TIE_STEPS bf16 steps in that
    forward: phase 7's rule for a routing flip (another batch rounds the
    residual stream otherwise, which can tip such a tie; from there the runs
    follow other experts)."""
    from llm_d_inference_scheduler_tpu_torch.models import llama

    ids = torch.tensor([prompt + want[:at]], device=params["embed"].device)
    with torch.no_grad():
        logits = llama.forward(params, mcfg, ids)[0][0, -1]
    top = float(logits.max())
    step = 2.0 ** (math.floor(math.log2(abs(top))) - 7)
    gaps = [(top - float(logits[t])) / step for t in (got[at], want[at])]
    rank = int((logits > logits[got[at]]).sum())
    line = (f"position {at}: served {got[at]} (rank {rank}), reference {want[at]}; "
            f"below the top logit {top:.4f} by {gaps[0]:.1f} and {gaps[1]:.1f} "
            f"bf16 steps of {step:.4e}")
    if max(gaps) > TOKEN_TIE_STEPS and moe_route and mcfg.n_experts:
        _, routes, _ = recorded(lambda: llama.forward(params, mcfg, ids))
        k, lo = mcfg.experts_per_token, len(prompt)
        best = None
        for layer, (rl, _) in enumerate(routes):
            top = rl[lo:lo + at].sort(-1, descending=True).values
            if not top.numel():
                continue
            step = torch.exp2(torch.frexp(top[:, k - 1:k + 1].abs().amax(-1)).exponent - 8.0)
            steps = (top[:, k - 1] - top[:, k]) / step
            p = int(steps.argmin())
            if best is None or float(steps[p]) < best[0]:
                best = (float(steps[p]), layer, lo + p)
        if best is not None and best[0] <= MOE_ROUTE_TIE_STEPS:
            return (f"{line}; a routing near-tie before it: layer {best[1]}, position "
                    f"{best[2]}, top-{k} margin {best[0]:.1f} bf16 steps")
        line += f"; the closest routing tie before it: {best}"
    if max(gaps) > TOKEN_TIE_STEPS:
        fail(f"{tag}: the served tokens leave the reference's at no near-tie: {line}")
    return line


async def serve_checkpoint(family: str, card: str, k1: dict, k2: dict, *,
                           device: str = "cuda") -> list[dict]:
    """Write the family's HF checkpoint from a seed, convert it with the
    port's CLI in a subprocess, serve it through the server's parser and
    EngineServer with --model <converted dir> --prefill-batch 4 and no
    in-memory params, and hold eight concurrent same-bucket prompts'
    greedy tokens against an engine given the same weights in memory with
    prefill_batch=1. Returns the kernel entries of the loaded path."""
    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.engine import checkpoint
    from llm_d_inference_scheduler_tpu_torch.engine import server as server_mod
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.models import convert_hf, llama
    from llm_d_inference_scheduler_tpu_torch.ops import grouped_moe, paged_attention

    hf = HF_CONFIGS[family]
    moe = bool(hf.get("num_local_experts"))
    tag = f"ckpt {family}-{hf['num_hidden_layers']}l"
    mcfg = convert_hf.config_from_hf(hf)
    n_bytes = sum(2 * math.prod(s) for s in llama.param_shapes(mcfg).values())
    check_disk(int(2 * n_bytes * 1.02) + (1 << 30))
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir, out_dir = os.path.join(tmp, "hf"), os.path.join(tmp, "converted")
        sd = hf_state_dict(hf, seed=3, device=device)
        t0 = time.monotonic()
        hf_bytes = write_hf_checkpoint(sd, hf, hf_dir)
        write_s = time.monotonic() - t0
        ref_params = convert_hf.convert_state_dict(sd, mcfg, device=device)
        del sd
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        rc, text, cli_rss = run_measured(
            [sys.executable, "-m", "llm_d_inference_scheduler_tpu_torch.models.convert_hf",
             hf_dir, out_dir, "--device", device],
            cwd=os.path.dirname(os.path.abspath(__file__)))
        convert_s = time.monotonic() - t0
        if rc != 0:
            fail(f"{tag}: the converter CLI exited {rc}: {text[-2000:]}")
        out_bytes = os.path.getsize(os.path.join(out_dir, checkpoint.WEIGHTS))
        log(f"[{tag}] {card}: HF checkpoint {hf_bytes} bytes written in {write_s:.2f}s; "
            f"the CLI converted it in {convert_s:.2f}s ({text.strip()}), "
            f"{out_bytes} bytes, its peak host RSS {cli_rss:.2f} GB")

        argv = ["--model", out_dir, "--prefill-batch", str(CKPT_PREFILL_BATCH),
                "--port", "0", "--max-batch", "8", "--max-model-len", "2048",
                "--kv-events-port", "0", "--device", device]
        cfg, _ = server_mod.parse_config(argv)
        if moe:  # no CLI flag, as on the JAX server
            cfg = dataclasses.replace(cfg, grouped_moe=True)
        rss_before, _ = host_rss_gb()
        t0 = time.monotonic()
        server = server_mod.EngineServer(cfg)
        await server.start()
        engine = server.engine
        try:
            await asyncio.to_thread(wait_for, lambda: health(server.port)[0] == 200,
                                    60, f"{tag}: /health ok")
            load_s = time.monotonic() - t0
            rss_loaded, rss_peak = host_rss_gb()
            loaded, want_flat = (llama.flat_params(p) for p in (engine.params, ref_params))
            if set(loaded) != set(want_flat) or not all(
                    torch.equal(loaded[k], want_flat[k]) for k in want_flat):
                fail(f"{tag}: the loaded weights differ from the in-memory conversion")
            del loaded, want_flat
            got, _ = tap_engine(engine)
            prompts = ckpt_prompts(mcfg.vocab_size)
            sizes, batch_k2 = [], []
            run_batch = engine._run_batched_prefill

            def counted(entries):
                before = grouped_moe.launches
                sizes.append(len(entries))
                run_batch(entries)
                batch_k2.append(grouped_moe.launches - before)

            engine._run_batched_prefill = counted
            # The requests wait at admission until all have arrived, so that
            # they are admitted as one group (two batches of four).
            admit = engine._admit
            engine._admit = lambda: (admit() if len(engine._waiting) >= CKPT_PROMPTS
                                     or any(engine.slots) else None)
            ops.reset_kernel_launches()
            steps0 = engine.decode_steps
            t0 = time.monotonic()
            await asyncio.gather(*[asyncio.to_thread(http_post, server.port, {
                "prompt": p, "max_tokens": CKPT_TOKENS, "temperature": 0,
                "ignore_eos": True, "request_id": f"ck{i}"}) for i, p in enumerate(prompts)])
            wall = time.monotonic() - t0
            launches = ops.kernel_launches()
            paths = dict(grouped_moe.path_launches)
            steps = engine.decode_steps - steps0
            engine._admit = admit
            if family == "llama3-8b":
                await asyncio.to_thread(check_deadline_on_card, server, tag)
        finally:
            await server.stop()
        del engine, server
        gc.collect()
        torch.cuda.empty_cache()

        # The reference: the same weights in memory, the single path.
        ref_cfg = dataclasses.replace(cfg, prefill_batch=1, checkpoint_path="")
        ref = server_mod.EngineServer(ref_cfg, engine=TorchEngine(ref_cfg, params=ref_params))
        want, _ = tap_engine(ref.engine)
        await ref.start()
        try:
            await asyncio.gather(*[asyncio.to_thread(http_post, ref.port, {
                "prompt": p, "max_tokens": CKPT_TOKENS, "temperature": 0,
                "ignore_eos": True, "request_id": f"ck{i}"}) for i, p in enumerate(prompts)])
        finally:
            await ref.stop()
        flips = []
        for i, p in enumerate(prompts):
            g, w = got.get(f"ck{i}", []), want.get(f"ck{i}", [])
            if len(g) != CKPT_TOKENS or len(w) != CKPT_TOKENS:
                fail(f"{tag}: request {i} gave {len(g)} tokens, the reference {len(w)}")
            at = first_divergence(g, w)
            if at is not None:
                flips.append(f"request {i}: " + excuse_flip(ref_params, ref.engine.mcfg,
                                                            p, w, g, at))
        del ref, ref_params
        gc.collect()
        torch.cuda.empty_cache()

    log(f"[{tag}] {card}: load to /health ok {load_s:.2f}s, host RSS (GB) {rss_before} "
        f"before, {rss_loaded} loaded, the process's peak so far {rss_peak:.2f}; "
        f"{CKPT_PROMPTS} requests x {CKPT_TOKENS} tokens in {wall:.3f}s; batched "
        f"prefills {sizes} (rows), K2 launches in them {batch_k2}; decode steps "
        f"{steps}; launches {launches}, K2 by path {paths}")
    log(f"[{tag}] tokens equal to the in-memory prefill_batch=1 engine's for "
        f"{CKPT_PROMPTS - len(flips)} of {CKPT_PROMPTS} requests; near-tie flips "
        f"(limit {TOKEN_TIE_STEPS} bf16 steps): {flips or 'none'}")
    if sizes[:2] != [CKPT_PREFILL_BATCH, CKPT_PREFILL_BATCH]:
        fail(f"{tag}: the eight prompts did not prefill in two batches of four: {sizes}")
    need = mcfg.n_layers * steps
    if steps <= 0 or launches[paged_attention.KERNEL] < need:
        fail(f"{tag}: the decode did not go through K1 ({launches} < {need})")
    entries = [{**k1, "path": f"{tag} serve",
                "launches": launches[paged_attention.KERNEL]}]
    if moe:
        need_k2 = mcfg.n_layers * (len(sizes) + steps)
        if paths["wgmma"] < need_k2 or batch_k2 != [mcfg.n_layers] * len(sizes):
            fail(f"{tag}: the batched prefills and decode steps did not all go "
                 f"through K2's wgmma path ({paths}, in batches {batch_k2}, "
                 f"need {need_k2})")
        entries.append({**k2, "path": f"{tag} serve",
                        "launches": launches[grouped_moe.KERNEL],
                        "launches_by_path": paths,
                        "batched_prefill_launches": sum(batch_k2)})
    return entries


def check_deadline_on_card(server, tag: str) -> None:
    """x-request-timeout on the card: 0 is a 504 before admission; a
    budget the request outlasts is a 504, and its slot and blocks come
    back."""
    engine = server.engine

    def post(budget: str, max_tokens: int):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/completions",
            data=json.dumps({"prompt": "deadline drill", "max_tokens": max_tokens,
                             "ignore_eos": True, "temperature": 0}).encode(),
            headers={"content-type": "application/json", "x-request-timeout": budget})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.headers.get("x-removal-reason")
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("x-removal-reason")

    free0 = engine.allocator.reusable_blocks
    t0 = time.monotonic()
    zero = post("0", 4)
    expired = post("0.3", 1024)
    answered_s = time.monotonic() - t0
    back_s = wait_for(lambda: not any(engine.slots)
                      and engine.allocator.reusable_blocks == free0, 30,
                      f"{tag}: the expired request's blocks")
    log(f"[{tag}] deadline: budget 0 -> {zero}, 0.3 s on 1024 tokens -> {expired} "
        f"(both answered in {answered_s:.2f}s), slot and {free0} reusable blocks "
        f"back {back_s:.3f}s later")
    if zero != (504, "deadline-exceeded") or expired != (504, "deadline-exceeded"):
        fail(f"{tag}: deadlines not enforced: {zero}, {expired}")


def check_orbax_refused(device: str = "cuda") -> None:
    """An Orbax-shaped directory (the JAX converter's) is refused with a
    message that names the port's converter."""
    from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.models.configs import TINY

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "model_config.json"), "w") as f:
            json.dump(dataclasses.asdict(TINY), f)
        open(os.path.join(d, "_CHECKPOINT_METADATA"), "w").close()
        try:
            TorchEngine(EngineConfig(model=d, device=device))
        except ValueError as e:
            if "Orbax" not in str(e) or "convert_hf" not in str(e):
                fail(f"ckpt: an Orbax directory was refused without naming the "
                     f"port's converter: {e}")
            log(f"[ckpt] an Orbax directory is refused: {e}")
            return
    fail("ckpt: an Orbax directory was served")


# ---- phase 10: tensor- and expert-parallel serving --------------------------

TP = 2   # tp ranks of phase 10's llama3-8b engine; EP for its Mixtral engine
EP = 2


def parallel_argv(model: str, device: str, *, tp: int = 1, ep: int = 1, pp: int = 1,
                  extra: tuple[str, ...] = ()) -> list[str]:
    """The server's command line for pp * tp * ep ranks laid on one device
    (the card, or the CPU in a rehearsal), phase 5's engine settings."""
    dev = device if ":" in device or device == "cpu" else f"{device}:0"
    return ["--model", model, "--device", device, "--tp-size", str(tp),
            "--ep-size", str(ep), "--pp-size", str(pp),
            "--devices", ",".join([dev] * (pp * tp * ep)),
            "--port", "0", "--max-batch", "8", "--max-model-len", "2048",
            "--decode-chunk", "8", "--kv-events-port", "0", *extra]


def parallel_config(model: str, device: str, **kw):
    """The engine config of :func:`parallel_argv`, with the host /kv
    handoff pinned (``kv_transfer``, a config field the server takes no
    flag for), so these engines hand KV over as phase 5's do."""
    from llm_d_inference_scheduler_tpu_torch.engine.server import parse_config

    cfg, _ = parse_config(parallel_argv(model, device, **kw))
    return dataclasses.replace(cfg, kv_transfer="host")


async def serve_counted(server, bodies: list[dict], ids: str = "r",
                        group: bool = False) -> dict:
    """A warm-up request, then ``bodies`` at once (request ids r0, r1, ...,
    or ``ids`` in place of r)
    with every kernel's launch count set to 0 just before and read just
    after (with ``group``, in every process of the engine's group, summed;
    ``by_process`` keeps each); returns the tokens, launches (K2's by kernel
    path too, the leader's), decode steps (and by pp schedule), decode tok/s
    and the mean wall time of one decode step (of the engine's fused
    chunks)."""
    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.ops import grouped_moe

    engine = server.engine
    tokens, _ = tap_engine(engine)
    await asyncio.to_thread(http_post, server.port, {
        "prompt": "warm up", "max_tokens": 9, "temperature": 0})
    tel = engine.telemetry
    before = (engine.decode_steps, tel.decode_step.sum, tel.generation_tokens.value)
    by_schedule = dict(engine.decode_steps_by_schedule)
    if group:
        await asyncio.to_thread(engine.group_launches, True)
    ops.reset_kernel_launches()
    t0 = time.monotonic()
    results = await asyncio.gather(*[asyncio.to_thread(
        http_post, server.port, {**b, "request_id": f"{ids}{i}"}) for i, b in enumerate(bodies)])
    wall = time.monotonic() - t0
    launches = ops.kernel_launches()
    by_process = [launches]
    if group:
        by_process = await asyncio.to_thread(engine.group_launches)
        launches = {k: sum(p[k] for p in by_process) for k in by_process[0]}
    paths = dict(grouped_moe.path_launches)
    steps = engine.decode_steps - before[0]
    dec_s = tel.decode_step.sum - before[1]
    dec_tokens = tel.generation_tokens.value - before[2] - len(bodies)
    for i, res in enumerate(results):
        choice = res["json"]["choices"][0]
        if not choice["text"] or choice["finish_reason"] not in ("length", "stop"):
            fail(f"request {i} returned no text or no finish reason: {choice}")
    return {"tokens": tokens, "launches": launches, "steps": steps, "wall": wall,
            "tok_s": dec_tokens / dec_s if dec_s else 0.0, "by_process": by_process,
            "step_ms": dec_s / max(steps, 1) * 1e3, "paths": paths,
            "schedules": {k: engine.decode_steps_by_schedule[k] - n
                          for k, n in by_schedule.items()}}


def near_tie_flips(tag: str, ref_params, mcfg, prompts: list[list[int]],
                   want: dict, got: dict, ids: list[str], moe_route: bool = False) -> list[str]:
    """Each of ``ids``' tokens against the reference's, a divergence
    passing only at a near-tie (``excuse_flip``); returns the reports."""
    flips = []
    for rid, prompt in zip(ids, prompts):
        w, g = want.get(rid, []), got.get(rid, [])
        if not w or len(g) != len(w):
            fail(f"{tag}: {rid} gave {len(g)} tokens, the reference {len(w)}")
        at = first_divergence(g, w)
        if at is not None:
            flips.append(f"{rid}: " + excuse_flip(ref_params, mcfg, prompt, w, g, at, tag,
                                                  moe_route))
    return flips


async def phase_tp(cfg_model, params, card: str, *, model: str = MODEL,
                   device: str = "cuda") -> tuple[int, int]:
    """llama3-8b at full width and depth with tp=2 on two ranks of one
    device, from the server's own parser, against a tp=1 engine on the
    same weights (the shards are views of them): the four requests of
    phase 5, greedy tokens equal up to reported near-ties, K1 tp x n_layers
    times per decode step; then a P/D handoff from the tp=2 engine into a
    tp=1 decode engine (pages per kv-head shard bitwise, tokens against the
    tp=1 engine's). Returns K1's launches on the tp=2 serve path and on the
    P/D decode path."""
    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
    from llm_d_inference_scheduler_tpu_torch.models import llama
    from llm_d_inference_scheduler_tpu_torch.ops import paged_attention

    tag = f"tp{TP}"
    bodies = serve_prompts(model)
    cfg_tp = parallel_config(model, device, tp=TP)
    cfg_1 = parallel_config(model, device)
    ref = EngineServer(cfg_1, engine=TorchEngine(cfg_1, params=params))
    await ref.start()
    try:
        want = await serve_counted(ref, bodies)
    finally:
        await ref.stop()
    tp_engine = TorchEngine(cfg_tp, params=params)
    if tp_engine.layout is None or len(tp_engine.k_pages) != TP:
        fail(f"{tag}: --tp-size {TP} built no sharded engine")
    srv = EngineServer(cfg_tp, engine=tp_engine)
    await srv.start()
    try:
        got = await serve_counted(srv, bodies)
        n_layers = cfg_model.n_layers
        k1 = got["launches"][paged_attention.KERNEL]
        log(f"[{tag}] {model}, {card}: decode steps {got['steps']}, K1 launches {k1} "
            f"(tp x n_layers x steps = {TP * n_layers * got['steps']}); tp=1: steps "
            f"{want['steps']}, K1 {want['launches'][paged_attention.KERNEL]}")
        if got["steps"] <= 0 or k1 != TP * n_layers * got["steps"]:
            fail(f"{tag}: K1 did not launch tp x n_layers times per decode step")
        greedy = [i for i, b in enumerate(bodies) if b["temperature"] == 0]
        prompts = [ref.engine.tokenizer.encode(bodies[i]["prompt"]) for i in greedy]
        # The logits themselves: the first prompt's last position through
        # the tp=1 weights and through the shards, within the coarse gate
        # phase 4 holds 32 bf16 layers to.
        ids = torch.tensor([prompts[0]], device=tp_engine.device)
        with torch.no_grad():
            one = llama.forward(params, cfg_model, ids)[0][0, -1]
            two = llama.forward(tp_engine.params, cfg_model, ids)[0][0, -1]
        rel = float((one - two).abs().max()) / float(one.abs().max())
        log(f"[{tag}] last-position logits of request 0, tp={TP} against tp=1: "
            f"max |diff| / max |logit| = {rel:.4e} (limit {LOGITS_REL_TOL})")
        if not rel <= LOGITS_REL_TOL:
            fail(f"{tag}: the sharded logits leave the tp=1 ones by {rel:.4e}")
        flips = near_tie_flips(tag, params, cfg_model, prompts, want["tokens"],
                               got["tokens"], [f"r{i}" for i in greedy])
        log(f"[{tag}] greedy tokens equal to the tp=1 engine's for "
            f"{len(greedy) - len(flips)} of {len(greedy)} requests; near-tie flips "
            f"(limit {TOKEN_TIE_STEPS} bf16 steps): {flips or 'none'}")
        log(f"[{tag}] {card}: decode {got['tok_s']:.1f} tok/s, {got['step_ms']:.2f} ms "
            f"a decode step (two shards on one card: not a TP speed); tp=1 "
            f"{want['tok_s']:.1f} tok/s, {want['step_ms']:.2f} ms; 4 requests in "
            f"{got['wall']:.3f}s (tp=1 {want['wall']:.3f}s)")

        # P/D: the tp=2 engine exports, a tp=1 engine imports.
        dec = TorchEngine(cfg_1, params=params)
        exported: dict[str, list[int]] = {}
        checks: list[bool] = []
        stage_kv, import_into = tp_engine._op_stage_kv, dec._import_into_slot

        def record_ids(**kwargs):
            exported[kwargs["request_id"]] = (
                kwargs["idx"][: kwargs["meta"]["num_blocks"]].tolist())
            return stage_kv(**kwargs)

        def check_pages(idx, pi, blocks):
            import_into(idx, pi, blocks)
            src = exported[pi.req.kv_transfer_params["remote_request_id"]]
            d_ids = torch.tensor(blocks[: len(src)], device=dec.device)
            h = cfg_model.n_kv_heads // TP
            for t, (kp, vp) in enumerate(zip(tp_engine.k_pages, tp_engine.v_pages)):
                p_ids = torch.tensor(src, device=kp.device)
                heads = slice(t * h, (t + 1) * h)
                checks.append(torch.equal(dec.k_pages[:, d_ids, :, heads], kp[:, p_ids])
                              and torch.equal(dec.v_pages[:, d_ids, :, heads], vp[:, p_ids]))

        tp_engine._op_stage_kv, dec._import_into_slot = record_ids, check_pages
        d_srv = EngineServer(cfg_1, engine=dec)
        pd_tokens, _ = tap_engine(dec)
        await d_srv.start()
        try:
            prompt = pd_prompts()["serial"]
            body = {"prompt": prompt, "max_tokens": PD_TOKENS, "temperature": 0,
                    "ignore_eos": True}
            r1 = await asyncio.to_thread(http_post, srv.port, {
                **body, "max_tokens": 1, "request_id": "pd-pre",
                "kv_transfer_params": {"do_remote_decode": True}})
            ktp = r1["json"]["kv_transfer_params"]
            ops.reset_kernel_launches()
            r2 = await asyncio.to_thread(http_post, d_srv.port, {
                **body, "request_id": "pd-dec", "kv_transfer_params": ktp})
            pd_k1 = ops.kernel_launches()[paged_attention.KERNEL]
        finally:
            await d_srv.stop()
        if r2["headers"].get("x-kv-pull-route") != "host" or not checks or not all(checks):
            fail(f"{tag}: the tp={TP} -> tp=1 handoff did not land the exporter's "
                 f"pages per kv-head shard (route {r2['headers'].get('x-kv-pull-route')}, "
                 f"checks {checks})")
        # The monolithic tp=1 reference of the same prompt.
        mono = EngineServer(cfg_1, engine=TorchEngine(cfg_1, params=params))
        mono_tokens, _ = tap_engine(mono.engine)
        await mono.start()
        try:
            await asyncio.to_thread(http_post, mono.port, {**body, "request_id": "pd-mono"})
        finally:
            await mono.stop()
        ids = ref.engine.tokenizer.encode(prompt)
        pd_flips = near_tie_flips(f"{tag} P/D", params, cfg_model, [ids],
                                  {"pd": mono_tokens["pd-mono"]},
                                  {"pd": pd_tokens["pd-dec"]}, ["pd"])
        log(f"[{tag}] P/D tp={TP} -> tp=1: {r2['headers'].get('x-kv-pull-bytes')} bytes "
            f"pulled in {r2['headers'].get('x-kv-pull-ms')} ms, pages equal per kv-head "
            f"shard ({len(checks)} checks), K1 {pd_k1} launches on the decode engine; "
            f"tokens against the tp=1 monolithic engine: "
            f"{'equal' if not pd_flips else pd_flips}")
    finally:
        await srv.stop()
    del tp_engine, dec
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return got["launches"][paged_attention.KERNEL], pd_k1


def make_cert(path: str) -> str:
    """tls.crt and tls.key for 127.0.0.1 in ``path``, by the ``cryptography``
    package where it is installed, else the ``openssl`` CLI; returns which
    (fails when neither is there)."""
    from llm_d_inference_scheduler_tpu_torch.utils import tls

    crt, key = os.path.join(path, "tls.crt"), os.path.join(path, "tls.key")
    try:
        cert_pem, key_pem = tls.create_self_signed_cert(common_name="localhost")
    except RuntimeError:
        try:
            subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                            "-keyout", key, "-out", crt, "-days", "2",
                            "-subj", "/CN=localhost", "-addext",
                            "subjectAltName=DNS:localhost,IP:127.0.0.1"],
                           check=True, capture_output=True, timeout=60)
        except (OSError, subprocess.CalledProcessError) as e:
            fail(f"tls: no certificate: neither cryptography nor openssl works ({e})")
        return "the openssl CLI"
    with open(crt, "wb") as f:
        f.write(cert_pem)
    with open(key, "wb") as f:
        f.write(key_pem)
    return "the cryptography package"


CHAOS_SPEC = "http503:50"
CHAOS_SEED = 7


async def phase_tls_chaos(params, card: str, *, model: str = MODEL,
                          device: str = "cuda") -> None:
    """One https completion against a tp=2 engine served with --cert-path,
    one chaos http503 (x-removal-reason: chaos-injected), and a completion
    after it: the engine still serves."""
    import ssl

    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
    from llm_d_inference_scheduler_tpu_torch.ops import paged_attention
    from llm_d_inference_scheduler_tpu_torch.utils.faults import FaultInjector

    with tempfile.TemporaryDirectory() as certs:
        made_by = make_cert(certs)
        log(f"[tls] certificate written by {made_by}")
        cfg = parallel_config(model, device, tp=TP, extra=(
            "--secure-serving", "--cert-path", certs, "--chaos", CHAOS_SPEC,
            "--chaos-seed", str(CHAOS_SEED)))
        cfg.max_batch, cfg.max_model_len = 2, 512
        server = EngineServer(cfg, engine=TorchEngine(cfg, params=params))
        await server.start()
        # Request ids the shim passes and fails (its decision is a pure hash).
        probe = FaultInjector.from_spec(CHAOS_SPEC, seed=CHAOS_SEED)
        ids = [f"tls-{i}" for i in range(64)]
        ok = [i for i in ids if probe.decide(i) is None][:2]
        bad = next(i for i in ids if probe.decide(i) is not None)
        context = ssl.create_default_context(cafile=os.path.join(certs, "tls.crt"))

        def post(rid):
            req = urllib.request.Request(
                f"https://127.0.0.1:{server.port}/v1/completions",
                data=json.dumps({"prompt": "Secure serving on the card.",
                                 "max_tokens": 8, "temperature": 0}).encode(),
                headers={"content-type": "application/json", "x-request-id": rid})
            try:
                with urllib.request.urlopen(req, timeout=120, context=context) as r:
                    return r.status, r.headers.get("x-removal-reason"), json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, e.headers.get("x-removal-reason"), json.loads(e.read())

        try:
            ops.reset_kernel_launches()
            first = await asyncio.to_thread(post, ok[0])
            k1 = ops.kernel_launches()[paged_attention.KERNEL]
            chaos = await asyncio.to_thread(post, bad)
            after = await asyncio.to_thread(post, ok[1])
            triggered = dict(server.chaos.triggered)
        finally:
            await server.stop()
    log(f"[tls] {card}: https completion {first[0]} ({first[2]['choices'][0]['text']!r}, "
        f"K1 {k1} launches), chaos {chaos[0]} x-removal-reason={chaos[1]}, then "
        f"{after[0]}; triggered {triggered}")
    if first[0] != 200 or not first[2]["choices"][0]["text"] or k1 <= 0:
        fail(f"tls: the https completion failed: {first}")
    if chaos[:2] != (503, "chaos-injected") or triggered["http503"] != 1:
        fail(f"tls: the chaos request was not answered 503 chaos-injected: {chaos}")
    if after[0] != 200:
        fail(f"tls: the engine stopped serving after the chaos request: {after}")


async def phase_ep(cfg_model, params, card: str, *, model: str, served: str,
                   device: str = "cuda") -> int:
    """Mixtral with ep=2 (dense over each rank's local experts, one sum)
    against a tp=1 dense engine on the same weights: phase 5's four
    requests, greedy tokens equal up to reported near-ties. Returns K1's
    launches on the ep=2 serve path."""
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
    from llm_d_inference_scheduler_tpu_torch.ops import paged_attention

    tag = f"ep{EP}"
    bodies = serve_prompts(served)
    runs = {}
    for key, ep in (("ref", 1), ("ep", EP)):
        cfg = parallel_config(model, device, ep=ep, extra=(
            "--served-model-name", served))
        srv = EngineServer(cfg, engine=TorchEngine(cfg, params=params))
        if ep > 1 and (srv.engine.layout is None or srv.engine.mcfg.moe_impl != "dense"):
            fail(f"{tag}: --ep-size {ep} built no dense sharded engine")
        await srv.start()
        try:
            runs[key] = await serve_counted(srv, bodies)
        finally:
            await srv.stop()
        tok = srv.engine.tokenizer
        del srv
        gc.collect()
    got, want = runs["ep"], runs["ref"]
    k1 = got["launches"][paged_attention.KERNEL]
    if got["steps"] <= 0 or k1 != cfg_model.n_layers * got["steps"]:
        fail(f"{tag}: K1 did not launch n_layers times per decode step ({k1}, "
             f"steps {got['steps']})")
    greedy = [i for i, b in enumerate(bodies) if b["temperature"] == 0]
    prompts = [tok.encode(bodies[i]["prompt"]) for i in greedy]
    flips = near_tie_flips(tag, params, cfg_model, prompts, want["tokens"],
                           got["tokens"], [f"r{i}" for i in greedy])
    log(f"[{tag}] {served}, {card}: greedy tokens equal to the tp=1 dense engine's for "
        f"{len(greedy) - len(flips)} of {len(greedy)} requests; near-tie flips "
        f"(limit {TOKEN_TIE_STEPS} bf16 steps): {flips or 'none'}; decode steps "
        f"{got['steps']}, K1 {k1}; decode {got['tok_s']:.1f} tok/s, "
        f"{got['step_ms']:.2f} ms a decode step (two shards on one card: not an EP "
        f"speed); tp=1 dense {want['tok_s']:.1f} tok/s, {want['step_ms']:.2f} ms")
    return k1


# ---- phase 11: pipeline-parallel serving -------------------------------------

PP = 2   # stages of phase 11's llama3-8b and Mixtral engines
LLAMA70B = "llama3-70b"
# Llama-3-70B in bf16 is ~141 GB at 80 layers; 16 layers take 31.6 GB
# (with the embedding and the head), so the engines' KV pages and the
# forward that holds the logits to pp=1 fit beside them on 80 GB.
LLAMA70B_LAYERS = 16
LLAMA70B_SERVED = "llama3-70b-16l"


def expected_k1(pp: int, tp: int, n_layers: int, schedules: dict) -> int:
    """K1 launches of the decode steps each pp schedule took: tp x L a step
    on the broadcast ring, pp x tp x L on the lane-group interleave (each of
    the pp lane groups runs the whole stack, at B/pp lanes)."""
    return tp * n_layers * (schedules["ring"] + pp * schedules["interleave"])


def stage_tag(served: str, pp: int, tp: int = 1, ep: int = 1) -> str:
    return (f"{served} pp{pp}" + (f"tp{tp}" if tp > 1 else "")
            + (f"ep{ep}" if ep > 1 else ""))


def schedule_logits(params, staged, mcfg, prompts: list[list[int]]) -> dict[str, float]:
    """One decode step of each pp schedule against a pp=1 ``decode_step``
    at the same tp x ep (the shards views of ``params``, so the rank sums
    add in the same order and only the stages differ; ``phase_pp``'s
    prefill gate holds tp and ep to tp=1) on the same tokens, positions
    and block tables. Each side prefills ``prompts`` (one lane each) into
    pages of its own layout with ``llama.prefill``; then the staged
    ``decode_step`` (the broadcast ring) and both tokens of a two-token
    lane-group interleave chunk (``pp_serve.interleaved_chunk``, fed the
    reference's greedy tokens, so its second step reads the KV its first
    wrote) are held to the reference's steps. Returns max |diff| / max
    |logit| per step; needs len(prompts) % pp == 0."""
    from llm_d_inference_scheduler_tpu_torch.models import llama
    from llm_d_inference_scheduler_tpu_torch.parallel import pp_serve
    from llm_d_inference_scheduler_tpu_torch.parallel import serve as par

    layout = staged.layout
    dev, dtype = params["embed"].device, params["embed"].dtype
    flat = par.make_serve_layout([dev] * (layout.tp * layout.ep), layout.tp, layout.ep)
    ref = par.shard_params(params, mcfg, flat)
    block, B = mcfg.kv_block_size, len(prompts)
    W = max(-(-(len(p) + 2) // block) for p in prompts)    # room for two tokens
    tables = (1 + torch.arange(B * W, dtype=torch.int32, device=dev)).reshape(B, W)
    pages = {id(ref): par.alloc_sharded_pages(mcfg, flat, 1 + B * W, dtype),
             id(staged): par.alloc_sharded_pages(mcfg, layout, 1 + B * W, dtype)}
    first = []
    for b, prompt in enumerate(prompts):
        ids = torch.tensor([prompt], device=dev)
        n = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
        for side in (ref, staged):
            logits, _, _ = llama.prefill(side, mcfg, ids, n, *pages[id(side)], tables[b:b + 1])
            if side is ref:
                first.append(int(logits[0].argmax()))
    tok0 = torch.tensor(first, device=dev)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    want_logits = [llama.decode_step(ref, mcfg, tok0, lens, *pages[id(ref)], tables)[0]]
    ring = llama.decode_step(staged, mcfg, tok0, lens, *pages[id(staged)], tables)[0]
    want = [want_logits[0].argmax(-1)]
    want_logits.append(llama.decode_step(ref, mcfg, want[0], lens + 1, *pages[id(ref)],
                                         tables)[0])
    want.append(want_logits[1].argmax(-1))
    Bg = B // layout.pp
    seen: list[list[torch.Tensor]] = [[], []]

    def sample(logits, g):
        j = (len(seen[0]) + len(seen[1])) // layout.pp   # each token's groups in order
        seen[j].append(logits)
        return want[j][g * Bg:(g + 1) * Bg].to(logits.device)

    pp_serve.interleaved_chunk(staged, mcfg, tok0, lens, *pages[id(staged)], tables, 2, sample)

    def rel(got, want_):
        got = got.to(want_.device)
        return float((got - want_).abs().max()) / float(want_.abs().max())

    return {"ring": rel(ring, want_logits[0]),
            "interleave step 1": rel(torch.cat(seen[0]), want_logits[0]),
            "interleave step 2": rel(torch.cat(seen[1]), want_logits[1])}


async def phase_pp(cfg_model, params, card: str, *, model: str, served: str, pp: int,
                   tp: int = 1, ep: int = 1, grouped: bool = False,
                   device: str = "cuda", ref: dict | None = None) -> dict:
    """A pp (x tp x ep) engine from the server's parser, all ranks on one
    device, against a pp=1 engine on the same weights (the stages' shards
    are views of them): phase 5's four requests (batch bucket 4, so the
    lane-group interleave wherever 4 divides by pp), then one single-lane
    request (the broadcast ring), each counted; greedy tokens equal up to
    reported near-ties; K1 launches as each schedule predicts (and K2, with
    ``grouped``, L per prefill and per layer stack a step runs, all on
    wgmma); the last-position logits of request 0 within LOGITS_REL_TOL of
    pp=1's, and those of one decode step of each schedule
    (``schedule_logits``). Returns the pp engine's launches and K2's by
    path, each summed over both counted runs, and the pp=1 runs (``ref`` takes them back, so a second layout
    of the same weights serves pp=1 once)."""
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
    from llm_d_inference_scheduler_tpu_torch.models import llama
    from llm_d_inference_scheduler_tpu_torch.ops import grouped_moe, paged_attention

    tag = stage_tag(served, pp, tp, ep)
    bodies = serve_prompts(served)
    single = [{**bodies[0], "prompt": bodies[0]["prompt"][-300:]}]
    extra = ("--served-model-name", served)
    runs: dict[str, dict] = dict(ref or {})
    for key, degrees in (("ref", {}), ("pp", dict(pp=pp, tp=tp, ep=ep))):
        if key in runs:
            continue
        cfg = parallel_config(model, device, **degrees, extra=extra)
        cfg.grouped_moe = grouped
        engine = TorchEngine(cfg, params=params)
        if key == "pp" and (engine.layout is None or engine.layout.pp != pp
                            or len(engine.k_pages) != pp * tp):
            fail(f"{tag}: --pp-size {pp} built no staged engine")
        if grouped and engine.mcfg.moe_impl != "grouped":
            fail(f"{tag}: grouped_moe did not select the grouped FFN")
        srv = EngineServer(cfg, engine=engine)
        await srv.start()
        try:
            runs[key] = await serve_counted(srv, bodies)
            runs[key + "-single"] = await serve_counted(srv, single, ids="s")
            if key == "pp":
                greedy = [i for i, b in enumerate(bodies) if b["temperature"] == 0]
                tok = engine.tokenizer
                prompts = [tok.encode(bodies[i]["prompt"]) for i in greedy]
                # The engine's FFN (grouped or dense) on both sides.
                mcfg = engine.mcfg
                ids = torch.tensor([prompts[0]], device=engine.device)
                with torch.no_grad():
                    one = llama.forward(params, mcfg, ids)[0][0, -1]
                    staged = llama.forward(engine.params, mcfg, ids)[0][0, -1]
                    rel = float((one - staged).abs().max()) / float(one.abs().max())
                    del one, staged
                    by_step = schedule_logits(params, engine.params, mcfg,
                                              [tok.encode(b["prompt"]) for b in bodies])
        finally:
            await srv.stop()
        del srv, engine
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    L = cfg_model.n_layers
    launches, paths = {}, {}
    for key in ("pp", "pp-single"):
        run = runs[key]
        k1, want_k1 = run["launches"][paged_attention.KERNEL], expected_k1(
            pp, tp, L, run["schedules"])
        log(f"[{tag}] {card}, {'4 requests' if key == 'pp' else 'one request'}: decode "
            f"steps {run['steps']} ({run['schedules']}), K1 launches {k1} (tp x L x "
            f"(ring + pp x interleave) = {want_k1}), launches {run['launches']}, K2 by "
            f"path {run['paths']}")
        if run["steps"] <= 0 or k1 != want_k1:
            fail(f"{tag}: K1 did not launch as the pp schedules predict ({k1} != {want_k1})")
        if grouped:
            n_prefills = len(bodies) if key == "pp" else 1
            want_k2 = L * (n_prefills + run["schedules"]["ring"]
                           + pp * run["schedules"]["interleave"])
            k2 = run["launches"][grouped_moe.KERNEL]
            if k2 != want_k2 or run["paths"]["wgmma"] != want_k2:
                fail(f"{tag}: K2 launched {k2} times ({run['paths']}), not L per "
                     f"prefill and per layer stack of each step ({want_k2}), all on wgmma")
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
        for name, n in run["paths"].items():
            paths[name] = paths.get(name, 0) + n
    if runs["pp"]["schedules"]["interleave"] <= 0 and 4 % pp == 0:
        fail(f"{tag}: the bucket-4 run never took the lane-group interleave")
    if runs["pp-single"]["schedules"]["interleave"] != 0:
        fail(f"{tag}: the single-lane run left the broadcast ring")
    log(f"[{tag}] last-position logits of request 0 against pp=1: max |diff| / max "
        f"|logit| = {rel:.4e} (limit {LOGITS_REL_TOL})")
    if not rel <= LOGITS_REL_TOL:
        fail(f"{tag}: the staged logits leave the pp=1 ones by {rel:.4e}")
    log(f"[{tag}] decode-step logits of the four prompts against the decode_step of "
        f"pp=1 at tp={tp} ep={ep} on the same tokens and tables, max |diff| / max |logit|: "
        + ", ".join(f"{k} {v:.4e}" for k, v in by_step.items())
        + f" (limit {LOGITS_REL_TOL})")
    if not all(v <= LOGITS_REL_TOL for v in by_step.values()):
        fail(f"{tag}: a pp schedule's decode logits leave pp=1's: {by_step}")
    ids = [f"r{i}" for i in greedy] + ["s0"]
    want_tokens = runs["ref"]["tokens"] | runs["ref-single"]["tokens"]
    got_tokens = runs["pp"]["tokens"] | runs["pp-single"]["tokens"]
    flips = near_tie_flips(tag, params, mcfg, prompts + [tok.encode(single[0]["prompt"])],
                           want_tokens, got_tokens, ids)
    got, want = runs["pp"], runs["ref"]
    log(f"[{tag}] greedy tokens equal to the pp=1 engine's for {len(ids) - len(flips)} "
        f"of {len(ids)} requests; near-tie flips (limit {TOKEN_TIE_STEPS} bf16 steps): "
        f"{flips or 'none'}")
    log(f"[{tag}] {card}: decode {got['tok_s']:.1f} tok/s, {got['step_ms']:.2f} ms a decode "
        f"step over the 4 requests, single lane {runs['pp-single']['tok_s']:.1f} tok/s, "
        f"{runs['pp-single']['step_ms']:.2f} ms (all stages on one card: not a pipeline "
        f"speed); pp=1 {want['tok_s']:.1f} tok/s, {want['step_ms']:.2f} ms, single lane "
        f"{runs['ref-single']['tok_s']:.1f} tok/s, {runs['ref-single']['step_ms']:.2f} ms")
    return {"launches": launches, "paths": paths,
            "ref": {k: runs[k] for k in ("ref", "ref-single")}}


def shard_page_checks(src, src_ids: list[int], dst, dst_ids: list[int]) -> list[bool]:
    """The imported pages of ``dst`` at ``dst_ids`` against every (stage,
    kv-head) shard of ``src``'s pages at ``src_ids``, bitwise: one check
    per shard of the staged or sharded side."""
    from llm_d_inference_scheduler_tpu_torch.parallel import serve as par

    def full(engine, ids):
        ks, vs = [], []
        for kp, vp in engine._page_pairs():
            i = torch.tensor(ids, device=kp.device)
            ks.append(kp[:, i])
            vs.append(vp[:, i])
        tp = engine.cfg.tp_size
        return par.join_pages(ks, tp), par.join_pages(vs, tp)

    want_k, want_v = full(src, src_ids)
    got_k, got_v = full(dst, dst_ids)
    checks = []
    for engine in (src, dst):
        pp, tp = engine.cfg.pp_size, engine.cfg.tp_size
        if pp * tp == 1:
            continue
        Lp, h = want_k.shape[0] // pp, want_k.shape[3] // tp
        for s in range(pp):
            for t in range(tp):
                cut = (slice(s * Lp, (s + 1) * Lp), slice(None), slice(None),
                       slice(t * h, (t + 1) * h))
                checks.append(torch.equal(want_k[cut], got_k[cut])
                              and torch.equal(want_v[cut], got_v[cut]))
    return checks


async def phase_pp_pd(cfg_model, params, card: str, *, model: str = MODEL,
                      device: str = "cuda") -> int:
    """P/D of one ~1030-token prompt from a pp=2 prefill engine into a tp=1
    decode engine, and from a tp=1 prefill engine into a pp=2 decode engine:
    the imported pages equal each (stage, kv-head) shard bitwise, and the
    tokens equal a monolithic tp=1 engine's up to reported near-ties.
    Returns K1's launches on the pp=2 decode engine."""
    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
    from llm_d_inference_scheduler_tpu_torch.ops import paged_attention

    tag = f"{model} pp{PP} P/D"
    cfg_pp = parallel_config(model, device, pp=PP)
    cfg_1 = parallel_config(model, device)
    prompt = pd_prompts()["serial"]
    body = {"prompt": prompt, "max_tokens": PD_TOKENS, "temperature": 0, "ignore_eos": True}
    mono = EngineServer(cfg_1, engine=TorchEngine(cfg_1, params=params))
    mono_tokens, _ = tap_engine(mono.engine)
    await mono.start()
    try:
        await asyncio.to_thread(http_post, mono.port, {**body, "request_id": "pd-mono"})
    finally:
        await mono.stop()
    ids = mono.engine.tokenizer.encode(prompt)
    del mono
    k1 = 0
    for direction, (cfg_pre, cfg_dec) in (("pp2 -> tp1", (cfg_pp, cfg_1)),
                                          ("tp1 -> pp2", (cfg_1, cfg_pp))):
        pre = TorchEngine(cfg_pre, params=params)
        dec = TorchEngine(cfg_dec, params=params)
        exported: dict[str, list[int]] = {}
        checks: list[bool] = []
        stage_kv, import_into = pre._op_stage_kv, dec._import_into_slot

        def record_ids(stage_kv=stage_kv, exported=exported, **kwargs):
            exported[kwargs["request_id"]] = (
                kwargs["idx"][: kwargs["meta"]["num_blocks"]].tolist())
            return stage_kv(**kwargs)

        def check_pages(idx, pi, blocks, pre=pre, dec=dec, import_into=import_into,
                        exported=exported, checks=checks):
            import_into(idx, pi, blocks)
            src = exported[pi.req.kv_transfer_params["remote_request_id"]]
            checks.extend(shard_page_checks(pre, src, dec, blocks[: len(src)]))

        pre._op_stage_kv, dec._import_into_slot = record_ids, check_pages
        p_srv, d_srv = EngineServer(cfg_pre, engine=pre), EngineServer(cfg_dec, engine=dec)
        pd_tokens, _ = tap_engine(dec)
        await p_srv.start()
        await d_srv.start()
        try:
            r1 = await asyncio.to_thread(http_post, p_srv.port, {
                **body, "max_tokens": 1, "request_id": "pd-pre",
                "kv_transfer_params": {"do_remote_decode": True}})
            ktp = r1["json"]["kv_transfer_params"]
            ops.reset_kernel_launches()
            steps = dec.decode_steps
            r2 = await asyncio.to_thread(http_post, d_srv.port, {
                **body, "request_id": "pd-dec", "kv_transfer_params": ktp})
            dec_k1 = ops.kernel_launches()[paged_attention.KERNEL]
            steps = dec.decode_steps - steps
        finally:
            await d_srv.stop()
            await p_srv.stop()
        if r2["headers"].get("x-kv-pull-route") != "host" or not checks or not all(checks):
            fail(f"{tag} {direction}: the handoff did not land the exporter's pages per "
                 f"(stage, kv-head) shard (route {r2['headers'].get('x-kv-pull-route')}, "
                 f"checks {checks})")
        if dec_k1 != cfg_model.n_layers * steps:
            fail(f"{tag} {direction}: K1 launched {dec_k1} times for {steps} decode steps "
                 f"of one lane (the broadcast ring: n_layers a step)")
        flips = near_tie_flips(f"{tag} {direction}", params, cfg_model, [ids],
                               {"pd": mono_tokens["pd-mono"]}, {"pd": pd_tokens["pd-dec"]},
                               ["pd"])
        log(f"[{tag}] {direction}, {card}: {r2['headers'].get('x-kv-pull-bytes')} bytes "
            f"pulled in {r2['headers'].get('x-kv-pull-ms')} ms, pages equal per (stage, "
            f"kv-head) shard ({len(checks)} checks), K1 {dec_k1} launches on the decode "
            f"engine ({steps} steps); tokens against the tp=1 monolithic engine: "
            f"{'equal' if not flips else flips}")
        if cfg_dec is cfg_pp:
            k1 = dec_k1
        del p_srv, d_srv, pre, dec
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return k1


# ---- phase 12: the simulator ---------------------------------------------------


async def phase_sim(card: str) -> None:
    """The port's CPU simulator from the server's parser with --backend sim
    --platform cpu: one completion, one streamed request, /health and
    /metrics, and no kernel launch."""
    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer, parse_config
    from llm_d_inference_scheduler_tpu_torch.engine.sim import SimEngine

    cfg, _ = parse_config(["--backend", "sim", "--platform", "cpu", "--model", MODEL,
                           "--port", "0", "--kv-events-port", "0"])
    server = EngineServer(cfg)
    if not isinstance(server.engine, SimEngine) or cfg.device != "cpu":
        fail(f"sim: --backend sim --platform cpu built {type(server.engine).__name__} "
             f"on {cfg.device}")
    await server.start()
    try:
        ops.reset_kernel_launches()
        plain = await asyncio.to_thread(http_post, server.port, {
            "prompt": "Simulated engine, one completion.", "max_tokens": 8})
        streamed = await asyncio.to_thread(http_post, server.port, {
            "prompt": "Simulated engine, streamed.", "max_tokens": 8, "stream": True})
        launches = ops.kernel_launches()
        health = json.loads(await asyncio.to_thread(http_get, server.port, "/health"))
        metrics = await asyncio.to_thread(http_get, server.port, "/metrics")
    finally:
        await server.stop()
    texts = [r["json"]["choices"][0] for r in (plain, streamed)]
    log(f"[sim] {card}: completion {texts[0]['text']!r} ({texts[0]['finish_reason']}), "
        f"streamed {texts[1]['text']!r} (client TTFT {streamed['ttft_s'] * 1e3:.1f} ms), "
        f"/health {health}, kernel launches {launches}")
    if any(not t["text"] or t["finish_reason"] != "length" for t in texts):
        fail(f"sim: a request returned no text: {texts}")
    if health.get("status") != "ok" or "jetstream:generation_tokens_total" not in metrics:
        fail(f"sim: /health {health} or /metrics without the jetstream names")
    if any(launches.values()):
        fail(f"sim: the simulator launched kernels: {launches}")


# ---- phase 13: multi-process serving and the KV wires ------------------------

DIST_PROCS = 2
DIST_DEVICE = "cuda"   # "cpu" in a rehearsal at tiny sizes
MOE_DIST_LAYERS = 8    # of 32: the follower draws a stacked tensor whole
MOE_DIST_SERVED = "mixtral-8x7b-8l"
# How long an in-flight request may take to end once a follower died.
DRILL_END_S = 15.0
_SPAWNED: list = []


def _reap_spawned() -> None:
    """Stop every process this script started (its whole process group)."""
    import signal

    for p in _SPAWNED:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                pass
            p.wait(10)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_cli(argv: list[str], log_path: str, *, own_follower: bool = False):
    """The port's server CLI in a process of its own (its own session, so
    it and its children are killed together), output to ``log_path``. With
    ``own_follower``, a group's follower runs this script's
    ``--dist-follower`` instead (for a model directory, a config without
    weights, which the server refuses; or to set a config field the server
    takes no flag for), which draws its ranks' weights from the seed as the
    server would for a registry model."""
    import atexit

    if not _SPAWNED:
        atexit.register(_reap_spawned)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = ([sys.executable, os.path.abspath(__file__), "--dist-follower"] if own_follower
           else [sys.executable, "-m", "llm_d_inference_scheduler_tpu_torch.engine.server"])
    with open(log_path, "wb") as out:  # the child keeps its own descriptor
        p = subprocess.Popen([*cmd, *argv], cwd=root, env=env, stdout=out,
                             stderr=subprocess.STDOUT, start_new_session=True)
    p.log_path = log_path
    _SPAWNED.append(p)
    return p


def tail(p, n: int = 30) -> str:
    with open(p.log_path, errors="replace") as f:
        return "".join(f.readlines()[-n:])


def kill(p) -> int:
    import signal

    if p.poll() is None:
        os.killpg(p.pid, signal.SIGKILL)
    return p.wait(30)


def dist_argv(model: str, *, pid: int, coord: int, instr: int, tp: int = 1, pp: int = 1,
              extra: tuple[str, ...] = ()) -> list[str]:
    """The server's command line of process ``pid`` of a two-process group on
    the card (each process names its own ranks), phase 5's engine
    settings."""
    n_local = pp * tp // DIST_PROCS
    dev = "cuda:0" if DIST_DEVICE == "cuda" else DIST_DEVICE
    return ["--model", model, "--device", DIST_DEVICE, "--tp-size", str(tp),
            "--pp-size", str(pp), "--devices", ",".join([dev] * n_local), "--port", "0",
            "--max-batch", "8", "--max-model-len", "2048", "--decode-chunk", "8",
            "--kv-events-port", "0",
            "--dist-coordinator", f"127.0.0.1:{coord}",
            "--dist-num-processes", str(DIST_PROCS), "--dist-process-id", str(pid),
            "--dist-instr-port", str(instr), *extra]


class DistGroup:
    """A two-process engine group on the card: the follower from the server
    CLI, the leader in this process on ``params`` (its ranks' shards are
    views of them; the follower draws the same weights from the seed).
    ``wire`` sets the group's ``kv_wire`` (a config field the server takes
    no flag for): other than "auto", the follower runs this script's
    ``--dist-follower``, which sets it in its own config."""

    def __init__(self, model: str, params, tag: str, logs: str, wire: str = "auto", **kw):
        from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
        from llm_d_inference_scheduler_tpu_torch.engine.server import parse_config

        coord, instr = free_port(), free_port()
        self.tag = tag
        own = wire != "auto" or os.path.isdir(model)
        self.follower = spawn_cli(
            (["--kv-wire", wire] if own else [])
            + dist_argv(model, pid=1, coord=coord, instr=instr, **kw),
            os.path.join(logs, "".join(c if c.isalnum() else "_" for c in tag) + ".log"),
            own_follower=own)
        self.cfg = dataclasses.replace(
            parse_config(dist_argv(model, pid=0, coord=coord, instr=instr, **kw))[0],
            kv_wire=wire)
        t0 = time.monotonic()
        try:
            self.engine = TorchEngine(self.cfg, params=params)
        except Exception:
            log(f"[{tag}] follower output:\n{tail(self.follower)}")
            raise
        self.join_s = time.monotonic() - t0
        lay = self.engine.layout
        if lay is None or lay.procs != DIST_PROCS:
            fail(f"{tag}: the leader built no {DIST_PROCS}-process layout")
        self.backend = self.engine.comm.backend

    async def start(self):
        from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer

        self.server = EngineServer(self.cfg, engine=self.engine)
        await self.server.start()
        return self

    async def stop(self, expect_exit: bool = True) -> None:
        """Stop the leader (its stop releases the follower), then the
        follower must exit 0 on its own."""
        await self.server.stop()
        if expect_exit:
            try:
                rc = self.follower.wait(60)
            except subprocess.TimeoutExpired:
                rc = kill(self.follower)
                fail(f"{self.tag}: the follower did not exit after the leader stopped")
            if rc != 0:
                fail(f"{self.tag}: the follower exited {rc}:\n{tail(self.follower)}")
        else:
            kill(self.follower)

    def check_kernels(self) -> list[dict]:
        """K1 (and K2) in every process of the group against their plain
        versions at the process's own shapes (``TorchEngine.check_kernels``)."""
        atol, rtol = TOL[torch.bfloat16]
        res = self.engine.check_kernels(atol, rtol, MOE_BF16_TOL)
        log(f"[{self.tag}] kernels against their plain versions in each process "
            f"(max abs err, within tolerance): {res}")
        if not all(ok for per in res for _, ok in per.values()):
            fail(f"{self.tag}: a kernel disagrees with its plain version in the group: {res}")
        return res


def logits_gate(tag: str, engine, params, mcfg, prompt: list[int]) -> float:
    """The group's last-position logits of ``prompt`` against one rank's
    forward on ``params``, max |diff| / max |logit| within LOGITS_REL_TOL."""
    from llm_d_inference_scheduler_tpu_torch.models import llama

    got = torch.from_numpy(engine.last_logits(prompt))
    with torch.no_grad():
        want = llama.forward(params, mcfg, torch.tensor([prompt], device=engine.device))[0][0, -1]
    want = want.float().cpu()
    rel = float((got - want).abs().max()) / float(want.abs().max())
    log(f"[{tag}] last-position logits against one rank: max |diff| / max |logit| = "
        f"{rel:.4e} (limit {LOGITS_REL_TOL})")
    if not rel <= LOGITS_REL_TOL:
        fail(f"{tag}: the group's logits leave one rank's by {rel:.4e}")
    return rel


async def phase_dist_tp(cfg_model, params, card: str, logs: str, model: str = MODEL) -> dict:
    """13a: llama3-8b at full width and depth with tp=2 over two processes
    against the single-process tp=1 engine on the same weights: phase 5's
    four requests, tokens equal up to reported near-ties, K1 once per layer
    and step in each process. 13d, first drill: the follower killed under a
    request. Returns K1's launches summed over the group."""
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
    from llm_d_inference_scheduler_tpu_torch.ops import paged_attention

    tag = "dist tp2"
    bodies = serve_prompts(model)
    cfg_1 = parallel_config(model, DIST_DEVICE)
    ref = EngineServer(cfg_1, engine=TorchEngine(cfg_1, params=params))
    await ref.start()
    try:
        want = await serve_counted(ref, bodies)
    finally:
        await ref.stop()
    del ref
    g = DistGroup(model, params, tag, logs, tp=2)
    log(f"[{tag}] {card}: backend {g.backend}; the group joined in {g.join_s:.1f}s "
        f"(the follower's start and weight draw)")
    await g.start()
    try:
        checks = await asyncio.to_thread(g.check_kernels)
        got = await serve_counted(g.server, bodies, group=True)
        L = cfg_model.n_layers
        k1 = [p[paged_attention.KERNEL] for p in got["by_process"]]
        log(f"[{tag}] decode steps {got['steps']}, K1 launches by process {k1} (n_layers x "
            f"steps = {L * got['steps']} each), launches by process {got['by_process']}")
        if got["steps"] <= 0 or k1 != [L * got["steps"]] * DIST_PROCS:
            fail(f"{tag}: K1 did not launch once per layer and step in each process")
        tok = g.engine.tokenizer
        greedy = [i for i, b in enumerate(bodies) if b["temperature"] == 0]
        prompts = [tok.encode(bodies[i]["prompt"]) for i in greedy]
        rel = await asyncio.to_thread(logits_gate, tag, g.engine, params, cfg_model,
                                      prompts[0])
        flips = near_tie_flips(tag, params, cfg_model, prompts, want["tokens"],
                               got["tokens"], [f"r{i}" for i in greedy])
        log(f"[{tag}] greedy tokens equal to the single-process tp=1 engine's for "
            f"{len(greedy) - len(flips)} of {len(greedy)} requests; near-tie flips: "
            f"{flips or 'none'}")
        log(f"[{tag}] {card}: decode {got['tok_s']:.1f} tok/s, {got['step_ms']:.2f} ms a "
            f"decode step (two processes on one card, collectives through gloo: not a TP "
            f"speed); tp=1 {want['tok_s']:.1f} tok/s, {want['step_ms']:.2f} ms")
        # 13d: the follower dies under a request.
        drill = await drill_follower_lost(g, tag)
    finally:
        await g.stop(expect_exit=False)
    return {"launches": got["launches"][paged_attention.KERNEL], "checks": checks,
            "rel": rel, "step_ms": got["step_ms"], "ref_step_ms": want["step_ms"],
            "backend": g.backend, "drill": drill}


async def drill_follower_lost(g: DistGroup, tag: str) -> dict:
    """Kill the follower while a long request decodes: the request ends
    within DRILL_END_S, /health answers 503 "degraded", and a new request
    ends at once."""
    port, engine = g.server.port, g.engine
    before = engine.decode_steps
    req = asyncio.ensure_future(asyncio.to_thread(http_post, port, {
        "prompt": "the drill", "max_tokens": 1500, "temperature": 0, "ignore_eos": True}))
    t0 = time.monotonic()
    while engine.decode_steps == before:
        if time.monotonic() - t0 > 60:
            fail(f"{tag}: the drill request never decoded")
        await asyncio.sleep(0.01)
    kill(g.follower)
    t_kill = time.monotonic()
    try:
        res = await asyncio.wait_for(req, DRILL_END_S)
        ended = time.monotonic() - t_kill
        n = len(res["json"]["choices"][0]["text"])
    except asyncio.TimeoutError:
        fail(f"{tag}: the in-flight request did not end within {DRILL_END_S}s of the "
             "follower's death")
    except urllib.error.HTTPError as e:
        ended, n = time.monotonic() - t_kill, f"HTTP {e.code}"
    status, doc = await asyncio.to_thread(health, port)
    t1 = time.monotonic()
    try:
        after = await asyncio.wait_for(asyncio.to_thread(http_post, port, {
            "prompt": "after", "max_tokens": 8, "temperature": 0}), DRILL_END_S)
        after = after["json"]["choices"][0]["finish_reason"]
    except urllib.error.HTTPError as e:
        after = f"HTTP {e.code}"
    except asyncio.TimeoutError:
        fail(f"{tag}: a request to the degraded leader hung")
    log(f"[13d] follower killed: the in-flight request ended {ended:.2f}s later "
        f"({n} chars), /health {status} {doc.get('status')}, a new request ended in "
        f"{time.monotonic() - t1:.2f}s ({after})")
    if status != 503 or doc.get("status") != "degraded" or not engine.dist_degraded:
        fail(f"{tag}: /health answered {status} {doc} after the follower's death")
    return {"ended_s": ended}


async def drill_leader_lost(logs: str) -> float:
    """13d, second drill: a two-process group from the server CLI (tiny,
    tp=2 on the card); SIGKILL on the leader makes the follower exit
    nonzero. Returns the seconds it took."""
    coord, instr, port = free_port(), free_port(), free_port()
    argv = ["--max-batch", "2", "--max-model-len", "256"]
    leader = spawn_cli(dist_argv("tiny", pid=0, coord=coord, instr=instr, tp=2,
                                 extra=tuple(argv)) + ["--port", str(port)],
                       os.path.join(logs, "drill_leader.log"))
    follower = spawn_cli(dist_argv("tiny", pid=1, coord=coord, instr=instr, tp=2,
                                   extra=tuple(argv)), os.path.join(logs, "drill_follower.log"))
    try:
        t0 = time.monotonic()
        while True:
            try:
                if health(port)[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() - t0 > 120 or leader.poll() is not None:
                fail(f"13d: the CLI group never served:\n{tail(leader)}\n{tail(follower)}")
            await asyncio.sleep(0.2)
        kill(leader)
        t_kill = time.monotonic()
        try:
            rc = follower.wait(45)
        except subprocess.TimeoutExpired:
            fail("13d: the follower outlived its leader by 45 s")
        took = time.monotonic() - t_kill
        lost = "LeaderLost" in tail(follower, 200)
        log(f"[13d] leader killed: the follower exited {rc} {took:.2f}s later "
            f"(LeaderLost logged: {lost})")
        if rc == 0 or not lost:
            fail(f"13d: the follower exited {rc} after its leader's death:\n{tail(follower)}")
        return took
    finally:
        kill(leader)
        kill(follower)


async def phase_dist_pp(cfg_model, params, card: str, logs: str, *, model: str,
                        served: str, ref: dict | None = None) -> dict:
    """13b/13c: a pp=2 group over two processes (one stage each) against
    the single-process pp=1 engine on the same weights: phase 5's four
    requests (the lane-group interleave) and one single-lane request (the
    broadcast ring), tokens equal up to reported near-ties; K1 tp x L/pp a
    ring step and pp x tp x L/pp an interleave step in each process, and
    with the grouped FFN K2 the same per layer stack and per prefill, all on
    wgmma. ``ref`` takes pp=1's runs from phase 11."""
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
    from llm_d_inference_scheduler_tpu_torch.ops import grouped_moe, paged_attention

    tag = f"dist {served} pp2"
    bodies = serve_prompts(served)
    single = [{**bodies[0], "prompt": bodies[0]["prompt"][-300:]}]
    extra = ("--served-model-name", served)
    if ref is None:
        cfg = parallel_config(model, DIST_DEVICE, extra=extra)
        srv = EngineServer(cfg, engine=TorchEngine(cfg, params=params))
        await srv.start()
        try:
            ref = {"ref": await serve_counted(srv, bodies),
                   "ref-single": await serve_counted(srv, single, ids="s")}
        finally:
            await srv.stop()
        del srv
        gc.collect()
        if DIST_DEVICE == "cuda":
            torch.cuda.empty_cache()
    g = DistGroup(model, params, tag, logs, pp=2, extra=extra)
    grouped = g.engine.mcfg.moe_impl == "grouped"
    log(f"[{tag}] {card}: backend {g.backend}; the group joined in {g.join_s:.1f}s; "
        f"moe {g.engine.mcfg.moe_impl if g.engine.mcfg.n_experts else 'none'}")
    await g.start()
    try:
        checks = await asyncio.to_thread(g.check_kernels)
        runs = {"pp": await serve_counted(g.server, bodies, group=True),
                "pp-single": await serve_counted(g.server, single, ids="s", group=True)}
        tok = g.engine.tokenizer
        greedy = [i for i, b in enumerate(bodies) if b["temperature"] == 0]
        prompts = [tok.encode(bodies[i]["prompt"]) for i in greedy]
        rel = await asyncio.to_thread(logits_gate, tag, g.engine, params, g.engine.mcfg,
                                      prompts[0])
    finally:
        await g.stop()
    L = cfg_model.n_layers // 2
    launches = {}
    for key, run in runs.items():
        sched = run["schedules"]
        want_k1 = L * (sched["ring"] + 2 * sched["interleave"])
        k1 = [p[paged_attention.KERNEL] for p in run["by_process"]]
        log(f"[{tag}] {'4 requests' if key == 'pp' else 'one request'}: decode steps "
            f"{run['steps']} ({sched}), K1 by process {k1} (L/pp x (ring + pp x "
            f"interleave) = {want_k1} each), launches by process {run['by_process']}, "
            f"K2 by path (leader) {run['paths']}")
        if run["steps"] <= 0 or k1 != [want_k1] * DIST_PROCS:
            fail(f"{tag}: K1 did not launch as the pp schedules predict in each process")
        if grouped:
            n_pre = len(bodies) if key == "pp" else 1
            want_k2 = L * (n_pre + sched["ring"] + 2 * sched["interleave"])
            k2 = [p[grouped_moe.KERNEL] for p in run["by_process"]]
            if k2 != [want_k2] * DIST_PROCS or run["paths"].get("wgmma") != want_k2:
                fail(f"{tag}: K2 launched {k2} ({run['paths']} on the leader), not L/pp "
                     f"per prefill and per layer stack of each step ({want_k2}) in each "
                     "process, all on wgmma")
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
    if runs["pp"]["schedules"]["interleave"] <= 0 or runs["pp-single"]["schedules"]["interleave"]:
        fail(f"{tag}: the schedules were not the interleave (4 lanes) and the ring (1 lane)")
    log(f"[{tag}] pp=1's schedules: 4 requests {ref['ref']['steps']} steps, one request "
        f"{ref['ref-single']['steps']} (the group's batches follow its own timing)")
    ids = [f"r{i}" for i in greedy] + ["s0"]
    # The single lane decodes alone in both (bucket 1 each step): it must
    # agree up to token near-ties. The four requests' batches follow each
    # engine's timing; for the MoE model a routing near-tie excuses a flip.
    flips = near_tie_flips(tag, params, g.engine.mcfg, [tok.encode(single[0]["prompt"])],
                           ref["ref-single"]["tokens"], runs["pp-single"]["tokens"], ["s0"])
    flips += near_tie_flips(tag, params, g.engine.mcfg, prompts, ref["ref"]["tokens"],
                            runs["pp"]["tokens"], ids[:-1],
                            moe_route=bool(g.engine.mcfg.n_experts))
    log(f"[{tag}] greedy tokens equal to the pp=1 engine's for {len(ids) - len(flips)} "
        f"of {len(ids)} requests; near-tie flips: {flips or 'none'}")
    log(f"[{tag}] {card}: {runs['pp']['step_ms']:.2f} ms a decode step over the 4 "
        f"requests, single lane {runs['pp-single']['step_ms']:.2f} ms (two processes on "
        f"one card: not a pipeline speed); pp=1 {ref['ref']['step_ms']:.2f} ms, single "
        f"lane {ref['ref-single']['step_ms']:.2f} ms")
    return {"launches": launches, "checks": checks, "rel": rel,
            "step_ms": runs["pp"]["step_ms"], "single_ms": runs["pp-single"]["step_ms"]}


def mono_tokens(params, prompt: str, model: str = MODEL) -> list[int]:
    """Greedy PD_TOKENS of ``prompt`` from a single-process tp=1 engine."""
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer

    async def run():
        cfg = parallel_config(model, DIST_DEVICE)
        srv = EngineServer(cfg, engine=TorchEngine(cfg, params=params))
        toks, _ = tap_engine(srv.engine)
        await srv.start()
        try:
            await asyncio.to_thread(http_post, srv.port, {
                "prompt": prompt, "max_tokens": PD_TOKENS, "temperature": 0,
                "ignore_eos": True, "request_id": "mono"})
        finally:
            await srv.stop()
        return toks["mono"]

    return asyncio.run(run())


async def phase_device_wire(params, card: str, logs: str, mono: list[int],
                            model: str = MODEL) -> dict:
    """13e: the device wire between a prefill engine and a decode engine,
    first with the prefill engine in a process of its own (the server CLI:
    the CUDA IPC pull), then both in this process (the direct copy). Each
    time the pull route is ``device``, the imported pages equal the bytes
    the exporter's /kv host route serves for the same export, bitwise, and
    the greedy tokens equal a monolithic engine's. Returns the decode
    engine's K1 launches over both handoffs."""
    from llm_d_inference_scheduler_tpu_torch.engine import kv_wire
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer, parse_config
    from llm_d_inference_scheduler_tpu_torch.ops import paged_attention

    # The prefill server in a process of its own takes kv_transfer "auto",
    # the device wire on the card; the engines here ask for it outright.
    argv = parallel_argv(model, DIST_DEVICE)
    prompt = pd_prompts()["serial"]
    body = {"prompt": prompt, "max_tokens": PD_TOKENS, "temperature": 0, "ignore_eos": True}
    cfg = dataclasses.replace(parse_config(argv)[0], kv_transfer="device")
    dec = TorchEngine(cfg, params=params)
    imported: dict[str, torch.Tensor] = {}
    import_into = dec._import_into_slot

    def snapshot(idx, pi, blocks):
        import_into(idx, pi, blocks)
        ids = torch.tensor(blocks, device=dec.device)
        imported[pi.req.request_id] = torch.stack([dec.k_pages[:, ids], dec.v_pages[:, ids]])

    dec._import_into_slot = snapshot
    d_srv = EngineServer(cfg, engine=dec)
    d_tokens, _ = tap_engine(dec)
    await d_srv.start()
    k1 = 0
    res = {}
    try:
        for where in ("two processes", "one process"):
            if where == "two processes":
                port = free_port()
                pre_p = spawn_cli(argv[:argv.index("--port")] + ["--port", str(port)]
                                  + argv[argv.index("--port") + 2:],
                                  os.path.join(logs, "device_wire_prefill.log"))
                t0 = time.monotonic()
                while True:
                    try:
                        if health(port)[0] == 200:
                            break
                    except OSError:
                        pass
                    if time.monotonic() - t0 > 120 or pre_p.poll() is not None:
                        fail(f"13e: the prefill server never served:\n{tail(pre_p)}")
                    await asyncio.sleep(0.2)
                pre_srv = None
            else:
                pre_srv = EngineServer(cfg, engine=TorchEngine(cfg, params=params))
                await pre_srv.start()
                port = pre_srv.port
            try:
                rid = f"pd-{where[:3]}"
                r1 = await asyncio.to_thread(http_post, port, {
                    **body, "max_tokens": 1, "request_id": rid + "-pre",
                    "kv_transfer_params": {"do_remote_decode": True}})
                ktp = r1["json"]["kv_transfer_params"]
                if not ktp.get("kv_wire_device") or "transfer_address" in ktp:
                    fail(f"13e ({where}): the exporter advertised {sorted(ktp)}")
                # The /kv host route's bytes of the same export (GET only;
                # the device pull releases it), off the loop that serves it.
                def get_kv(path=f"/kv/{ktp['remote_request_id']}"):
                    with kv_wire.KvClient("127.0.0.1", port) as c:
                        return c.get(path)

                _, hdrs, payload = await asyncio.to_thread(get_kv)
                shape = json.loads(hdrs["x-kv-shape"])
                hk, hv = kv_wire.decode_kv(payload, kv_wire.dtype_from_name(hdrs["x-kv-dtype"]),
                                           tuple(shape))
                await asyncio.to_thread(dec.group_launches, True)
                r2 = await asyncio.to_thread(http_post, d_srv.port, {
                    **body, "request_id": rid, "kv_transfer_params": ktp})
                k1 += (await asyncio.to_thread(dec.group_launches))[0][paged_attention.KERNEL]
            finally:
                if pre_srv is not None:
                    await pre_srv.stop()
                else:
                    kill(pre_p)
            route = r2["headers"].get("x-kv-pull-route")
            n = int(ktp["remote_num_blocks"])
            got = imported.get(rid)
            same = (got is not None
                    and torch.equal(got[0][:, :n].cpu(), hk[:, :n])
                    and torch.equal(got[1][:, :n].cpu(), hv[:, :n]))
            pos = ktp["remote_seq_len"]
            flips = first_divergence(d_tokens[rid], mono)
            log(f"[13e] device wire, {where}: route {route}, {r2['headers'].get('x-kv-pull-bytes')} "
                f"bytes in {r2['headers'].get('x-kv-pull-ms')} ms, imported pages (n={n} "
                f"blocks, {pos} positions) bitwise the /kv host route's: {same}; greedy tokens "
                f"{'equal to' if flips is None else f'leave at {flips}'} the monolithic engine's")
            if route != "device" or not same or flips is not None:
                fail(f"13e ({where}): route {route}, pages equal {same}, tokens divergence at "
                     f"{flips}")
            res[where] = float(r2["headers"].get("x-kv-pull-ms") or 0)
    finally:
        await d_srv.stop()
    return {"launches": k1, "pull_ms": res}


async def phase_dist_pd(params, cfg_model, card: str, logs: str, mono: list[int],
                        model: str = MODEL, wires: tuple[str, ...] = ("host", "device")) -> dict:
    """13f: a tp=2 two-process prefill group hands off to a tp=2
    two-process decode group, over the host shard wire and over the device
    wire: route ``shard-wire`` / ``device``; each process's imported pages
    equal, bitwise per shard, the shards its counterpart staged (pulled here
    over the same wire before the handoff, digests compared in place); the
    greedy tokens equal a monolithic engine's. Returns the decode groups' K1
    launches (summed) per wire."""
    from llm_d_inference_scheduler_tpu_torch.engine import kv_shards, kv_transfer, shard_wire
    from llm_d_inference_scheduler_tpu_torch.ops import paged_attention

    prompt = pd_prompts()["serial"]
    body = {"prompt": prompt, "max_tokens": PD_TOKENS, "temperature": 0, "ignore_eos": True}
    out = {}
    for wire in wires:
        tag = f"dist P/D tp2 {wire} wire"
        pre = DistGroup(model, params, f"{tag} prefill", logs, tp=2, wire=wire)
        dec = DistGroup(model, params, f"{tag} decode", logs, tp=2, wire=wire)
        blocks: dict = {}
        copy = dec.engine._copy_shards

        def tap(shards, b, shape, copy=copy, blocks=blocks):
            blocks["ids"] = list(b)
            copy(shards, b, shape)

        dec.engine._copy_shards = tap
        await pre.start()
        await dec.start()
        d_tokens, _ = tap_engine(dec.engine)
        try:
            r1 = await asyncio.to_thread(http_post, pre.server.port, {
                **body, "max_tokens": 1, "request_id": "f-pre",
                "kv_transfer_params": {"do_remote_decode": True}})
            ktp = r1["json"]["kv_transfer_params"]
            addrs = ktp.get(f"kv_wire_{wire}") or []
            if len(addrs) != DIST_PROCS or not all(addrs) or "transfer_shards" in ktp:
                fail(f"{tag}: the exporter group advertised {ktp}")
            seq = int(ktp["remote_seq_len"])
            staged = []   # each exporter process's shard digests, pulled here
            for addr in addrs:
                if wire == "host":
                    shards = shard_wire.pull_shards(addr, int(ktp["transfer_uuid"]))
                    staged.append([kv_shards.shard_digest(t, seq) for t in shards])
                else:
                    shards, done = kv_transfer.pull(addr, int(ktp["transfer_uuid"]))
                    staged.append([kv_shards.shard_digest(t, seq) for t in shards])
                    torch.cuda.synchronize()
                    done()
            await asyncio.to_thread(dec.engine.group_launches, True)
            r2 = await asyncio.to_thread(http_post, dec.server.port, {
                **body, "request_id": "f-dec", "kv_transfer_params": ktp})
            per = await asyncio.to_thread(dec.engine.group_launches)
            digests = await asyncio.to_thread(dec.engine.page_digests, blocks.get("ids", []), seq)
        finally:
            await dec.stop()
            await pre.stop()
        route = r2["headers"].get("x-kv-pull-route")
        want_route = "device" if wire == "device" else "shard-wire"
        same = staged == digests and all(len(d) == 2 for d in digests)
        # Two processes' tp=2 sums against one rank's: a flip passes only at
        # a near-tie of the reference's top-2 logits.
        flips = near_tie_flips(tag, params, cfg_model, [pre.engine.tokenizer.encode(prompt)],
                               {"f": mono}, {"f": d_tokens["f-dec"]}, ["f"])
        k1 = sum(p[paged_attention.KERNEL] for p in per)
        log(f"[13f] {tag}, {card}: backends {pre.backend}/{dec.backend}, route {route}, "
            f"{r2['headers'].get('x-kv-pull-bytes')} bytes in {r2['headers'].get('x-kv-pull-ms')} "
            f"ms; imported pages bitwise the staged shards in each process ({len(digests)} "
            f"processes x K, V): {same}; K1 by process {[p[paged_attention.KERNEL] for p in per]}; "
            f"greedy tokens against the monolithic engine's: {flips or 'equal'}")
        if route != want_route or not same:
            fail(f"{tag}: route {route} (want {want_route}), pages equal {same} "
                 f"({staged} vs {digests})")
        out[wire] = {"launches": k1, "pull_ms": float(r2["headers"].get("x-kv-pull-ms") or 0)}
    return out


def dist_follower(argv: list[str]) -> int:
    """``--dist-follower [--kv-wire WIRE] <server arguments>``: a group's
    follower for a model directory or with its ``kv_wire`` set: join the
    group, draw this process's ranks' weights from the seed (the full
    tensors one at a time, keeping its shards), build the engine and replay
    the leader's ops (``engine/multihost.py``)."""
    import logging

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llm_d_inference_scheduler_tpu_torch.engine import multihost
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import parse_config
    from llm_d_inference_scheduler_tpu_torch.models import llama
    from llm_d_inference_scheduler_tpu_torch.parallel import serve as par
    from llm_d_inference_scheduler_tpu_torch.utils.device import resolve_device

    logging.basicConfig(level=logging.INFO)
    wire = "auto"
    if argv[:1] == ["--kv-wire"]:
        wire, argv = argv[1], argv[2:]
    cfg = dataclasses.replace(parse_config(argv)[0], kv_wire=wire)
    names = cfg.rank_devices()
    comm = multihost.maybe_init_distributed(cfg, [resolve_device(d) for d in names])
    layout = par.make_serve_layout(names, cfg.tp_size, cfg.ep_size, cfg.pp_size, comm)
    mcfg = cfg.model_config
    dev = layout.first_device
    params = llama.init_params(mcfg, dev, cfg.dtype or mcfg.dtype,
                               torch.Generator(device=dev).manual_seed(cfg.seed),
                               layout=layout)
    engine = TorchEngine(cfg, params=params, comm=comm)
    try:
        multihost.run_follower(engine)
    finally:
        engine.close()
    return 0


# ---- phase 14: training ----------------------------------------------------------

TRAIN_LAYERS = 2          # of llama3-8b's 32 (embed and head are 1.05 B of 1.49 B)
TRAIN_BATCH = (2, 2048)
TRAIN_STEPS = 10
TRAIN_LR = 1e-4           # optax.adamw's default in the JAX train step
SEQPAR_SP = (2, 4)
PIPE_LAYERS = 4           # pp=2 runs 2 a stage, pp=4 one
PIPE_SEQ = 256
# The ring and Ulysses outputs against causal_attention on the same inputs:
# f32 only sums in another order (online softmax, per-head-group batches);
# bf16 rounds the f32 result once, so two results may lie one bf16 step
# (2**-7 of values up to ~1.5 here) apart.
SEQPAR_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The GPipe logits against forward's: f32 at the JAX dryrun_pipeline bound
# (atol = rtol = 2e-3); bf16 within one bf16 step of the largest |logit|
# (the microbatches' rows run through the same kernels as the whole batch's).
PIPE_F32_TOL = 2e-3
# One bf16 train step at tp=2 x sp=2 and at dp=2 against tp=1 on the same
# weights and batch. The loss: the sums run in another order (relative
# 1e-4). The gradients: bf16 tensors whose partial sums round in another
# order, within 5e-2 of the tensor's largest |gradient| (a missing or
# doubled reduction is off by the gradient's own size). The update
# p_after - p_before: AdamW's first step moves an element by about lr
# against its gradient's sign, so where |gradient| is above that floor the
# update's sign (-1, 0 where the bf16 parameter does not move, +1) must be
# tp=1's, but for a share TRAIN_UPDATE_MISMATCH of the elements, in every
# tensor; and every tensor that tp=1's step moves must move.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL_TOL = 5e-2
TRAIN_UPDATE_MISMATCH = 1e-3


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at ``x`` (> 0)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def train_one_step(cfg, params, toks, n: int, **axes) -> dict:
    """One train step from ``params`` on a layout of ``n`` ranks on the
    card: its loss, gradients and parameter updates, as full tensors."""
    from llm_d_inference_scheduler_tpu_torch.models import llama
    from llm_d_inference_scheduler_tpu_torch.parallel import mesh, train

    layout = mesh.make_train_layout(["cuda"] * n, **axes)
    state = train.make_train_state(cfg, layout, lr=TRAIN_LR, params=params)
    loss = float(train.make_train_step(cfg, layout)(state, toks))
    before = llama.flat_params(params)
    return {"shape": layout.shape, "loss": loss, "grads": train.full_grads(cfg, state),
            "updates": {name: p.float() - before[name].float()
                        for name, p in train.full_params(cfg, state).items()}}


def compare_steps(tag: str, got: dict, ref: dict, card: str) -> dict:
    """The worst deviations of one step from the reference step; fails
    beyond the stated tolerances."""
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_rel, mismatch, still = 0.0, 0.0, []
    for name, g_ref in ref["grads"].items():
        scale = float(g_ref.abs().max()) or 1.0
        grad_rel = max(grad_rel, float((got["grads"][name] - g_ref).abs().max()) / scale)
        sure = g_ref.abs() > TRAIN_GRAD_REL_TOL * scale
        differ = got["updates"][name].sign() != ref["updates"][name].sign()
        mismatch = max(mismatch, float((differ & sure).sum()) / max(int(sure.sum()), 1))
        if ref["updates"][name].any() and not got["updates"][name].any():
            still.append(name)
    out = {"loss": got["loss"], "loss_rel_err": loss_rel, "grad_rel_err": grad_rel,
           "update_sign_mismatch": mismatch, "unmoved": still}
    log(f"[train] 14b {tag} {got['shape']}, {card}: loss {got['loss']:.6f} against "
        f"{ref['loss']:.6f} (rel {loss_rel:.3e}), max |grad diff| / max |grad| "
        f"{grad_rel:.3e}, update signs differing from tp=1's where |grad| > "
        f"{TRAIN_GRAD_REL_TOL} max |grad|: worst tensor {mismatch:.3e}, tensors tp=1 "
        f"moves that did not move: {still}")
    if not loss_rel <= TRAIN_LOSS_RTOL or not grad_rel <= TRAIN_GRAD_REL_TOL \
            or not mismatch <= TRAIN_UPDATE_MISMATCH or still:
        fail(f"train: the {tag} step differs from the tp=1 step: {out}")
    return out


def check_reference_update(ref: dict, card: str) -> dict:
    """tp=1's own update: where it moves an element with |grad| above the
    floor, against the gradient's sign; the share of those elements it
    moves, and the tensors it leaves as they were (bf16 spacing above lr)."""
    moved, sure_n, wrong, still = 0, 0, 0, []
    for name, g in ref["grads"].items():
        upd = ref["updates"][name]
        sure = g.abs() > TRAIN_GRAD_REL_TOL * (float(g.abs().max()) or 1.0)
        nz = (upd != 0) & sure
        moved += int(nz.sum())
        sure_n += int(sure.sum())
        wrong += int((nz & (upd.sign() == g.float().sign())).sum())
        if not upd.any():
            still.append(name)
    out = {"moved_share": moved / max(sure_n, 1), "against_grad_sign": wrong,
           "unmoved": still}
    log(f"[train] 14b tp=1 update, {card}: {moved / max(sure_n, 1):.3f} of the elements "
        f"with |grad| above the floor moved, {wrong} of them with the gradient's sign; "
        f"tensors left as they were (bf16 spacing above lr): {still}")
    if wrong or not moved:
        fail(f"train: the tp=1 AdamW step does not move against the gradient: {out}")
    return out


def check_seqpar(tag: str, got: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    err = float((got.float() - ref.float()).abs().max())
    if not err <= tol:
        fail(f"train: {tag} differs from causal_attention by {err} (tol {tol})")
    return err


def phase_train(card: str) -> dict:
    """Phase 14, the counterpart of ``dryrun_multichip``'s train and
    pipeline parts: 14a AdamW steps at llama3-8b width (2 of 32 layers, bf16
    as JAX trains) on one seeded batch; 14b one step at tp=2 x sp=2 and one
    at dp=2 (every rank on the one card) against the tp=1 step; 14c ring
    attention and Ulysses against causal_attention at llama3-8b's heads
    (and ring's input gradients); 14d the GPipe forward at pp=2 (M=2) and
    pp=4 (M=4) against forward. No K1, K2 or K3 launch; no K4 launch in the
    train steps (14a, 14b)."""
    from llm_d_inference_scheduler_tpu_torch import ops
    from llm_d_inference_scheduler_tpu_torch.models import llama
    from llm_d_inference_scheduler_tpu_torch.models.configs import get_config
    from llm_d_inference_scheduler_tpu_torch.ops import fused_norm
    from llm_d_inference_scheduler_tpu_torch.ops.attention import causal_attention
    from llm_d_inference_scheduler_tpu_torch.parallel import pipeline
    from llm_d_inference_scheduler_tpu_torch.parallel.ring_attention import ring_attention
    from llm_d_inference_scheduler_tpu_torch.parallel.ulysses import ulysses_attention

    t_phase = time.monotonic()
    ops.reset_kernel_launches()
    cfg = dataclasses.replace(get_config(MODEL), n_layers=TRAIN_LAYERS)
    out: dict = {}

    # 14a: N AdamW steps on one fixed batch.
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, "cuda", generator=gen)
    n_params = sum(t.numel() for t in llama.flat_params(params).values())
    toks = torch.randint(1, cfg.vocab_size, TRAIN_BATCH, generator=gen, device="cuda",
                         dtype=torch.int32)
    steps_ = train_steps(cfg, params, toks)
    losses, walls = steps_["losses"], steps_["walls_ms"]
    wall = sorted(walls[1:])[len(walls[1:]) // 2]
    tok_s = TRAIN_BATCH[0] * TRAIN_BATCH[1] / (wall / 1e3)
    peak = steps_["peak_gb"]
    log(f"[train] 14a {cfg.name} {cfg.n_layers}l ({n_params / 1e9:.2f} B parameters, "
        f"{cfg.dtype}), batch {list(TRAIN_BATCH)}, AdamW lr {TRAIN_LR}, {card}: losses "
        f"{[round(x, 4) for x in losses]}")
    log(f"[train] 14a {card}: step wall {[round(w, 2) for w in walls]} ms (first step "
        f"included; median of the rest {wall:.2f} ms), {tok_s:.0f} tokens/s, peak device "
        f"memory {peak} GB")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    out["14a"] = {"losses": losses, "walls_ms": walls, "step_ms": wall,
                  "tokens_per_s": tok_s, "peak_gb": peak, "params_b": n_params / 1e9}

    # 14b: the same weights and batch at tp=2 x sp=2 and at dp=2.
    t0 = time.monotonic()
    ref = train_one_step(cfg, params, toks, 1, tp=1, sp=1)
    out["14b"] = {"tp1_loss": ref["loss"], "tp1_update": check_reference_update(ref, card)}
    for tag, n, axes in (("tp2 x sp2", 4, dict(tp=2, sp=2)), ("dp2", 2, dict(tp=1, sp=1))):
        out["14b"][tag] = compare_steps(tag, train_one_step(cfg, params, toks, n, **axes),
                                        ref, card)
    del ref, params
    gc.collect()
    log(f"[train] 14b in {time.monotonic() - t0:.1f}s")
    # The train steps need every norm's backward: K4 must not have run.
    if ops.kernel_launches()[fused_norm.KERNEL]:
        fail(f"train: a train step launched K4: {ops.kernel_launches()}")

    # 14c: ring attention and Ulysses at llama3-8b's heads against
    # causal_attention, and ring's input gradients (f32).
    t0 = time.monotonic()
    B, S = TRAIN_BATCH
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    errs: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda").to(dtype)
                   for h in (H, Hkv, Hkv))
        ref_attn = causal_attention(q, k, v)
        for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
            for sp in SEQPAR_SP:
                errs[f"{name} sp{sp} {str(dtype)[6:]}"] = check_seqpar(
                    f"{name} sp={sp} {dtype}", fn(q, k, v, n_shards=sp,
                                                  devices=["cuda"] * sp),
                    ref_attn, SEQPAR_TOL[dtype])
        del q, k, v, ref_attn
    arrays = [torch.randn(B, S, h, D, generator=gen, device="cuda") for h in (H, Hkv, Hkv)]
    upstream = torch.randn(B, S, H, D, generator=gen, device="cuda")
    grads = {}
    for name, fn in [("causal", causal_attention)] + [
            (f"ring sp{sp}", lambda q, k, v, sp=sp: ring_attention(
                q, k, v, n_shards=sp, devices=["cuda"] * sp)) for sp in SEQPAR_SP]:
        leaves = [a.clone().requires_grad_(True) for a in arrays]
        (fn(*leaves) * upstream).sum().backward()
        grads[name] = [t.grad for t in leaves]
    for sp in SEQPAR_SP:
        errs[f"ring sp{sp} input grads f32"] = max(
            check_seqpar(f"ring sp={sp} d{'qkv'[i]}", g, want, SEQPAR_TOL[torch.float32])
            for i, (g, want) in enumerate(zip(grads[f"ring sp{sp}"], grads["causal"])))
    del arrays, upstream, grads
    torch.cuda.synchronize()
    log(f"[train] 14c {card}: H/Hkv {H}/{Hkv}, D {D}, [B, S] {[B, S]}; max |diff| "
        f"against causal_attention {errs} (tol f32 {SEQPAR_TOL[torch.float32]}, bf16 "
        f"{SEQPAR_TOL[torch.bfloat16]}) in {time.monotonic() - t0:.1f}s")
    out["14c"] = errs

    # 14d: the GPipe forward against forward, f32 and bf16.
    t0 = time.monotonic()
    pcfg = dataclasses.replace(cfg, n_layers=PIPE_LAYERS)
    full = llama.init_params(pcfg, "cuda", "float32", generator=gen)
    pipe: dict = {}
    for dtype in ("float32", "bfloat16"):
        p = full if dtype == "float32" else {
            **{k: t.to(torch.bfloat16) for k, t in full.items() if k != "layers"},
            "layers": {k: t.to(torch.bfloat16) for k, t in full["layers"].items()}}
        for pp, M in ((2, 2), (4, 4)):
            ptoks = torch.randint(1, pcfg.vocab_size, (2 * M, PIPE_SEQ), generator=gen,
                                  device="cuda", dtype=torch.int32)
            with torch.no_grad():
                want, _ = llama.forward(p, pcfg, ptoks)
                layout = pipeline.make_pp_layout(["cuda"] * pp)
                got = pipeline.make_pp_forward(pcfg, layout, M)(
                    pipeline.shard_params_pp(p, pcfg, layout), ptoks)
            err = float((got - want).abs().max())
            top = float(want.abs().max())
            tol = PIPE_F32_TOL if dtype == "float32" else bf16_step(top)
            pipe[f"pp{pp} M{M} {dtype}"] = {"max_abs_err": err, "max_abs_logit": top,
                                            "tol": tol}
            ok = (torch.allclose(got, want, atol=tol, rtol=tol)
                  if dtype == "float32" else err <= tol)
            if not ok:
                fail(f"train: GPipe pp={pp} M={M} {dtype} logits differ from forward's "
                     f"by {err} (max |logit| {top}, tol {tol})")
            del want, got
        del p
    del full
    gc.collect()
    log(f"[train] 14d {card}: GPipe ({PIPE_LAYERS} layers, [2M, {PIPE_SEQ}] tokens) "
        f"against forward {pipe} (f32 atol=rtol {PIPE_F32_TOL}, bf16 one bf16 step "
        f"of max |logit|) in {time.monotonic() - t0:.1f}s")
    out["14d"] = pipe

    launches = ops.kernel_launches()
    log(f"[train] {card}: phase 14 in {time.monotonic() - t_phase:.1f}s; kernel "
        f"launches {launches} (the train path runs no TPU-kernel counterpart; K4 only "
        f"in 14d's forwards, which need no gradient)")
    if any(n for name, n in launches.items() if not name.startswith(fused_norm.KERNEL)):
        fail(f"train: the train path launched K1, K2 or K3: {launches}")
    out["launches"] = launches
    return out


def train_steps(cfg, params, toks) -> dict:
    """TRAIN_STEPS AdamW steps at tp=1 from ``params`` on ``toks``: the
    losses, each step's wall (ms, ending in a sync) and the peak device
    memory."""
    from llm_d_inference_scheduler_tpu_torch.parallel import mesh, train

    layout = mesh.make_train_layout(["cuda"], tp=1, sp=1)
    torch.cuda.reset_peak_memory_stats()
    state = train.make_train_state(cfg, layout, lr=TRAIN_LR, params=params)
    step = train.make_train_step(cfg, layout)
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(state, toks)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak = round(torch.cuda.max_memory_allocated() / 1e9, 2)
    del state
    gc.collect()
    return {"losses": losses, "walls_ms": walls, "peak_gb": peak}


def main() -> int:
    if sys.argv[1:2] == ["--dist-follower"]:
        return dist_follower(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llm_d_inference_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
    from llm_d_inference_scheduler_tpu_torch.models import llama
    from llm_d_inference_scheduler_tpu_torch.models.configs import get_config
    from llm_d_inference_scheduler_tpu_torch.ops import (
        _build,
        fused_norm,
        grouped_moe,
        paged_attention,
        prefill_attention,
    )

    t_start = time.monotonic()
    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build every kernel of the paths (one nvcc per source, in parallel)
    t0 = time.monotonic()
    kernels = [paged_attention.KERNEL, grouped_moe.KERNEL, prefill_attention.KERNEL,
               fused_norm.KERNEL]
    _build.build(kernels)
    log(f"[build] {', '.join(kernels)} built in {time.monotonic() - t0:.1f}s")
    for name in kernels:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")

    # 3. kernels against their plain versions
    tok = ByteTokenizer(128_256)
    serve_lens = [len(tok.encode(b["prompt"])) + 16 for b in serve_prompts()]
    pd_len = len(tok.encode(pd_prompts()["serial"])) + PD_TOKENS // 2
    k1_by_shape = phase_kernels(serve_lens, pd_len)
    k1 = k1_by_shape[32, 8, 4]

    # 4. full-width decode step
    cfg = get_config(MODEL)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.monotonic()
    params = llama.init_params(cfg, "cuda", "bfloat16", gen)
    torch.cuda.synchronize()
    log(f"[decode] random llama3-8b weights drawn on the card in "
        f"{time.monotonic() - t0:.1f}s")
    with torch.no_grad():
        phase_decode(cfg, params)

    # 5. serve: KV events off, on with a subscriber (the main path, with the
    # router-facing surface), on, off (decode tok/s in turns); then the
    # eviction events
    dense, rates = serve_in_turns(cfg, params, card, "serve")
    dense_launches = dense["launches"]
    log(f"[serve] {MODEL}, {card}: decode tok/s with KV events on and a "
        f"subscriber {rates[True]}, with kv_events_port=0 {rates[False]}")
    asyncio.run(check_eviction(params, card, tag="serve"))
    # 5b. P/D handoff between two engines sharing the weights
    pd_launches = asyncio.run(phase_pd(cfg, params, card))
    # 5c. E/P/D: two encoders and the P/D pair, on the same weights
    epd_launches = asyncio.run(phase_epd(cfg, params, card))
    # llama3-8b leaves the card before Mixtral is drawn (16 + 47 GB).
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # 6. K2 against its plain version at full Mixtral width
    moe_cfg = dataclasses.replace(get_config(MOE_MODEL), n_layers=MOE_LAYERS)
    with torch.no_grad():
        k2, k2_pp = phase_moe_kernels(moe_cfg)
    gc.collect()
    torch.cuda.empty_cache()

    # 6b. K3 against its plain version at the longprompt cell's windows
    with torch.no_grad():
        k3 = phase_prefill_kernels()
    gc.collect()
    torch.cuda.empty_cache()

    # 6c. K4 against the eager norm and RoPE chain at the cells' windows
    with torch.no_grad():
        k4 = phase_norm_kernels()
    gc.collect()
    torch.cuda.empty_cache()

    # 7. Mixtral (16 layers) decode step, grouped against dense
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.monotonic()
    params = llama.init_params(moe_cfg, "cuda", "bfloat16", gen)
    torch.cuda.synchronize()
    n_bytes = sum(t.nbytes for t in (params["embed"], params["final_norm"],
                                     params["lm_head"], *params["layers"].values()))
    log(f"[moe-decode] random {MOE_MODEL} weights, {MOE_LAYERS} of 32 layers "
        f"({n_bytes / 1e9:.1f} GB), drawn on the card in {time.monotonic() - t0:.1f}s")
    with torch.no_grad():
        phase_moe_decode(moe_cfg, params)
    gc.collect()
    torch.cuda.empty_cache()

    # 8. serve Mixtral (16 layers) with the grouped MoE FFN, from a
    # model_config.json the port's directory lookup reads
    with tempfile.TemporaryDirectory() as model_dir:
        with open(os.path.join(model_dir, "model_config.json"), "w") as f:
            json.dump(dataclasses.asdict(moe_cfg), f)
        moe_kw = dict(model=model_dir, served=MOE_SERVED, grouped_moe=True)
        moe, rates = serve_in_turns(
            moe_cfg, params, card, "moe-serve",
            kernels=(paged_attention.KERNEL, grouped_moe.KERNEL), **moe_kw)
        log(f"[moe-serve] {MOE_SERVED}, {card}: decode tok/s with KV events on "
            f"and a subscriber {rates[True]}, with kv_events_port=0 {rates[False]}")
        asyncio.run(check_eviction(params, card, tag="moe-serve", **moe_kw))
        check_moe_embed_dense(moe["surface"], params, model_dir, card)
        windows = asyncio.run(check_prefill_windows(params, model_dir, moe_cfg.n_layers, card))
    moe_launches, moe_paths = moe["launches"], moe["paths"]
    moe_embed = moe["surface"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # 8c. one Qwen3-32B prompt through the longprompt cell's prefill windows
    qwen_windows = phase_qwen3_windows(card)
    # One entry per kernel and path, each path's launches from its own run.
    entries = [{**k1, "path": f"{MODEL} serve",
                "launches": dense_launches[paged_attention.KERNEL]},
               {**k1, "path": f"{MODEL} P/D decode", "launches": pd_launches},
               {**k1, "path": f"{MODEL} E/P/D decode", "launches": epd_launches},
               {**k1, "path": f"{MOE_SERVED} serve",
                "launches": moe_launches[paged_attention.KERNEL]},
               {**k2, "path": f"{MOE_SERVED} serve",
                "launches": moe_launches[grouped_moe.KERNEL],
                "launches_by_path": moe_paths},
               {**k2, "path": f"{MOE_SERVED} embeddings",
                "launches": moe_embed["launches"][grouped_moe.KERNEL],
                "launches_by_path": moe_embed["paths"]}]
    K3 = prefill_attention.KERNEL
    k3_by_path = lambda counts: {p: counts[f"{K3}.{p}"] for p in ("wgmma", "simt")}
    entries += [{**k3, "path": f"{MODEL} serve", "launches": dense_launches[K3],
                 "launches_by_path": k3_by_path(dense_launches)},
                {**k3, "path": f"{MOE_SERVED} serve", "launches": moe_launches[K3],
                 "launches_by_path": k3_by_path(moe_launches)},
                {**k3, "path": f"{MOE_SERVED} embeddings",
                 "launches": moe_embed["launches"][K3],
                 "launches_by_path": k3_by_path(moe_embed["launches"])},
                {**k3, "path": f"{MOE_SERVED} prefill windows (4000 tokens, 4 x 1024)",
                 "launches": windows["launches"]},
                {**k3, "path": f"{QWEN3} prefill windows (2048 tokens, 2 x 1024)",
                 "launches": qwen_windows["launches"]}]
    K4 = fused_norm.KERNEL
    k4_by_path = lambda counts: {p: counts[f"{K4}.{p}"] for p in fused_norm.path_launches}
    entries += [{**k4, "path": f"{MODEL} serve", "launches": dense_launches[K4],
                 "launches_by_path": k4_by_path(dense_launches)},
                {**k4, "path": f"{MOE_SERVED} serve", "launches": moe_launches[K4],
                 "launches_by_path": k4_by_path(moe_launches)},
                {**k4, "path": f"{MOE_SERVED} prefill windows (4000 tokens, 4 x 1024)",
                 "launches": windows["k4_launches"]},
                {**k4, "path": f"{QWEN3} prefill windows (2048 tokens, 2 x 1024)",
                 "launches": qwen_windows["k4_launches"]}]
    gc.collect()
    torch.cuda.empty_cache()

    # 9. converted HF checkpoints: written from a seed, converted by the
    # port's CLI, served from disk with batched prefill
    check_orbax_refused()
    for family in HF_CONFIGS:
        entries += asyncio.run(serve_checkpoint(family, card, k1, k2))
    # 10. tensor- and expert-parallel serving on the one card: llama3-8b
    # with tp=2 (phase 5's requests against tp=1, then a P/D handoff into a
    # tp=1 engine), 10b TLS and chaos on a tp=2 engine; 11. llama3-8b with
    # pp=2 on the same weights (phase 5's requests and a single lane against
    # pp=1, P/D both ways with a pp=2 engine). Weights from phases 4 and 7's
    # seed; the sharded and staged engines' shards are views of them.
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, "cuda", "bfloat16", gen)
    tp_launches, tp_pd_launches = asyncio.run(phase_tp(cfg, params, card))
    asyncio.run(phase_tls_chaos(params, card))
    pp_llama = asyncio.run(phase_pp(cfg, params, card, model=MODEL, served=MODEL, pp=PP))
    pp_pd_launches = asyncio.run(phase_pp_pd(cfg, params, card))
    # 13. multi-process groups (followers from the server CLI) and the KV
    # wires, on the same weights: 13a tp=2 over two processes, 13d the
    # drills, 13e the device wire, 13f P/D between two tp=2 groups.
    logs = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    t13 = time.monotonic()
    dist_tp = asyncio.run(phase_dist_tp(cfg, params, card, logs))
    drill_s = asyncio.run(drill_leader_lost(logs))
    mono_pd = mono_tokens(params, pd_prompts()["serial"])
    dev_wire = asyncio.run(phase_device_wire(params, card, logs, mono_pd))
    dist_pd = asyncio.run(phase_dist_pd(params, cfg, card, logs, mono_pd))
    t13 = time.monotonic() - t13
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # 11. Llama-3-70B at full width, 16 of 80 layers: pp=4, then pp=2 x tp=2,
    # each against pp=1 on one set of weights.
    cfg70 = dataclasses.replace(get_config(LLAMA70B), n_layers=LLAMA70B_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.monotonic()
    params = llama.init_params(cfg70, "cuda", "bfloat16", gen)
    torch.cuda.synchronize()
    n_bytes = sum(t.nbytes for t in llama.flat_params(params).values())
    log(f"[pp] random {LLAMA70B} weights, {LLAMA70B_LAYERS} of 80 layers "
        f"({n_bytes / 1e9:.1f} GB), drawn on the card in {time.monotonic() - t0:.1f}s")
    with tempfile.TemporaryDirectory() as model_dir:
        with open(os.path.join(model_dir, "model_config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg70), f)
        pp_70b, ref = {}, None
        for pp, tp in ((4, 1), (2, 2)):
            pp_70b[pp, tp] = asyncio.run(phase_pp(cfg70, params, card, model=model_dir,
                                                  served=LLAMA70B_SERVED, pp=pp, tp=tp,
                                                  ref=ref))
            ref = pp_70b[pp, tp]["ref"]
        # 13b: pp=2 over two processes, one stage each, against pp=1.
        t0 = time.monotonic()
        dist_70b = asyncio.run(phase_dist_pp(cfg70, params, card, logs, model=model_dir,
                                             served=LLAMA70B_SERVED, ref=ref))
        t13 += time.monotonic() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # 10 and 11 on Mixtral (16 layers): ep=2 dense against tp=1 dense, then
    # pp=2 with the grouped FFN against pp=1 grouped and pp=2 x ep=2 dense
    # against pp=1 dense.
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(moe_cfg, "cuda", "bfloat16", gen)
    with tempfile.TemporaryDirectory() as model_dir:
        with open(os.path.join(model_dir, "model_config.json"), "w") as f:
            json.dump(dataclasses.asdict(moe_cfg), f)
        ep_launches = asyncio.run(phase_ep(moe_cfg, params, card, model=model_dir,
                                           served=MOE_SERVED))
        pp_moe = asyncio.run(phase_pp(moe_cfg, params, card, model=model_dir,
                                      served=MOE_SERVED, pp=PP, grouped=True))
        pp_moe_ep = asyncio.run(phase_pp(moe_cfg, params, card, model=model_dir,
                                         served=MOE_SERVED, pp=PP, ep=EP))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # 13c: Mixtral (8 of 32 layers: each process draws a stacked tensor
    # whole) with pp=2 over two processes, the grouped FFN selected by the
    # model_config.json (moe_impl "grouped", as the JAX configs select it),
    # against pp=1 grouped.
    t0 = time.monotonic()
    moe8 = dataclasses.replace(get_config(MOE_MODEL), n_layers=MOE_DIST_LAYERS,
                               moe_impl="grouped")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(moe8, "cuda", "bfloat16", gen)
    with tempfile.TemporaryDirectory() as model_dir:
        with open(os.path.join(model_dir, "model_config.json"), "w") as f:
            json.dump(dataclasses.asdict(moe8), f)
        dist_moe = asyncio.run(phase_dist_pp(moe8, params, card, logs, model=model_dir,
                                             served=MOE_DIST_SERVED))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t13 += time.monotonic() - t0
    # 12. the CPU simulator from the parser: no kernel.
    asyncio.run(phase_sim(card))
    # 14. training: AdamW steps at llama3-8b width, tp x sp and dp steps
    # against tp=1, ring attention and Ulysses, the GPipe forward. Phase 14
    # resets the peak-memory counter for its own reading.
    serve_peak = torch.cuda.max_memory_allocated()
    train = phase_train(card)
    K1 = paged_attention.KERNEL
    # Each pp path's K1 entry is timed at the lanes it mostly launches at
    # (K1_TIMED); its launches by shape are in the phase's log lines.
    entries += [{**k1_by_shape[32 // TP, 8 // TP, 4], "path": f"{MODEL} tp{TP} serve",
                 "launches": tp_launches},
                {**k1, "path": f"{MODEL} tp{TP} P/D decode (tp=1)",
                 "launches": tp_pd_launches},
                {**k1, "path": f"{MOE_SERVED} ep{EP} serve", "launches": ep_launches},
                {**k1_by_shape[32, 8, 2], "path": f"{MODEL} pp{PP} serve",
                 "launches": pp_llama["launches"][K1]},
                {**k1_by_shape["pd"], "path": f"{MODEL} pp{PP} P/D decode",
                 "launches": pp_pd_launches},
                {**k1_by_shape[64, 8, 1], "path": f"{LLAMA70B_SERVED} pp4 serve",
                 "launches": pp_70b[4, 1]["launches"][K1]},
                {**k1_by_shape[32, 4, 2], "path": f"{LLAMA70B_SERVED} pp2tp2 serve",
                 "launches": pp_70b[2, 2]["launches"][K1]},
                {**k1_by_shape[32, 8, 2], "path": f"{MOE_SERVED} pp{PP} serve",
                 "launches": pp_moe["launches"][K1]},
                {**k2_pp, "path": f"{MOE_SERVED} pp{PP} serve",
                 "launches": pp_moe["launches"][grouped_moe.KERNEL],
                 "launches_by_path": pp_moe["paths"]},
                {**k1_by_shape[32, 8, 2], "path": f"{MOE_SERVED} pp{PP}ep{EP} serve",
                 "launches": pp_moe_ep["launches"][K1]}]
    # Phase 13's paths, launches summed over each group's processes.
    entries += [{**k1_by_shape[16, 4, 4], "path": f"{MODEL} dist tp2 serve",
                 "launches": dist_tp["launches"]},
                {**k1_by_shape[64, 8, 2], "path": f"{LLAMA70B_SERVED} dist pp2 serve",
                 "launches": dist_70b["launches"][K1]},
                {**k1_by_shape[32, 8, 2], "path": f"{MOE_DIST_SERVED} dist pp2 serve",
                 "launches": dist_moe["launches"][K1]},
                {**k2_pp, "path": f"{MOE_DIST_SERVED} dist pp2 serve",
                 "launches": dist_moe["launches"][grouped_moe.KERNEL]},
                {**k1_by_shape["pd"], "path": f"{MODEL} device-wire P/D decode",
                 "launches": dev_wire["launches"]},
                {**k1_by_shape[16, 4, 1], "path": f"{MODEL} dist tp2 P/D decode (host wire)",
                 "launches": dist_pd["host"]["launches"]},
                {**k1_by_shape[16, 4, 1], "path": f"{MODEL} dist tp2 P/D decode (device wire)",
                 "launches": dist_pd["device"]["launches"]}]
    log(f"[13] {card}: multi-process phases in {t13:.1f}s; backend {dist_tp['backend']}; "
        f"the follower-loss drill ended the request in {dist_tp['drill']['ended_s']:.2f}s, "
        f"the leader-loss drill ended the follower in {drill_s:.2f}s; device-wire pulls "
        f"{dev_wire['pull_ms']} ms, group P/D pulls "
        f"{ {w: r['pull_ms'] for w, r in dist_pd.items()} } ms")


    log(f"[done] launches on the main paths: llama3-8b serve {dense_launches}, "
        f"llama3-8b P/D decode {pd_launches}, llama3-8b E/P/D decode {epd_launches}, "
        f"{MOE_SERVED} serve {moe_launches} (grouped_moe_ffn by path {moe_paths}), "
        f"{MOE_SERVED} embeddings {moe_embed['launches']} (by path "
        f"{moe_embed['paths']}), {MODEL} tp{TP} serve {tp_launches}, its P/D decode "
        f"(tp=1) {tp_pd_launches}, {MOE_SERVED} ep{EP} serve {ep_launches}, pp paths "
        f"{[(e['path'], e['launches']) for e in entries if ' pp' in e['path']]}; "
        f"peak device memory allocated "
        f"{max(serve_peak, torch.cuda.max_memory_allocated()) / 1e9:.1f} GB")

    log(f"[done] training (phase 14): losses {train['14a']['losses']}, step "
        f"{train['14a']['step_ms']:.2f} ms, {train['14a']['tokens_per_s']:.0f} tokens/s, "
        f"kernel launches {train['launches']}; 14b {train['14b']}; 14c {train['14c']}; "
        f"14d {train['14d']}")
    log(f"[done] all phases passed in {time.monotonic() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
