"""Attention in plain PyTorch (port of ``llm_d_inference_scheduler_tpu/ops/attention.py``).

- ``causal_attention``: full-sequence causal attention for prefill. The JAX
  package runs it as plain XLA einsums outside any kernel, so plain matmuls
  are its faithful counterpart here.
- ``paged_decode_attention``: one-token decode against a paged KV cache in
  the gather formulation. It is the plain version of the hand-written CUDA
  kernel in ``ops/paged_attention.py`` (K1): the CPU path of that kernel's
  wrapper, and what ``chip_smoke.py`` holds the kernel against on the card.

Softmax math accumulates in f32 whatever the input dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
# causal_attention's f32 logits [B, H, S, T] beyond this many bytes are
# computed a few batch rows at a time: a batched prefill of four
# 2048-token prompts at 32 heads would need 2.1 GB for them at once.
LOGITS_BYTES_CAP = 1 << 30


def _repeat_kv(x: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[..., n_kv, d] -> [..., n_kv * q_per_kv, d] (GQA head broadcast)."""
    if q_per_kv == 1:
        return x
    return torch.repeat_interleave(x, q_per_kv, dim=-2)


def causal_attention(
    q: torch.Tensor,   # [B, S, H, D]
    k: torch.Tensor,   # [B, T, Hkv, D]
    v: torch.Tensor,   # [B, T, Hkv, D]
    *,
    q_positions: torch.Tensor | None = None,   # [B, S]
    kv_positions: torch.Tensor | None = None,  # [B, T]
    kv_valid: torch.Tensor | None = None,      # [B, T] bool padding mask
) -> torch.Tensor:
    """Causal attention; returns [B, S, H, D] in q's dtype. Without
    positions, q and kv are aligned with lower-triangular causality."""
    B, S, H, D = q.shape
    T = k.shape[1]
    rows = max(1, LOGITS_BYTES_CAP // (H * S * T * 4))
    if B > rows:
        def part(x, i):
            return None if x is None else x[i:i + rows]
        return torch.cat([causal_attention(
            q[i:i + rows], k[i:i + rows], v[i:i + rows],
            q_positions=part(q_positions, i), kv_positions=part(kv_positions, i),
            kv_valid=part(kv_valid, i)) for i in range(0, B, rows)])
    q_per_kv = H // k.shape[2]
    k = _repeat_kv(k, q_per_kv)
    v = _repeat_kv(v, q_per_kv)

    scale = 1.0 / (D ** 0.5)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if q_positions is None:
        q_positions = torch.arange(S, device=q.device).expand(B, S)
    if kv_positions is None:
        kv_positions = torch.arange(T, device=q.device).expand(B, T)
    mask = q_positions[:, None, :, None] >= kv_positions[:, None, None, :]
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,             # [B, H, D] one new token per sequence
    k_pages: torch.Tensor,       # [N_blocks, block, Hkv, D]
    v_pages: torch.Tensor,       # [N_blocks, block, Hkv, D]
    block_tables: torch.Tensor,  # [B, max_blocks] int32 physical block ids
    seq_lens: torch.Tensor,      # [B] int32 tokens valid (incl. current)
    cur_k: torch.Tensor | None = None,  # [B, Hkv, D] current token's K
    cur_v: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode-step attention over a paged KV cache; returns [B, H, D].

    With ``cur_k``/``cur_v`` the current token's KV is an extra, always
    visible attention column, and only the first ``seq_len - 1`` cached
    positions are read from the pages. Materialises the gathered
    [B, max_blocks*block] rows: the plain version, not the fast path.
    """
    B, H, D = q.shape
    block = k_pages.shape[1]
    max_blocks = block_tables.shape[1]
    T = max_blocks * block
    q_per_kv = H // k_pages.shape[2]
    bt = block_tables.long()

    k = k_pages[bt].reshape(B, T, -1, D)
    v = v_pages[bt].reshape(B, T, -1, D)
    cached_valid_len = seq_lens if cur_k is None else seq_lens - 1
    if cur_k is not None:
        k = torch.cat([k, cur_k[:, None]], dim=1)
        v = torch.cat([v, cur_v[:, None]], dim=1)
    k = _repeat_kv(k, q_per_kv)
    v = _repeat_kv(v, q_per_kv)

    scale = 1.0 / (D ** 0.5)
    logits = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    valid = (torch.arange(T, device=q.device)[None, :]
             < cached_valid_len.to(q.device)[:, None])
    if cur_k is not None:
        valid = torch.cat(
            [valid, torch.ones((B, 1), dtype=torch.bool, device=q.device)], dim=1)
    logits = torch.where(valid[:, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs, v.float())
    return out.to(q.dtype)
