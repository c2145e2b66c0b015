"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of the model step and of kernels K1 and K2, counted
from shapes and lengths the host knows.

The kernel bounds follow the rules of the port's ``chip_smoke.py``
(``attention_bound_ms``, ``moe_bound_ms``), copied here so that the
benchmark does not depend on the program: every input byte a call needs is
read once and every output byte written once; operations are those the
algorithm needs; the least time is the larger of bytes over bandwidth and
operations over the peak rate.
"""

from __future__ import annotations

from collections.abc import Iterable

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def k1_call(seq_lens: Iterable[int], n_heads: int, n_kv_heads: int,
            head_dim: int, block: int, isz: int) -> tuple[int, int]:
    """(bytes, flops) of one paged decode attention launch over lanes of
    these sequence lengths (each counting the current token): the cached
    K/V rows of every lane, q, the current K/V and the output, the table
    entries of the pages read and the lengths; QK and PV over every cached
    position and the current one."""
    lens = list(seq_lens)
    B = len(lens)
    cached = [max(s - 1, 0) for s in lens]
    n_cached = sum(cached)
    n_pages = sum(-(-c // block) for c in cached)
    nbytes = (2 * n_cached * n_kv_heads * head_dim * isz
              + 2 * B * n_heads * head_dim * isz
              + 2 * B * n_kv_heads * head_dim * isz + 4 * n_pages + 4 * B)
    flops = 4 * n_heads * head_dim * (n_cached + B)
    return nbytes, flops


def k2_call(counts: Iterable[int], d_model: int, d_ff: int, isz: int) -> tuple[int, int]:
    """(bytes, flops) of one grouped expert FFN launch with ``counts``
    routed rows per expert: the three [D, F] weights of every expert that
    holds a row, the rows in and out; 6 * D * F operations a routed row."""
    counts = list(counts)
    rows = sum(counts)
    hit = sum(1 for c in counts if c > 0)
    return (hit * 3 * d_model * d_ff * isz + 2 * rows * d_model * isz,
            6 * d_model * d_ff * rows)


def least_seconds(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    return max(nbytes / PEAK_HBM_BYTES_PER_S, flops / peak_flops)


def layer_matmul_params(arch) -> int:
    """Weights a token multiplies by in one layer: q, k, v, o, and the FFN
    (the router and top-k experts of an MoE layer)."""
    D, Dh = arch.d_model, arch.head_dim
    attn = D * arch.n_heads * Dh * 2 + D * arch.n_kv_heads * Dh * 2
    ffn = 3 * D * arch.d_ff
    if arch.n_experts:
        ffn = arch.top_k * ffn + D * arch.n_experts
    return attn + ffn


def tokens_flops(arch, contexts: Iterable[int], head_rows: int) -> float:
    """Model operations of a step that computes one token at each context
    length in ``contexts`` (the positions it attends to, its own included),
    with the LM head on ``head_rows`` of them: 2 per weight a token
    multiplies by, and QK and PV over the real context (no padding, no
    masked keys)."""
    ctx = list(contexts)
    per_tok = 2 * layer_matmul_params(arch) * arch.n_layers
    attn = 4 * arch.n_heads * arch.head_dim * arch.n_layers * sum(ctx)
    return float(per_tok * len(ctx) + attn + 2 * arch.d_model * arch.vocab * head_rows)
