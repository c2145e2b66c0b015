"""Mixture-of-experts FFN in plain PyTorch: routing glue of the grouped path
and the plain version of its kernel K2 (port of
``llm_d_inference_scheduler_tpu/ops/pallas_moe.py``).

The grouped path computes only the (token, selected expert) rows:

1. ``group_rows`` routes: router top-k and a softmax over the top-k,
   expansion to T·k rows stable-sorted by expert, a scatter into a
   group-padded row buffer in which every expert's rows start on a row-tile
   boundary, and a tile -> expert map.
2. The grouped SwiGLU FFN runs one expert per row tile: the CUDA kernel K2
   (``ops/grouped_moe.py``) on the card, ``grouped_ffn_reference`` on the CPU.
3. ``combine`` gathers the rows back, un-sorts them and weights them by
   the gates. ``moe_ffn_grouped`` runs the three.

Everything the glue computes on the card stays on the card: expert counts
come from ``scatter_add_``, the buffer size from shapes alone, and the number
of rows in use is handed to the kernel as a device scalar, so a decode step
makes no host sync. Row tiles and column tiles are the port's own (the JAX
package's 128/16 ``tm`` and 128-lane ``tf`` rules are TPU constraints).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

TILE_ROWS = 64         # rows per tile: one wgmma M of the kernel
COL_ALIGN = 128        # d_model and d_ff must be multiples of this


def check_tileable(d_model: int, d_ff: int) -> None:
    """Raise ValueError for a geometry the grouped kernel cannot tile (it
    never drops columns: every column tile is whole)."""
    if d_model % COL_ALIGN or d_ff % COL_ALIGN:
        raise ValueError(
            f"d_model={d_model}, d_ff={d_ff}: the grouped MoE kernel tiles "
            f"both in multiples of {COL_ALIGN}; use the dense MoE path for "
            "this geometry")


def top_k_gates(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(gates [.., k] f32 softmax over the top-k logits, expert ids [.., k]).

    A stable descending sort takes the lower expert id first among equal
    logits, as ``jax.lax.top_k`` does (``torch.topk`` promises no order for
    ties, and a bf16 router matmul makes ties)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[..., :k], dim=-1), idx[..., :k]


def grouped_ffn_reference(x_pad: torch.Tensor, tile_expert: torch.Tensor,
                          w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                          tm: int) -> torch.Tensor:
    """Plain version of kernel K2: for each row tile of ``x_pad`` [Tp, D],
    ``act = silu(x @ w1_e) * (x @ w3_e)`` in f32 rounded to x's dtype, then
    ``act @ w2_e`` in f32 rounded to x's dtype, ``e = tile_expert[tile]``.
    Rows past the last whole tile stay zero. Loops over experts, so no
    per-tile copy of a [D, F] weight is made."""
    Tp = x_pad.shape[0]
    n = Tp // tm
    out = torch.zeros_like(x_pad)
    row_expert = tile_expert[:n].long().repeat_interleave(tm)
    for e in range(w1.shape[0]):
        rows = (row_expert == e).nonzero().squeeze(1)
        if rows.numel() == 0:
            continue
        x = x_pad[rows].float()
        act = (F.silu(x @ w1[e].float()) * (x @ w3[e].float())).to(x_pad.dtype)
        out[rows] = (act.float() @ w2[e].float()).to(x_pad.dtype)
    return out


class GroupedRows(NamedTuple):
    """The routed rows of T tokens laid out for the grouped kernel."""

    x_pad: torch.Tensor        # [Tp, D] rows grouped by expert, zero padding
    tile_expert: torch.Tensor  # [Tp // tm] int32 expert of each row tile
    rows_used: torch.Tensor    # [1] int32 rows in use; later tiles are padding
    tm: int                    # rows per tile
    dest: torch.Tensor         # [T*k] row of x_pad of each sorted (token, expert)
    order: torch.Tensor        # [T*k] stable sort of the flat (token, expert) rows
    gates: torch.Tensor        # [T, k] f32 softmax over the top-k logits
    counts: torch.Tensor       # [E] routed rows per expert


def group_rows(lp: dict[str, torch.Tensor], x: torch.Tensor, n_experts: int,
               experts_per_token: int, *, tm: int = TILE_ROWS) -> GroupedRows:
    """Route x [..., D] (router top-k, softmax over the top-k) and lay the
    T·k (token, expert) rows out as the kernel takes them: stable-sorted by
    expert, each expert's group starting on a row-tile boundary. The kernel
    takes ``tm = TILE_ROWS`` at every size (the row tiles measured against it
    on an H100 are in PERF.md); the plain version takes any ``tm``."""
    E, k = n_experts, experts_per_token
    D = x.shape[-1]
    check_tileable(D, lp["w1"].shape[2])
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    n_rows = T * k
    dev = x.device

    logits = (xt @ lp["router"]).float()                         # [T, E]
    gates, top_idx = top_k_gates(logits, k)                      # [T, k]

    # T·k (token, expert) rows, stable-sorted by expert.
    flat_expert = top_idx.reshape(-1)
    order = torch.sort(flat_expert, stable=True).indices
    src_token = order // k
    sorted_expert = flat_expert[order]

    # Group-padded layout: expert e's rows start at off[e], each group
    # padded to a multiple of tm. No routing needs more than
    # ceil(T·k / tm) + E - 1 tiles, so that is the static buffer.
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    padded = (counts + tm - 1) // tm * tm
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    off = torch.cat([zero, torch.cumsum(padded, 0)])             # [E+1]
    unpadded_start = torch.cat([zero, torch.cumsum(counts, 0)])
    rank = torch.arange(n_rows, device=dev) - unpadded_start[sorted_expert]
    dest = off[sorted_expert] + rank                             # [T*k]

    n_tiles = -(-n_rows // tm) + E - 1
    x_pad = torch.zeros((n_tiles * tm, D), dtype=x.dtype, device=dev)
    x_pad.index_copy_(0, dest, xt.index_select(0, src_token))

    # tile -> expert whose [off[e], off[e+1]) holds the tile's first row;
    # tiles past off[E] are padding (clamped to E-1, zero rows, never
    # gathered back; the kernel skips them through rows_used).
    tile_starts = torch.arange(n_tiles, device=dev) * tm
    tile_expert = torch.searchsorted(off[1:], tile_starts, right=True)
    tile_expert = tile_expert.clamp(max=E - 1).to(torch.int32)
    rows_used = off[E:].to(torch.int32)                          # [1]
    return GroupedRows(x_pad, tile_expert, rows_used, tm, dest, order, gates, counts)


def combine(g: GroupedRows, out_pad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Gather the kernel's rows back, un-sort them and sum each token's k
    rows weighted by its gates (cast to x's dtype); returns x's shape."""
    T, k = g.gates.shape
    rows = out_pad.index_select(0, g.dest)                       # sorted order
    unsorted = torch.empty_like(rows).index_copy_(0, g.order, rows)
    y = (unsorted.reshape(T, k, -1) * g.gates[..., None].to(x.dtype)).sum(dim=1)
    return y.reshape(x.shape)


def moe_ffn_grouped(lp: dict[str, torch.Tensor], x: torch.Tensor,
                    n_experts: int, experts_per_token: int) -> torch.Tensor:
    """Top-k MoE FFN over the routed rows only; x [..., D] -> [..., D] in
    x's dtype. ``lp`` holds ``router`` [D, E], ``w1``/``w3`` [E, D, F] and
    ``w2`` [E, F, D]. The kernel's wrapper takes the plain version for CPU
    tensors."""
    from .grouped_moe import grouped_ffn_cuda

    g = group_rows(lp, x, n_experts, experts_per_token)
    out_pad = grouped_ffn_cuda(g.x_pad, g.tile_expert, lp["w1"], lp["w3"], lp["w2"],
                               g.tm, g.rows_used)
    return combine(g, out_pad, x)
