"""Pipeline-parallel serving: the stage checks and the two decode schedules.

Port of ``llm_d_inference_scheduler_tpu/parallel/pp_serve.py``. The layout
(ranks ``(pp, tp, ep)``, stage ``s`` holding layers ``[s·L/P, (s+1)·L/P)``
and their KV pages, the embedding and head on stage 0) is
``parallel/serve.py``'s; prefill (every window, with or without a cached
prefix) and the embeddings run the stages in turn inside
``models/llama.py`` (``prefill``, ``forward``), as does the broadcast ring
(``decode_step``).

One process drives every stage, so where the JAX SPMD ring runs every stage
on every turn and throws away the off-turn work (redirecting its KV writes
to the trash block), this runs only the stage whose turn it is. The
activation moves between stages by ``.to(next stage's device)``, the JAX
``ppermute``; where stages share a device the copy does nothing.

A decode chunk takes one of the JAX schedules, chosen as its ``"auto"``
mode chooses (``make_pp_decode_chunk``): the lane-group interleave when the
batch divides by P, the broadcast ring otherwise (the B=1 bucket):

- broadcast ring: each step runs every lane through stage 0, ..., P-1, then
  the head and the sampler (``llama.decode_step``);
- lane-group interleave (``interleaved_chunk``): the batch splits into P
  groups of B/P; group g's token j enters stage 0 at turn g + jP, and at
  turn t stage s works group (t - s) mod P. Stage 0 samples the group's
  previous token from the hidden state the ring wrap brought back, then
  embeds it. A chunk of K tokens takes K·P + P turns. The host enqueues
  each stage's work in turn order and never syncs, so on several devices
  stage s+1 works on group g-1 while stage s works on group g.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import llama
from ..ops.paged_attention import paged_decode_attention_cuda
from .serve import validate_tp


def validate_pp(cfg, pp: int, tp: int = 1, ep: int = 1) -> None:
    """The JAX ``validate_pp``: pp divides the layers; under pp x tp the tp
    checks and d_model (the JAX embedding shards the model dim); under ep
    the expert checks."""
    if cfg.n_layers % pp:
        raise ValueError(f"pp_size={pp} does not divide "
                         f"n_layers={cfg.n_layers}")
    if tp > 1:
        validate_tp(cfg, tp)
        if cfg.d_model % tp:  # embed shards the model dim under pp×tp
            raise ValueError(f"tp={tp} does not divide d_model={cfg.d_model}")
    if ep > 1:
        validate_tp(cfg, 1, ep)  # ep divisibility checks


def use_interleave(batch: int, pp: int) -> bool:
    """The JAX ``"auto"`` schedule: the interleave when the batch splits
    evenly into stage groups, else the broadcast ring."""
    return pp > 1 and batch % pp == 0


def interleaved_chunk(
    params,
    cfg,
    tokens: torch.Tensor,        # [B] each lane's current input token
    positions: torch.Tensor,     # [B] its position
    k_pages,                     # a list per (stage, tp) rank
    v_pages,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    n_tokens: int,
    sample: Callable[[torch.Tensor, int], torch.Tensor],
    paged_attention: Callable[..., torch.Tensor] = paged_decode_attention_cuda,
) -> torch.Tensor:
    """``n_tokens`` decode steps of every lane by the lane-group interleave
    (the JAX ``_interleaved_chunk_body``); ``sample(logits, g)`` samples
    group g's lanes. Returns the [K, B] int32 tokens on stage 0's device
    (None on a process without stage 0), the pages written in place. Across
    processes each group's activation hops stage to stage as in
    ``llama.decode_step``; every process walks the turns in the same order,
    so each receive meets a send posted a turn earlier."""
    m = llama._Model(params)
    P, K = m.pp, n_tokens
    B = tokens.shape[0]
    if B % P:
        raise ValueError(f"interleaved pp decode needs batch divisible "
                         f"by pp={P}, got {B}")
    Bg = B // P
    shape = (Bg, 1, cfg.d_model)
    head = m.head.held
    lanes = [slice(g * Bg, (g + 1) * Bg) for g in range(P)]
    out = torch.empty((K, B), dtype=torch.int32, device=m.dev) if head else None
    cur = [tokens[sl] for sl in lanes]
    # A copy per group: a row slice starts g·B/P·W·4 bytes in, off the
    # 16-byte alignment K1 takes unless B/P·W divides by 4.
    tables = [block_tables[sl].clone() for sl in lanes]
    x: list[torch.Tensor | None] = [None] * P    # each group's activation
    for t in range(K * P + P):
        for s in range(min(t + 1, P)):
            g, j = (t - s) % P, (t - s) // P      # stage s works group g's token j
            if s == 0 and j >= 1:
                # Token j-1 came round the ring: head and sampler.
                x[g] = m.hop(x[g], P - 1, 0, shape)
                if head:
                    h = m.final_norm(x[g][:, 0], cfg)
                    cur[g] = sample(m.logits(h), g)
                    out[j - 1, lanes[g]] = cur[g]
            if j >= K:
                continue
            if s == 0:
                x[g] = m.embed(cur[g])[:, None] if head else None
            else:
                x[g] = m.hop(x[g], s - 1, s, shape)
            if m.stages[s].held:
                x[g] = llama.decode_slab(cfg, m.stages[s], x[g], m.stage_pages(k_pages, s),
                                         m.stage_pages(v_pages, s), tables[g],
                                         positions[lanes[g]] + j, paged_attention)
    m.flush()
    return out
