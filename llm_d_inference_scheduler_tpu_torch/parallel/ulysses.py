"""Ulysses-style all-to-all sequence parallelism.

Port of ``llm_d_inference_scheduler_tpu/parallel/ulysses.py``: the
alternative to ring attention. With the sequence split over ``sp``, one
all-to-all moves Q/K/V from sequence shards to head shards (each sp rank
then holds every position of ``H/sp`` heads), attention runs locally per
head group, and a second all-to-all moves the output back to sequence
shards. With one controller an all-to-all is a re-slicing: sp rank ``j``
joins head group ``j`` of every rank's chunk along the sequence, each piece
copied to its device. The JAX train step does not use it; it is an
alternative ``attention_fn``, and so it is here.
"""

from __future__ import annotations

import torch

from ..ops.attention import causal_attention
from .mesh import TrainLayout


def ulysses_attention(
    q: torch.Tensor,   # [B, S, H, D]
    k: torch.Tensor,   # [B, S, Hkv, D]
    v: torch.Tensor,
    *,
    n_shards: int,
    devices: list[torch.device] | None = None,
) -> torch.Tensor:
    """Causal attention of the full sequences, computed as the JAX Ulysses
    body does over ``n_shards`` sp ranks (rank ``i`` on ``devices[i]``,
    default q's device); returns [B, S, H, D] on q's device."""
    sp = n_shards
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if H % sp != 0:
        raise ValueError(f"n_heads {H} must divide by sp {sp}")
    if Hkv % sp != 0:
        # A correct deep-GQA fallback needs per-group KV head slicing; ring
        # attention covers that case, so keep this path strict.
        raise NotImplementedError(
            f"ulysses needs n_kv_heads ({Hkv}) divisible by sp ({sp}); "
            f"use ring attention for deeper GQA")
    if S % sp:
        raise ValueError(f"sequence length {S} does not divide over sp={sp}")
    devices = list(devices) if devices is not None else [q.device] * sp
    C = S // sp

    def seq_to_heads(x):
        # sp rank s holds chunk s [B, C, h, D]; rank j receives head group j
        # of every chunk: [B, S, h/sp, D].
        chunks = [c.to(d) for c, d in zip(x.split(C, dim=1), devices)]
        g = x.shape[2] // sp
        return [torch.cat([c[:, :, j * g:(j + 1) * g].to(devices[j]) for c in chunks], dim=1)
                for j in range(sp)]

    outs = [causal_attention(qg, kg, vg) for qg, kg, vg in
            zip(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v))]
    # heads_to_seq: rank s receives its chunk of every head group: [B, C, H, D].
    back = [torch.cat([o[:, s * C:(s + 1) * C].to(devices[s]) for o in outs], dim=2)
            for s in range(sp)]
    return torch.cat([b.to(q.device) for b in back], dim=1)


def make_ulysses_attention_fn(layout: TrainLayout, replica: int = 0):
    """Adapter with the same contract as ``make_ring_attention_fn``."""
    rings = layout.ring_devices(replica)

    def attention_fn(q, k, v, *, q_positions=None, kv_positions=None, kv_valid=None):
        del q_positions, kv_positions
        if kv_valid is not None:
            raise NotImplementedError("ulysses path does not take padding masks")
        return ulysses_attention(q, k, v, n_shards=layout.sp, devices=rings[q.device])

    return attention_fn
