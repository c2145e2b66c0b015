"""Ring attention: causal attention with the sequence split over ``sp``.

Port of ``llm_d_inference_scheduler_tpu/parallel/ring_attention.py``. Each
sp rank keeps its chunk of Q; the K/V chunks go round the ring, one hop a
step, and an online softmax keeps running (max, denominator, output)
accumulators in f32, so the result is exact. The JAX body runs on every sp
device at once inside ``shard_map`` and rotates with ``ppermute``; one
controller runs the ranks in turn within each step, and a rotation is a
``.to(next rank's device)`` copy (nothing where the ranks share a device).

Plain PyTorch, as the JAX version is einsums: every op is differentiable,
so the train step (``train.py``) uses it when ``sp > 1``.
"""

from __future__ import annotations

import torch

from ..ops.attention import NEG_INF, _repeat_kv
from .mesh import TrainLayout


def ring_attention(
    q: torch.Tensor,   # [B, S, H, D]
    k: torch.Tensor,   # [B, S, Hkv, D]
    v: torch.Tensor,   # [B, S, Hkv, D]
    *,
    n_shards: int,
    devices: list[torch.device] | None = None,
) -> torch.Tensor:
    """Causal attention of the full sequences, computed as the JAX ring
    does: chunk ``i`` of ``S / n_shards`` positions (contiguous, positions
    ``0..S-1``) is sp rank ``i``'s, on ``devices[i]`` (default: q's device
    for every rank). Returns [B, S, H, D] in q's dtype on q's device."""
    B, S, H, D = q.shape
    n = n_shards
    if S % n:
        raise ValueError(f"sequence length {S} does not divide over sp={n}")
    devices = list(devices) if devices is not None else [q.device] * n
    C = S // n
    q_per_kv = H // k.shape[2]
    scale = 1.0 / (D ** 0.5)
    qs = [c.to(d).float() for c, d in zip(q.split(C, dim=1), devices)]
    held = [(kc.to(d), vc.to(d)) for kc, vc, d in zip(k.split(C, dim=1),
                                                        v.split(C, dim=1), devices)]
    pos = [torch.arange(C, device=d) for d in devices]
    o = [torch.zeros((B, H, C, D), dtype=torch.float32, device=d) for d in devices]
    m = [torch.full((B, H, C), NEG_INF, dtype=torch.float32, device=d) for d in devices]
    l = [torch.zeros((B, H, C), dtype=torch.float32, device=d) for d in devices]

    for s in range(n):
        for my in range(n):
            origin = (my - s) % n  # which rank this K/V chunk came from
            kc, vc = held[my]
            kf = _repeat_kv(kc, q_per_kv).float()
            vf = _repeat_kv(vc, q_per_kv).float()
            logits = torch.einsum("bshd,bthd->bhst", qs[my], kf) * scale  # [B,H,C,C]
            mask = (my * C + pos[my])[:, None] >= (origin * C + pos[my])[None, :]
            logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
            new_m = torch.maximum(m[my], logits.amax(dim=-1))
            # Guard fully-masked blocks: exp(logits - new_m) would be exp(0)=1
            # for masked rows when new_m == NEG_INF, so re-mask the
            # probabilities.
            p = torch.exp(logits - new_m[..., None]) * mask
            corr = torch.exp(m[my] - new_m)
            l[my] = l[my] * corr + p.sum(dim=-1)
            o[my] = o[my] * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p, vf)
            m[my] = new_m
        if s != n - 1:  # rank j receives rank j-1's chunk
            held = [tuple(t.to(devices[j]) for t in held[j - 1]) for j in range(n)]

    out = [(o[i] / l[i].clamp_min(1e-30)[..., None]).transpose(1, 2).to(q.dtype)
           for i in range(n)]
    return torch.cat([c.to(q.device) for c in out], dim=1)


def make_ring_attention_fn(layout: TrainLayout, replica: int = 0):
    """Adapter with ``causal_attention``'s signature for ``llama.forward``
    (the JAX ``make_ring_attention_fn``): replica ``replica``'s tp ranks
    each run the ring over their own heads on their sp ranks' devices.
    Positions are recomputed as contiguous ``0..S-1`` (the training path's
    layout); padding masks are refused."""
    rings = layout.ring_devices(replica)

    def attention_fn(q, k, v, *, q_positions=None, kv_positions=None, kv_valid=None):
        del q_positions, kv_positions
        if kv_valid is not None:
            raise NotImplementedError("ring attention path does not take padding masks")
        return ring_attention(q, k, v, n_shards=layout.sp, devices=rings[q.device])

    return attention_fn
