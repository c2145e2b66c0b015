"""Which axis of each parameter is split over ``tp`` and which over ``ep``.

Port of ``param_pspecs`` (``llm_d_inference_scheduler_tpu/parallel/
shardings.py``), as data over the flat parameter names of
``models/llama.param_shapes``:

- Megatron-style TP: ``wq``/``wk``/``wv`` and the dense ``w1``/``w3`` are
  column-parallel (output features on ``tp``), ``wo`` and the dense ``w2``
  row-parallel (input features on ``tp``), so each block needs one sum;
- MoE: the experts axis of ``w1``/``w2``/``w3`` on ``ep``, and within each
  expert ``d_ff`` on ``tp`` (the same column/row split);
- ``embed`` split over vocab rows, ``lm_head`` over vocab columns;
- norms, ``q_norm``/``k_norm`` and the router replicated.

Axes count from the end, so one rule fits a stacked ``[L, ...]`` tensor, one
layer's slice of it and one expert's slice of that.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch


@dataclasses.dataclass(frozen=True)
class Split:
    tp: int | None = None   # axis (from the end) split over tp
    ep: int | None = None   # axis (from the end) split over ep


REPLICATED = Split()


def param_splits(cfg) -> dict[str, Split]:
    """The split of every parameter of ``cfg``, by flat name."""
    moe = bool(cfg.n_experts)
    experts = -3 if moe else None
    splits = {
        "embed": Split(tp=-2),
        "layers.wq": Split(tp=-1), "layers.wk": Split(tp=-1),
        "layers.wv": Split(tp=-1), "layers.wo": Split(tp=-2),
        "layers.w1": Split(tp=-1, ep=experts), "layers.w3": Split(tp=-1, ep=experts),
        "layers.w2": Split(tp=-2, ep=experts),
        "layers.ln_attn": REPLICATED, "layers.ln_mlp": REPLICATED,
        "final_norm": REPLICATED, "lm_head": Split(tp=-1),
    }
    if cfg.qk_norm:
        splits |= {"layers.q_norm": REPLICATED, "layers.k_norm": REPLICATED}
    if moe:
        splits["layers.router"] = REPLICATED
    return splits


def _cuts(split: Split, tp_rank: int, tp: int, ep_rank: int, ep: int
          ) -> Iterable[tuple[int, int, int]]:
    """(axis from the end, rank, parts) of each axis ``split`` cuts."""
    for axis, rank, n in ((split.tp, tp_rank, tp), (split.ep, ep_rank, ep)):
        if axis is not None and n > 1:
            yield axis, rank, n


def split_tensor(t: torch.Tensor, split: Split, tp_rank: int, tp: int,
                 ep_rank: int = 0, ep: int = 1) -> torch.Tensor:
    """The shard of ``t`` that rank (tp_rank, ep_rank) holds: a view, no
    copy."""
    for axis, rank, n in _cuts(split, tp_rank, tp, ep_rank, ep):
        size = t.shape[axis] // n
        t = t.narrow(axis, rank * size, size)
    return t


def put_split(dst: torch.Tensor, index: tuple[int, ...], src: torch.Tensor,
              full_shape: tuple[int, ...], split: Split, tp_rank: int, tp: int,
              ep_rank: int = 0, ep: int = 1) -> None:
    """``full[index] = src`` restricted to the shard ``dst`` of rank
    (tp_rank, ep_rank), where ``full`` (of ``full_shape``) is the unsplit
    tensor. An index along a split axis outside the shard writes nothing;
    a split axis of ``src`` is narrowed to the shard's part."""
    idx = list(index)
    for axis, rank, n in _cuts(split, tp_rank, tp, ep_rank, ep):
        pos = len(full_shape) + axis
        size = full_shape[pos] // n
        if pos < len(idx):
            if not rank * size <= idx[pos] < (rank + 1) * size:
                return
            idx[pos] -= rank * size
        else:
            src = src.narrow(pos - len(idx), rank * size, size)
    dst[tuple(idx)].copy_(src)


def join_shards(shards: list[torch.Tensor], split: Split, tp: int, ep: int = 1
                ) -> torch.Tensor:
    """The inverse of ``split_tensor``: the full tensor from every rank's
    shard (rank ``t * ep + e``), joined on the first shard's device. A
    replicated parameter is the first rank's."""
    dev = shards[0].device
    per_tp = []
    for t in range(tp if split.tp is not None else 1):
        parts = [shards[t * ep + e].to(dev)
                 for e in range(ep if split.ep is not None else 1)]
        per_tp.append(torch.cat(parts, dim=split.ep) if len(parts) > 1 else parts[0])
    return torch.cat(per_tp, dim=split.tp) if len(per_tp) > 1 else per_tp[0]
