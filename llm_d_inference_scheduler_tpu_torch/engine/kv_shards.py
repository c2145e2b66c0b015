"""Sharded KV staging and pull layout for P/D handoff between sharded
engines.

Port of ``llm_d_inference_scheduler_tpu/engine/kv_shards.py``. A staged
export is sharded like the engine's pages: kv heads over ``tp``, layers over
``pp`` (``ep`` replicas share one copy here: one controller keeps one page
set per tp rank, ``parallel/serve.py``). The wire unit is one shard per
distinct index slice, in the canonical order of the JAX module (sorted by
the slice's index offsets), so exporter and importer agree on each shard's
identity without shipping index maps. The port's pages are already one
tensor per (stage, tp rank), index ``s * tp + t``; sorting by (first layer,
first kv head) is that order.

Geometry compatibility is decided by :func:`mesh_descriptor` equality, the
JAX dict for the same ``(pp, tp, ep)`` and process count; anything else
falls back to the host ``/kv`` path (one process) or local prefill (a
multi-process group).
"""

from __future__ import annotations

import hashlib
from typing import Any

import torch

__all__ = ["mesh_descriptor", "local_unique_shards", "shard_digest"]

# The JAX meshes' axes (parallel/serve.py SERVE_AXES, parallel/pp_serve.py
# PP_SERVE_AXES) and page partition specs (KV_PAGE_SPEC, PAGE_SPEC).
SERVE_AXES = ["dp", "tp", "ep"]
PP_SERVE_AXES = ["pp", "tp", "ep"]
KV_PAGE_SPEC = [None, None, None, "tp", None]
PAGE_SPEC = ["pp", None, None, "tp", None]


def mesh_descriptor(tp: int, ep: int, pp: int, n_procs: int) -> dict[str, Any]:
    """Wire-comparable description of a page sharding's geometry, equal to
    the JAX ``mesh_descriptor`` of the engine's ``_page_layout`` (the
    ``(pp, tp, ep)`` mesh under pp, else ``(dp, tp, ep)`` with dp 1: the
    port serves no dp replicas)."""
    if pp > 1:
        axes, shape, spec = PP_SERVE_AXES, [pp, tp, ep], PAGE_SPEC
    else:
        axes, shape, spec = SERVE_AXES, [1, tp, ep], KV_PAGE_SPEC
    return {"axes": list(axes), "mesh_shape": [int(s) for s in shape],
            "spec": list(spec), "n_procs": int(n_procs)}


def local_unique_shards(pages: list[torch.Tensor | None]) -> list[torch.Tensor]:
    """This process's page shards (a list per (stage, tp) rank, None where
    another process holds it), one per distinct index slice, in canonical
    order."""
    return [p for p in pages if p is not None]


def shard_digest(t: torch.Tensor, n_tokens: int) -> str:
    """sha256 of a staged or gathered shard ``[L, nb, block, Hkv, Dh]``'s
    first ``n_tokens`` positions (the prompt's KV; decode writes past it):
    the same bytes give the same digest in any process."""
    flat = t.reshape(t.shape[0], -1, *t.shape[3:])[:, :n_tokens].contiguous()
    return hashlib.sha256(flat.cpu().view(torch.uint8).numpy().tobytes()).hexdigest()
