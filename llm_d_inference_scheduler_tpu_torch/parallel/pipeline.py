"""Pipeline parallelism for training: the GPipe microbatch forward.

Port of ``llm_d_inference_scheduler_tpu/parallel/pipeline.py``; not the
decode ring of ``pp_serve.py``. The stage slabs are ``parallel/serve.py``'s
with ``pp`` (stage ``s`` holds layers ``[s·L/P, (s+1)·L/P)``); the
embedding, the final norm and the head live on stage 0 (the JAX mesh
replicates them over ``pp``).

The batch is cut into M microbatches and the schedule runs M+P-1 ticks: at
tick ``i`` stage ``s`` runs its layers on microbatch ``i - s`` when that is
in range, stage 0 embedding it first, so the bubble is (P-1)/(M+P-1). One
controller runs the stages of a tick in turn, each on the activation the
previous stage handed it at the tick before (``_Model.hop``: a copy to the
next stage's device, the JAX ``ppermute``). The last stage's hidden states
hop back to stage 0, where the final norm and the head run once after the
loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import llama
from ..models.configs import ModelConfig
from ..ops.rope import rope_table
from .serve import (ServeLayout, ShardedParams, cuda_devices, make_serve_layout,
                    shard_params)


def make_pp_layout(devices=None, pp: int | None = None) -> ServeLayout:
    """``pp`` stages, one rank each, on the first ``pp`` of ``devices`` (by
    default of the CUDA devices, ``pp`` by default all of them; a device
    may repeat)."""
    if devices is not None:
        devices = list(devices)
        pp = pp or len(devices)
        devices = devices[:pp]
    return make_serve_layout(devices, pp=pp or len(cuda_devices(
        need="a pp layout needs a CUDA device")))


def shard_params_pp(params, cfg: ModelConfig, layout: ServeLayout) -> ShardedParams:
    """The layer-stacked weights split over the stages (views where a stage
    shares the weights' device)."""
    if cfg.n_layers % layout.pp:
        raise ValueError(f"pp={layout.pp} does not divide n_layers={cfg.n_layers}")
    return shard_params(params, cfg, layout)


def make_pp_forward(cfg: ModelConfig, layout: ServeLayout, n_microbatches: int):
    """Returns forward(params, tokens [B, S]) -> logits [B, S, V] f32 on
    stage 0's device, for ``shard_params_pp``'s params. B must divide into
    ``n_microbatches`` equal microbatches."""
    P, M = layout.pp, n_microbatches

    def pp_forward(params: ShardedParams, tokens: torch.Tensor) -> torch.Tensor:
        m = llama._Model(params)
        B, S = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} does not divide into {M} microbatches")
        mb = B // M
        tokens = tokens.to(m.dev)
        positions = torch.arange(S, dtype=torch.int32, device=m.dev).expand(mb, S)
        cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
        shape = (mb, S, cfg.d_model)
        inbox: list[torch.Tensor | None] = [None] * P
        hidden: list[torch.Tensor | None] = [None] * M
        for tick in range(M + P - 1):
            sent: list[torch.Tensor | None] = [None] * P
            for s, st in enumerate(m.stages):
                i = tick - s
                if not 0 <= i < M:
                    continue
                x = m.embed(tokens[i * mb:(i + 1) * mb]) if s == 0 else inbox[s]
                x = llama.run_stage(cfg, st, x, positions, cos, sin)
                if s == P - 1:  # microbatch i is done: back to the head
                    hidden[i] = m.hop(x, s, 0, shape)
                else:
                    sent[s + 1] = m.hop(x, s, s + 1, shape)
            inbox = sent
        m.flush()
        return m.logits(m.final_norm(torch.cat(hidden), cfg))

    return pp_forward


def dryrun_pipeline(cfg: ModelConfig, devices, pp: int = 2, n_microbatches: int = 2,
                    atol: float = 2e-3) -> None:
    """Asserts the pipelined forward matches the single-device forward (f32
    weights drawn from seed 0 on the first device)."""
    layout = make_pp_layout(devices, pp=pp)
    dev = layout.devices[0]
    params = llama.init_params(cfg, dev, dtype="float32",
                               generator=torch.Generator(device=dev).manual_seed(0))
    B, S = 2 * n_microbatches, 16
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)

    ref_logits, _ = llama.forward(params, cfg, tokens)
    fwd = make_pp_forward(cfg, layout, n_microbatches)
    got = fwd(shard_params_pp(params, cfg, layout), tokens)
    if not torch.allclose(got, ref_logits, atol=atol, rtol=atol):
        diff = float((got - ref_logits).abs().max())
        raise AssertionError(f"pipeline logits diverge: max|Δ|={diff}")
