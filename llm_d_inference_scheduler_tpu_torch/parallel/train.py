"""The training step (dp x sp x tp x ep) for the engine models.

Port of ``llm_d_inference_scheduler_tpu/parallel/train.py``: the loss is
the mean next-token NLL through ``llama.forward``, the optimiser AdamW
with optax ``adamw(lr)``'s values, and the parameters stay in
``cfg.dtype`` (bf16 by default), as in JAX. One process drives every rank
of a ``TrainLayout`` (``mesh.py``):

- each tp x ep shard of a parameter is one leaf tensor, on the first rank
  of replica 0 that holds it; AdamW keeps one state per leaf;
- each step builds every replica's ``ShardedParams`` as differentiable
  ``.to(device)`` copies of those leaves (the leaf itself on its own
  device), so autograd sums a shard's gradient over the ranks and replicas
  that read it, and runs through the sharded model's sums and gathers
  (``parallel/serve.py`` ``reduce_sum``/``gather_last``: copies and adds in
  one process);
- replica ``d`` takes rows ``[d·B/dp, (d+1)·B/dp)`` and its loss, scaled
  by 1/dp, is back-propagated in rank order: the gradients are the mean
  over replicas, the all-reduce XLA inserts from the JAX shardings; with
  ``sp > 1`` the attention is ``ring_attention`` over the sp ranks (JAX
  ``train.py:44-45``);
- the norms and RoPE are the eager functions (``fused_norm.PLAIN``), as
  kernel K4 has no backward.

Refused: the grouped MoE FFN (kernel K2 has no backward; the dense FFN
trains, as in JAX, whose ``moe_impl`` defaults to dense), a multi-process
(``Comm``) layout (torch.distributed collectives carry no autograd), and a
pipeline layout (the JAX train step has no pp axis).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import llama
from ..models.configs import ModelConfig
from ..ops import fused_norm
from ..ops.attention import causal_attention
from . import serve as par
from .mesh import TrainLayout
from .ring_attention import make_ring_attention_fn
from .shardings import Split, join_shards, param_splits

# optax.adamw's defaults besides the learning rate (torch's own weight
# decay default is 1e-2).
BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 1e-4


@dataclasses.dataclass
class TrainState:
    layout: TrainLayout
    # flat name -> (tp index, ep index) of a shard -> its leaf (``_shard_of``)
    leaves: dict[str, dict[tuple[int, int], torch.Tensor]]
    optimizer: torch.optim.AdamW


def train_layout(layout: TrainLayout | par.ServeLayout) -> TrainLayout:
    """``layout`` as a training layout: a serving layout's tp x ep ranks
    train as one replica (dp = sp = 1), unless it spans processes or has
    stages."""
    if isinstance(layout, TrainLayout):
        return layout
    if layout.comm is not None:
        raise ValueError("training runs in one process: torch.distributed "
                         "collectives carry no autograd (a --dist-* group's "
                         "layout is refused)")
    if layout.pp > 1:
        raise ValueError("training has no pipeline schedule (pp > 1); the "
                         "GPipe forward is parallel/pipeline.py's")
    if None in layout.devices:
        raise ValueError("training needs every rank in this process")
    return TrainLayout(layout.devices, tp=layout.tp, ep=layout.ep)


def _check_trainable(cfg: ModelConfig, layout: TrainLayout) -> None:
    if cfg.moe_impl != "dense":
        raise ValueError(f"moe_impl={cfg.moe_impl!r} cannot train: the grouped "
                         "MoE FFN (kernel K2) has no backward; train with "
                         "moe_impl='dense'")
    par.validate_tp(cfg, layout.tp, layout.ep)


def make_train_state(cfg: ModelConfig, layout: TrainLayout | par.ServeLayout,
                     seed: int = 0, lr: float = 1e-4, *, params=None) -> TrainState:
    """One leaf per parameter shard and the AdamW optimiser over them.
    ``params`` (full tensors, ``init_params``' layout) are copied in; by
    default they are drawn as ``init_params`` draws them, on the first
    device from a generator seeded with ``seed``."""
    layout = train_layout(layout)
    _check_trainable(cfg, layout)
    if params is None:
        dev = layout.devices[0]
        params = llama.init_params(cfg, dev,
                                   generator=torch.Generator(device=dev).manual_seed(seed))
    home = par.shard_params(params, cfg, layout.replica(0))
    flats = [llama.flat_params(p) for p in home.shards]
    leaves: dict[str, dict[tuple[int, int], torch.Tensor]] = {}
    for name, split in param_splits(cfg).items():
        mine = leaves[name] = {}
        for r, t, e in home.layout.ranks():
            key = _shard_of(split, t, e)
            if key not in mine:
                mine[key] = flats[r][name].detach().clone().requires_grad_(True)
    opt = torch.optim.AdamW([t for mine in leaves.values() for t in mine.values()],
                            lr=lr, betas=BETAS, eps=EPS, weight_decay=WEIGHT_DECAY)
    return TrainState(layout, leaves, opt)


def _shard_of(split: Split, t: int, e: int) -> tuple[int, int]:
    """The shard that tp rank ``t``, ep rank ``e`` holds."""
    return (t if split.tp is not None else 0, e if split.ep is not None else 0)


def _replica_params(cfg: ModelConfig, state: TrainState, d: int) -> par.ShardedParams:
    """Replica ``d``'s shards: each rank's tensor the leaf moved to the
    rank's device (differentiable; the leaf itself where it lies there)."""
    rl = state.layout.replica(d)
    splits = param_splits(cfg)
    return par.ShardedParams(rl, [
        llama.nested_params({name: state.leaves[name][_shard_of(split, t, e)]
                             .to(rl.devices[r]) for name, split in splits.items()})
        for r, t, e in rl.ranks()])


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean NLL of ``tokens[:, 1:]`` under f32 log-softmax of
    ``logits[:, :-1]``."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    targets = tokens[:, 1:].long().to(lp.device)
    return -lp.gather(-1, targets[..., None]).mean()


def make_train_step(cfg: ModelConfig, layout: TrainLayout | par.ServeLayout):
    """Returns train_step(state, tokens [B, S]) -> the step's loss (an f32
    scalar on the first device): forward and backward on every replica,
    one AdamW update. Afterwards every leaf's ``.grad`` holds the step's
    gradient. B % dp == 0 and S % sp == 0."""
    layout = train_layout(layout)
    _check_trainable(cfg, layout)
    hooks = [make_ring_attention_fn(layout, d) if layout.sp > 1 else causal_attention
             for d in range(layout.dp)]

    def train_step(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        if B % layout.dp:
            raise ValueError(f"batch {B} does not divide over dp={layout.dp}")
        if S % layout.sp:
            raise ValueError(f"sequence length {S} does not divide over sp={layout.sp}")
        state.optimizer.zero_grad(set_to_none=True)
        rows = B // layout.dp
        total = None
        for d in range(layout.dp):
            params = _replica_params(cfg, state, d)
            toks = tokens[d * rows:(d + 1) * rows].to(params.layout.first_device)
            logits, _ = llama.forward(params, cfg, toks, attention_fn=hooks[d],
                                      norms=fused_norm.PLAIN)
            loss = next_token_loss(logits, toks)
            (loss / layout.dp if layout.dp > 1 else loss).backward()
            loss = loss.detach().to(layout.devices[0])
            total = loss if total is None else total + loss
        state.optimizer.step()
        return total / layout.dp

    return train_step


def full_params(cfg: ModelConfig, state: TrainState) -> dict[str, torch.Tensor]:
    """The parameters as full tensors, by flat name (copies)."""
    return _joined(cfg, state, lambda p: p.detach().clone())


def full_grads(cfg: ModelConfig, state: TrainState) -> dict[str, torch.Tensor]:
    """The last step's gradients as full tensors, by flat name (copies)."""
    return _joined(cfg, state, lambda p: p.grad.clone())


def _joined(cfg, state, get) -> dict[str, torch.Tensor]:
    rl = state.layout.replica(0)
    return {name: join_shards([get(state.leaves[name][_shard_of(split, t, e)])
                               for _, t, e in rl.ranks()], split, rl.tp, rl.ep)
            for name, split in param_splits(cfg).items()}
