"""The port's converted-checkpoint directory: ``model_config.json`` beside
``model.safetensors``, which holds the stacked parameters under flat names
(``embed``, ``layers.wq``, ... ``lm_head``; ``models/llama.param_shapes``).

``models/convert_hf.py`` writes such a directory from an HF checkpoint; the
engine loads one named by ``--model`` (found by its ``model_config.json``)
or ``--checkpoint``. The JAX package's converter writes Orbax instead, and
reading Orbax needs JAX, so such a directory is refused with a message that
names the port's converter. Every tensor's shape is checked against the
``ModelConfig``, as the JAX restore template checks it.
"""

from __future__ import annotations

import os

import torch

from ..models import llama, safetensors_io
from ..models.configs import ModelConfig
from ..parallel import serve as par
from ..utils.device import resolve_device, torch_dtype

WEIGHTS = "model.safetensors"
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")
CONVERT_CLI = "python -m llm_d_inference_scheduler_tpu_torch.models.convert_hf SRC OUT"


def save_params(path: str, params: dict) -> int:
    """Write ``params`` (on any device) to ``path/model.safetensors``, one
    tensor at a time through the host; returns the bytes written."""
    os.makedirs(path, exist_ok=True)
    return safetensors_io.save_file(llama.flat_params(params), os.path.join(path, WEIGHTS),
                                    metadata={"format": "pt"})


def weights_path(path: str) -> str:
    """``path``'s weights file; raises ``ValueError`` for a directory the
    port cannot read (Orbax, or no weights)."""
    if any(os.path.exists(os.path.join(path, m)) for m in ORBAX_MARKERS):
        raise ValueError(
            f"{path} is an Orbax checkpoint (the JAX package's converter writes "
            f"it; reading it needs JAX): convert the HF checkpoint with `{CONVERT_CLI}`")
    weights = os.path.join(path, WEIGHTS)
    if not os.path.isfile(weights):
        raise ValueError(
            f"{path} holds no {WEIGHTS}: the port loads no checkpoint from it; "
            f"convert an HF checkpoint with `{CONVERT_CLI}`, or pass params")
    return weights


def load_params(path: str, cfg: ModelConfig, device: str | torch.device = "cuda",
                dtype: str | torch.dtype | None = None,
                layout: par.ServeLayout | None = None):
    """The stacked params of a converted directory on ``device``, cast to
    ``dtype`` (default: the config's), each tensor checked against ``cfg``.
    With ``layout`` each tensor is split on the host as it is read (by
    stage first, then over tp/ep) and each shard goes to its rank's device
    (``ShardedParams``): no device holds the whole model."""
    device = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    flat = safetensors_io.load_file(weights_path(path))
    want = llama.param_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(f"{path}: tensors {sorted(set(flat) ^ set(want))} are missing "
                         f"or unexpected for model {cfg.name!r}")
    for name, shape in want.items():
        if tuple(flat[name].shape) != shape:
            raise ValueError(f"{path}: {name} is {tuple(flat[name].shape)}, the "
                             f"config needs {shape}")
    if layout is not None:
        par.validate_degrees(cfg, layout.tp, layout.ep, layout.pp)
        return par.from_rank_lists(
            {name: [None if v is None else v.to(device=d, dtype=dt) for v, d in zip(
                par.rank_views(name, flat.pop(name), cfg, layout), layout.devices)]
             for name in want}, layout)
    return llama.nested_params({name: flat.pop(name).to(device=device, dtype=dt)
                                for name in want})
