"""HuggingFace checkpoint -> the port's stacked parameters (port of
``llm_d_inference_scheduler_tpu/models/convert_hf.py``).

The mapping is the JAX package's:

- HF ``nn.Linear.weight`` is ``[out, in]`` applied as ``x @ W.T``; the port's
  params are ``[in, out]`` applied as ``x @ W``, so every projection
  transposes. HF Llama checkpoints already use the rotate-half RoPE layout of
  ``ops/rope.py``, so the attention weights copy straight through.
- Per-layer weights stack on a leading L axis; Qwen3's ``q_norm``/``k_norm``
  are read when ``model_type == "qwen3"``.
- Mixtral's ``block_sparse_moe.experts.{e}.w1/w3/w2`` stack on the experts
  axis (``[L, E, D, F]`` / ``[L, E, F, D]``) and ``gate`` maps to ``router``.
- Without ``lm_head.weight`` the embeddings are tied.

Unlike the JAX converter, which casts every tensor to f32 numpy and stacks
the layers on the host, this one keeps the checkpoint's dtype, moves one
tensor at a time to the target device and copies it, transposed and cast,
into preallocated ``[L, ...]`` tensors there: host memory stays about one
tensor plus the file mapping (the safetensors files are mapped, not read).

``config_from_hf`` takes the parsed ``config.json`` as well as a
transformers config object. A raw ``config.json`` lacks the keys that equal
the model class's defaults (``save_pretrained`` leaves them out), which
``AutoConfig`` would fill in, so the defaults of the keys read here are kept
per ``model_type`` (``HF_DEFAULTS``). ``rope_scaling`` and
``sliding_window`` are not read, as the JAX converter does not read them.

CLI (no ``transformers`` needed)::

    python -m llm_d_inference_scheduler_tpu_torch.models.convert_hf SRC OUT \\
        [--dtype bfloat16] [--device cuda]

writes ``OUT/model_config.json`` (the JAX CLI's fields and values) and
``OUT/model.safetensors`` (``engine/checkpoint.py``), which the engine
serves with ``--model OUT``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any

import torch

from ..parallel import serve as par
from ..parallel.shardings import param_splits, put_split
from ..utils.device import resolve_device, torch_dtype
from . import safetensors_io
from .configs import ModelConfig
from .llama import nested_params, param_shapes

__all__ = ["HF_DEFAULTS", "config_from_hf", "convert_state_dict",
           "load_hf_state_dict", "main"]

# What AutoConfig fills in for a key absent from config.json: the defaults
# of transformers' LlamaConfig, MixtralConfig and Qwen3Config (None where
# the class derives the value: kv heads = attention heads, head_dim =
# hidden / heads).
HF_DEFAULTS: dict[str, dict[str, Any]] = {
    "llama": {"vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
              "num_hidden_layers": 32, "num_attention_heads": 32,
              "num_key_value_heads": None, "head_dim": None,
              "max_position_embeddings": 2048, "rms_norm_eps": 1e-6,
              "rope_theta": 10_000.0},
    "mixtral": {"vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
                "num_hidden_layers": 32, "num_attention_heads": 32,
                "num_key_value_heads": 8, "head_dim": None,
                "max_position_embeddings": 4096 * 32, "rms_norm_eps": 1e-5,
                "rope_theta": 1e6, "num_experts_per_tok": 2, "num_local_experts": 8},
    "qwen3": {"vocab_size": 151936, "hidden_size": 4096, "intermediate_size": 22016,
              "num_hidden_layers": 32, "num_attention_heads": 32,
              "num_key_value_heads": 32, "head_dim": 128,
              "max_position_embeddings": 32768, "rms_norm_eps": 1e-6,
              "rope_theta": 10_000.0},
}


def config_from_hf(hf_config, name: str = "converted") -> ModelConfig:
    """A transformers Llama/Mixtral/Qwen3 config, or its parsed
    ``config.json``, as a ModelConfig."""
    if isinstance(hf_config, dict):
        defaults = HF_DEFAULTS.get(hf_config.get("model_type", ""), {})

        def get(key, fallback=None):
            v = hf_config.get(key)
            if v is None:
                v = defaults.get(key)
            return fallback if v is None else v
    else:
        def get(key, fallback=None):
            v = getattr(hf_config, key, None)
            return fallback if v is None else v

    def need(key):
        v = get(key)
        if v is None:
            raise KeyError(f"HF config has no {key!r}")
        return v

    heads = need("num_attention_heads")
    default_hd = need("hidden_size") // heads
    explicit_hd = get("head_dim") or 0
    return ModelConfig(
        name=name,
        vocab_size=need("vocab_size"),
        d_model=need("hidden_size"),
        n_layers=need("num_hidden_layers"),
        n_heads=heads,
        n_kv_heads=get("num_key_value_heads", heads),
        d_ff=need("intermediate_size"),
        rope_theta=get("rope_theta", 10_000.0),
        max_seq_len=get("max_position_embeddings", 8192),
        norm_eps=need("rms_norm_eps"),
        n_experts=get("num_local_experts", 0),
        experts_per_token=get("num_experts_per_tok", 2),
        head_dim_override=(explicit_hd if explicit_hd != default_hd else 0),
        qk_norm=get("model_type", "") == "qwen3",
    )


def load_hf_state_dict(src: str) -> dict[str, torch.Tensor]:
    """An HF checkpoint directory's tensors on the CPU: every
    ``*.safetensors`` file mapped (``safetensors_io``), else the
    ``pytorch_model*.bin`` files through ``torch.load(weights_only=True)``."""
    sd: dict[str, torch.Tensor] = {}
    st_files = sorted(glob.glob(os.path.join(src, "*.safetensors")))
    for f in st_files:
        sd.update(safetensors_io.load_file(f))
    if st_files:
        return sd
    bins = sorted(glob.glob(os.path.join(src, "pytorch_model*.bin")))
    if not bins:
        raise FileNotFoundError(f"no safetensors or torch bins under {src}")
    for f in bins:
        sd.update(torch.load(f, map_location="cpu", weights_only=True, mmap=True))
    return sd


def convert_state_dict(state_dict: dict[str, torch.Tensor], cfg: ModelConfig,
                       dtype: str | torch.dtype | None = None,
                       device: str | torch.device = "cuda",
                       layout: par.ServeLayout | None = None):
    """An HF Llama/Mixtral/Qwen3 state dict as the port's params on
    ``device`` in ``dtype`` (default: the config's), one tensor moved at a
    time into the preallocated stacked tensors. With ``layout`` each tensor
    is split as it is read (by stage first, then over tp/ep) into every
    rank's preallocated shard (``ShardedParams``; no device holds the whole
    model)."""
    dt = torch_dtype(dtype or cfg.dtype)
    sharded = layout is not None
    if sharded:
        par.validate_degrees(cfg, layout.tp, layout.ep, layout.pp)
    else:
        layout = par.ServeLayout((resolve_device(device),))
    device = layout.first_device
    E = cfg.n_experts
    shapes = param_shapes(cfg)
    splits = param_splits(cfg)
    ranks = list(layout.ranks())  # this process's
    # Each rank's share of each tensor (its stage's layers, split over
    # tp/ep; the embedding, final norm and head on stage 0 only).
    outs: list[dict[str, torch.Tensor]] = [{} for _ in ranks]
    for name, shape in shapes.items():
        views = par.rank_views(name, torch.empty(shape, device="meta"), cfg, layout)
        for (r, _, _), out in zip(ranks, outs):
            if views[r] is not None:
                out[name] = torch.empty(views[r].shape, dtype=dt, device=layout.devices[r])

    def get(key):
        if key not in state_dict:
            raise KeyError(f"checkpoint missing {key!r}")
        return state_dict[key]

    def put(name: str, index: tuple[int, ...], key: str, linear: bool) -> None:
        src = get(key).to(device)
        if linear:
            src = src.t()
        want = shapes[name][len(index):]
        if tuple(src.shape) != want:  # copy_ would broadcast a wrong shape
            raise ValueError(f"{key} is {tuple(get(key).shape)}, which does not "
                             f"fit {want} (linear: {linear})")
        for (r, tr, er), out in zip(ranks, outs):
            if name not in out:
                continue
            idx, full = index, shapes[name]
            if name.startswith("layers."):
                # The stage's slab: layer i lands at i - first, or nowhere.
                first, n = par.stage_layers(cfg.n_layers, layout.stage_of(r), layout.pp)
                if not first <= index[0] < first + n:
                    continue
                idx, full = (index[0] - first, *index[1:]), (n, *full[1:])
            put_split(out[name], idx, src, full, splits[name], tr,
                      layout.tp, er, layout.ep)

    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        keys = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
                "wv": "self_attn.v_proj", "wo": "self_attn.o_proj"}
        if E:
            keys["router"] = "block_sparse_moe.gate"
        else:
            keys |= {"w1": "mlp.gate_proj", "w3": "mlp.up_proj", "w2": "mlp.down_proj"}
        for name, hf in keys.items():
            put(f"layers.{name}", (i,), f"{p}{hf}.weight", linear=True)
        for e in range(E):
            for w in ("w1", "w2", "w3"):
                put(f"layers.{w}", (i, e),
                    f"{p}block_sparse_moe.experts.{e}.{w}.weight", linear=True)
        norms = {"ln_attn": "input_layernorm", "ln_mlp": "post_attention_layernorm"}
        if cfg.qk_norm:
            norms |= {"q_norm": "self_attn.q_norm", "k_norm": "self_attn.k_norm"}
        for name, hf in norms.items():
            put(f"layers.{name}", (i,), f"{p}{hf}.weight", linear=False)
    put("embed", (), "model.embed_tokens.weight", linear=False)
    put("final_norm", (), "model.norm.weight", linear=False)
    if "lm_head.weight" in state_dict:
        put("lm_head", (), "lm_head.weight", linear=True)
    else:  # tied embeddings (a rank's vocab columns are its embed rows)
        for out in outs:
            if "lm_head" in out:
                out["lm_head"].copy_(out["embed"].t())
    if sharded:
        by_rank = {r: out for (r, _, _), out in zip(ranks, outs)}
        return par.from_rank_lists(
            {name: [by_rank.get(r, {}).get(name) for r in range(len(layout.devices))]
             for name in shapes}, layout)
    return nested_params(outs[0])


def main(argv: list[str] | None = None) -> None:
    import argparse

    from ..engine.checkpoint import save_params

    ap = argparse.ArgumentParser(
        description="Convert an HF Llama/Mixtral/Qwen3 checkpoint to the PyTorch "
                    "engine's converted directory (model_config.json + "
                    "model.safetensors in the stacked layout).")
    ap.add_argument("src", help="HF checkpoint dir (config.json + weights)")
    ap.add_argument("out", help="output directory")
    ap.add_argument("--dtype", default=None, help="override param dtype")
    ap.add_argument("--device", default="cuda",
                    help="device the stacked tensors are built on ('cpu' when asked)")
    args = ap.parse_args(argv)

    with open(os.path.join(args.src, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    params = convert_state_dict(load_hf_state_dict(args.src), cfg, device=args.device)
    n_bytes = save_params(args.out, params)
    with open(os.path.join(args.out, "model_config.json"), "w") as f:
        json.dump({k: getattr(cfg, k) for k in cfg.__dataclass_fields__}, f,
                  indent=2)
    print(f"wrote {args.out} ({cfg.n_layers}L d{cfg.d_model} "
          f"{'moe' if cfg.n_experts else 'dense'}, {n_bytes} bytes)")


if __name__ == "__main__":
    main()
