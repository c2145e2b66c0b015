"""The cell's weights, drawn on the device from the run's seed.

The layout is the port's parameter dict (``models/llama.py``): layer weights
stacked on a leading ``[L, ...]`` axis, matmul weights ``[in, out]``, MoE
FFN weights on an experts axis beside a ``router``. Each tensor is drawn
whole in the served dtype by one ``torch.randn`` on a ``torch.Generator`` on
the card, then scaled by ``fan_in ** -0.5``; a norm weight is
``1 + 0.1 * normal``, drawn alike, so that a norm's multiply, and which
norm is which, shows in the logits. The reference (``reference/model.py``)
reads the same tensors.
"""

from __future__ import annotations

import torch

SEED_MASK = 2**63 - 1


def shapes(mcfg) -> dict[str, tuple[tuple[int, ...], int]]:
    """name -> (shape, fan_in), 0 for a norm weight (around 1)."""
    L, D, F, V = mcfg.n_layers, mcfg.d_model, mcfg.d_ff, mcfg.vocab_size
    Hq, Hkv, Dh, E = mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim, mcfg.n_experts
    ex = (E,) if E else ()
    out = {"embed": ((V, D), D),
           "layers.wq": ((L, D, Hq * Dh), D), "layers.wk": ((L, D, Hkv * Dh), D),
           "layers.wv": ((L, D, Hkv * Dh), D), "layers.wo": ((L, Hq * Dh, D), Hq * Dh),
           "layers.w1": ((L, *ex, D, F), D), "layers.w2": ((L, *ex, F, D), F),
           "layers.w3": ((L, *ex, D, F), D),
           "layers.ln_attn": ((L, D), 0), "layers.ln_mlp": ((L, D), 0)}
    if mcfg.qk_norm:
        out |= {"layers.q_norm": ((L, Dh), 0), "layers.k_norm": ((L, Dh), 0)}
    if E:
        out["layers.router"] = ((L, D, E), D)
    return out | {"final_norm": ((D,), 0), "lm_head": ((D, V), D)}


def draw(mcfg, seed: int, device, dtype: torch.dtype) -> dict:
    """The nested parameter dict of ``mcfg`` for ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    params: dict = {"layers": {}}
    for name, (shape, fan_in) in shapes(mcfg).items():
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        if fan_in:
            t.mul_(fan_in ** -0.5)
        else:
            t.mul_(0.1).add_(1.0)
        if name.startswith("layers."):
            params["layers"][name[len("layers."):]] = t
        else:
            params[name] = t
    return params
