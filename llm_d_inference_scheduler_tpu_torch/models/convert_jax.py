"""Carry the JAX package's parameter pytree over to the port's tensors.

The two packages share one layout (same keys, layers stacked ``[L, ...]``,
matmul weights ``[in, out]``), so conversion is a leaf-wise copy. The input
is the pytree as numpy arrays (``jax.tree.map(np.asarray, params)``), which
keeps this module free of JAX; the tests use it to give both stacks the same
weights. A sharded or staged engine (``tp_size``/``ep_size``/``pp_size`` >
1) splits the full weights this returns (``parallel.serve.shard_params``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils.device import resolve_device, torch_dtype


def params_from_numpy(tree: Any, device: str | torch.device = "cuda",
                      dtype: str | torch.dtype | None = None) -> Any:
    """Map every numpy leaf of ``tree`` to a tensor on ``device`` (cast to
    ``dtype`` when given, else kept in its own floating dtype)."""
    device = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        arr = np.array(x)  # a writable host copy
        if str(arr.dtype) == "bfloat16":
            # ml_dtypes bfloat16 has no torch mapping: go through f32 (exact).
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if dt is not None and t.is_floating_point():
            t = t.to(dt)
        return t.to(device)

    return conv(tree)
