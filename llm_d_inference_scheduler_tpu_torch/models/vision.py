"""Vision tower of E/P/D multimodal serving (port of
``llm_d_inference_scheduler_tpu/models/vision.py``).

A compact ViT: the patch embedding is a reshape and a matmul, then pre-norm
transformer blocks over the stacked layer weights, a final norm, and a
projection to the served language model's ``d_model`` so the embeddings
splice into prefill as they are (``models/llama.py`` ``forward``). The
parameters are a plain dict with the JAX package's keys and layout (layers
stacked ``[L, ...]``, matmul weights ``[in, out]``), so
``models/convert_jax.py`` carries the JAX pytree across unchanged. Plain
PyTorch, as the reference tower is plain XLA outside any Pallas kernel,
but for its RMSNorms, which run in K4 (``ops/fused_norm.py``) on CUDA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fused_norm
from ..utils.device import resolve_device, torch_dtype


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    name: str = "vit-tiny"
    image_size: int = 32          # square input, pixels
    patch_size: int = 8
    channels: int = 3
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 128
    out_dim: int = 128            # the language model's d_model
    norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


VIT_TINY = VisionConfig()


def init_vision_params(cfg: VisionConfig, device: str | torch.device = "cuda",
                       generator: torch.Generator | None = None) -> dict:
    """Random-init tower parameters on ``device``: Normal(0, 1) *
    fan_in**-0.5 for the matmul weights and embeddings, ones for the norms
    (the JAX package's scheme; the draws differ, as its RNG does)."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    L, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff

    def w(shape, fan_in):
        t = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return t.mul_(fan_in ** -0.5).to(dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    return {
        "patch_embed": w((cfg.patch_dim, D), cfg.patch_dim),
        "pos_embed": w((cfg.n_patches, D), D),
        "layers": {
            "wqkv": w((L, D, 3 * D), D),
            "wo": w((L, D, D), D),
            "w1": w((L, D, Fd), D),
            "w2": w((L, Fd, D), Fd),
            "ln_attn": ones((L, D)),
            "ln_mlp": ones((L, D)),
        },
        "final_norm": ones((D,)),
        "proj": w((D, cfg.out_dim), D),
    }


def _patchify(cfg: VisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, n_patches, patch_dim], patches in row-major order,
    each flattened as (row, column, channel)."""
    B = pixels.shape[0]
    P = cfg.patch_size
    n = cfg.image_size // P
    x = pixels.reshape(B, n, P, n, P, cfg.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, n, n, P, P, C]
    return x.reshape(B, n * n, cfg.patch_dim)


def encode_image(params: dict, cfg: VisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, C] float -> embeddings [B, n_patches, out_dim]."""
    x = _patchify(cfg, pixels.to(torch_dtype(cfg.dtype)))
    x = x @ params["patch_embed"] + params["pos_embed"][None]
    B, S, D = x.shape
    Hd = cfg.head_dim
    lps = params["layers"]
    for i in range(cfg.n_layers):
        h = fused_norm.rms_norm(x, lps["ln_attn"][i], cfg.norm_eps)
        qkv = (h @ lps["wqkv"][i]).reshape(B, S, 3, cfg.n_heads, Hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / (Hd ** 0.5)
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, S, D)
        x = x + out @ lps["wo"][i]
        h = fused_norm.rms_norm(x, lps["ln_mlp"][i], cfg.norm_eps)
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf.
        x = x + F.gelu(h @ lps["w1"][i], approximate="tanh") @ lps["w2"][i]
    x = fused_norm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["proj"]



def build_tower(out_dim: int, seed: int, device: torch.device) -> tuple[VisionConfig, dict]:
    """A served model's E/P/D tower: ``VIT_TINY`` projecting into the
    model's ``d_model`` (so its rows splice into that model's prefill), its
    weights drawn from ``seed`` on ``device``."""
    vcfg = dataclasses.replace(VIT_TINY, out_dim=out_dim)
    gen = torch.Generator(device=device).manual_seed(seed)
    return vcfg, init_vision_params(vcfg, device, gen)


def encode_to_host(vcfg: VisionConfig, params: dict, pixels: np.ndarray,
                   device: torch.device) -> np.ndarray:
    """The tower over ``pixels`` [N, H, W, C] as host f32 embeddings
    [N * n_patches, out_dim], item after item."""
    px = torch.from_numpy(np.ascontiguousarray(pixels, np.float32)).to(device)
    with torch.no_grad():
        out = encode_image(params, vcfg, px)
    return out.reshape(-1, out.shape[-1]).float().cpu().numpy()
