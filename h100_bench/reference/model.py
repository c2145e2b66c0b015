"""Plain PyTorch reference of the benchmark's models: Llama-family decoders
with Qwen3's per-head q/k RMSNorm and Mixtral's top-k expert FFN, as their
model cards describe them.

It computes in float32, layer by layer over every sequence it is given,
casting each layer's weights from the benchmark's tensors as it reaches
them, so that it fits beside those weights on the card. It imports only
torch: no kernel, cache or batching of the program under test. With
``tf32`` its matmuls round their inputs to TF32 (10 stored mantissa bits,
float32 sums): the bf16 weights pass exactly, the activations keep three
bits more than the bf16 program's, and the reference runs several times
faster; without it, TF32 is off.

``quant="fp8"`` is the control: every decoder matmul with its weight
quantized per output column and its input per row to float8 e4m3 (the
scheme of fp8 serving), accumulated in float32. The embedding, the router
and the head stay as they are, as fp8 serving keeps them.

Departures from the published models: none in the equations. The weights
are the benchmark's random draws, and the reference reads positions
0..len-1 of each sequence with no cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

Q_BLOCK = 512          # query rows per attention block: [H, 512, T] f32 scores
FFN_ROWS = 8192        # token rows per FFN block
FP8_MAX = 448.0        # largest finite float8 e4m3fn value


@dataclasses.dataclass(frozen=True)
class Arch:
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    rope_theta: float
    eps: float
    n_experts: int
    top_k: int
    qk_norm: bool

    @classmethod
    def from_config(cls, c: dict[str, Any]) -> "Arch":
        """From a configuration file's published ``config.json`` keys."""
        h = int(c["num_attention_heads"])
        return cls(vocab=int(c["vocab_size"]), d_model=int(c["hidden_size"]),
                   n_layers=int(c["num_hidden_layers"]), n_heads=h,
                   n_kv_heads=int(c["num_key_value_heads"]),
                   head_dim=int(c.get("head_dim") or int(c["hidden_size"]) // h),
                   d_ff=int(c["intermediate_size"]), rope_theta=float(c["rope_theta"]),
                   eps=float(c["rms_norm_eps"]),
                   n_experts=int(c.get("num_local_experts") or 0),
                   top_k=int(c.get("num_experts_per_tok") or 0),
                   qk_norm=c.get("model_type") == "qwen3")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax maps to the largest finite value), back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Linear:
    """x @ w in float32, or through the fp8 control's rounding."""

    def __init__(self, quant: str | None):
        self.quant = quant

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, 0) if self.quant == "fp8" else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant == "fp8":
            x = _fp8(x, -1)
        return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on the two halves of each head (``rotate_half``).
    x [T, H, Dh], pos [T]."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention of one sequence, q [T, H, Dh], k/v [T, Hkv,
    Dh] (grouped-query: head h reads kv head h // (H / Hkv)), in query
    blocks of Q_BLOCK rows."""
    T, H, Dh = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)          # [H, T, Dh]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, T, Q_BLOCK):
        b = min(T, a + Q_BLOCK)
        s = torch.einsum("qhd,htd->hqt", q[a:b], k[:, :b]) / Dh ** 0.5
        mask = torch.arange(b, device=q.device)[None, :] <= torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(~mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqt,htd->qhd", torch.softmax(s, dim=-1), v[:, :b])
    return out


def _ffn(arch: Arch, lin: _Linear, lw: dict, h: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN, w1 the gate and w3 the up projection; with experts, each
    token's top-k experts by router logit, weighted by a softmax over those
    k logits (Mixtral's renormalised top-k)."""
    if not arch.n_experts:
        w1, w3, w2 = (lin.weight(lw[n]) for n in ("w1", "w3", "w2"))
        return lin(F.silu(lin(h, w1)) * lin(h, w3), w2)
    logits = h @ lw["router"].float()
    top, idx = torch.topk(logits, arch.top_k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(h)
    for e in range(arch.n_experts):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        w1, w3, w2 = (lin.weight(lw[n][e]) for n in ("w1", "w3", "w2"))
        x = h[tok]
        y = lin(F.silu(lin(x, w1)) * lin(x, w3), w2)
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


@torch.no_grad()
def logits_at(params: dict, arch: Arch, seqs: list[list[int]],
              positions: list[list[int]], *, quant: str | None = None,
              tf32: bool = False, device: str | torch.device = "cuda"
              ) -> list[torch.Tensor]:
    """float32 logits [len(positions[i]), vocab] of each sequence at the
    given positions (the logits there predict the token after that
    position). ``params`` is the benchmark's weight dict (stacked layers)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        lin = _Linear(quant)
        Dh, lp = arch.head_dim, params["layers"]
        xs = [params["embed"][torch.tensor(s, device=device)].float() for s in seqs]
        pos = [torch.arange(len(s), device=device) for s in seqs]
        for li in range(arch.n_layers):
            lw = {n: t[li] for n, t in lp.items()}
            wq, wk, wv, wo = (lin.weight(lw[n]) for n in ("wq", "wk", "wv", "wo"))
            for i, x in enumerate(xs):
                T = x.shape[0]
                h = rms_norm(x, lw["ln_attn"], arch.eps)
                q = lin(h, wq).view(T, arch.n_heads, Dh)
                k = lin(h, wk).view(T, arch.n_kv_heads, Dh)
                v = lin(h, wv).view(T, arch.n_kv_heads, Dh)
                if arch.qk_norm:
                    q = rms_norm(q, lw["q_norm"], arch.eps)
                    k = rms_norm(k, lw["k_norm"], arch.eps)
                q, k = rope(q, pos[i], arch.rope_theta), rope(k, pos[i], arch.rope_theta)
                xs[i] = x + lin(attention(q, k, v).reshape(T, -1), wo)
            del wq, wk, wv, wo
            # The FFN is per token: all sequences' rows together, in blocks.
            x = torch.cat(xs)
            for a in range(0, x.shape[0], FFN_ROWS):
                r = x[a:a + FFN_ROWS]
                x[a:a + FFN_ROWS] = r + _ffn(arch, lin, lw, rms_norm(r, lw["ln_mlp"], arch.eps))
            xs = list(torch.split(x, [len(s) for s in seqs]))
        head = params["lm_head"].float()
        out = []
        for x, p in zip(xs, positions):
            rows = x[torch.tensor(p, device=device)]
            out.append(rms_norm(rows, params["final_norm"], arch.eps) @ head)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
