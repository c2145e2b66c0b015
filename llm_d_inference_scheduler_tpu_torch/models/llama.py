"""Dense Llama-family model in PyTorch (port of ``llm_d_inference_scheduler_tpu/models/llama.py``).

- Parameters are a plain dict with the JAX package's keys and layout: layer
  weights stacked on a leading ``[L, ...]`` axis, matmul weights ``[in, out]``
  (``x @ w``), so ``models/convert_jax.py`` carries JAX weights over as they
  are. The layer loop is a Python loop over per-layer views.
- Matmuls run in the parameters' dtype with f32 norm/rope/softmax
  accumulation; logits are f32.
- Paged KV pages are ``[L, N, block, Hkv, Dh]``. Where the JAX functions
  return new page arrays (donated, so updated in place on the device), these
  functions write the pages in place and return the same tensors.
- ``decode_step`` takes the paged-attention function as a parameter,
  defaulting to the CUDA kernel's wrapper (which computes the plain version
  on CPU tensors) — the counterpart of the JAX ``use_pallas`` switch.
- MoE configs (Mixtral family) stack the FFN weights on an experts axis
  ``[L, E, D, F]`` beside a per-layer ``router`` ``[L, D, E]``; ``_ffn``
  dispatches on the parameters, so every path serves both families.
  ``cfg.moe_impl == "grouped"`` takes the grouped path (kernel K2), else the
  dense-over-experts ``_moe_ffn``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..ops.attention import causal_attention
from ..ops.moe import moe_ffn_grouped, top_k_gates
from ..ops.norms import rms_norm
from ..ops.paged_attention import paged_decode_attention_cuda
from ..ops.rope import apply_rope, rope_table
from ..utils.device import resolve_device, torch_dtype
from .configs import ModelConfig

Params = dict[str, Any]


def init_params(cfg: ModelConfig, device: str | torch.device = "cuda",
                dtype: str | torch.dtype | None = None,
                generator: torch.Generator | None = None) -> Params:
    """Random-init parameters in the stacked-layer layout, drawn directly on
    ``device`` in ``dtype`` (a full-width f32 draw on the host would need
    ~32 GB for llama3-8b). Normal(0, 1) * fan_in**-0.5, as the JAX package.
    MoE configs get expert-stacked FFN weights and a router."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    E = cfg.n_experts
    ffn_shape = (L, E, D, F_) if E else (L, D, F_)
    down_shape = (L, E, F_, D) if E else (L, F_, D)

    def w(shape, fan_in):
        t = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return t.mul_(fan_in ** -0.5)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    embed = w((V, D), D)
    layers = {
        "wq": w((L, D, Hq * Dh), D),
        "wk": w((L, D, Hkv * Dh), D),
        "wv": w((L, D, Hkv * Dh), D),
        "wo": w((L, Hq * Dh, D), Hq * Dh),
        "w1": w(ffn_shape, D),
        "w2": w(down_shape, F_),
        "w3": w(ffn_shape, D),
        "ln_attn": ones((L, D)),
        "ln_mlp": ones((L, D)),
    }
    if cfg.qk_norm:
        layers["q_norm"] = ones((L, Dh))
        layers["k_norm"] = ones((L, Dh))
    if E:
        layers["router"] = w((L, D, E), D)
    return {"embed": embed, "layers": layers, "final_norm": ones((D,)),
            "lm_head": w((D, V), D)}


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The shape of every parameter ``init_params`` draws, flattened to
    ``embed``, ``layers.wq``, ... (the names of a converted checkpoint)."""
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hq, Hkv, Dh, E = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_experts
    experts = (E,) if E else ()
    shapes = {"embed": (V, D), "layers.wq": (L, D, Hq * Dh),
              "layers.wk": (L, D, Hkv * Dh), "layers.wv": (L, D, Hkv * Dh),
              "layers.wo": (L, Hq * Dh, D), "layers.w1": (L, *experts, D, F_),
              "layers.w2": (L, *experts, F_, D), "layers.w3": (L, *experts, D, F_),
              "layers.ln_attn": (L, D), "layers.ln_mlp": (L, D)}
    if cfg.qk_norm:
        shapes |= {"layers.q_norm": (L, Dh), "layers.k_norm": (L, Dh)}
    if E:
        shapes["layers.router"] = (L, D, E)
    return shapes | {"final_norm": (D,), "lm_head": (D, V)}


def flat_params(params: Params) -> dict[str, torch.Tensor]:
    """``params`` under the flat names of ``param_shapes``."""
    flat = {k: v for k, v in params.items() if k != "layers"}
    return flat | {f"layers.{k}": v for k, v in params["layers"].items()}


def nested_params(flat: dict[str, torch.Tensor]) -> Params:
    """The inverse of ``flat_params``."""
    params: Params = {"layers": {}}
    for name, t in flat.items():
        if name.startswith("layers."):
            params["layers"][name[len("layers."):]] = t
        else:
            params[name] = t
    return params


def layer_params(params: Params) -> list[dict[str, torch.Tensor]]:
    """Per-layer views of the stacked layer weights (no copies)."""
    stacked = params["layers"]
    per_key = {k: torch.unbind(v) for k, v in stacked.items()}
    n = len(next(iter(per_key.values())))
    return [{k: per_key[k][i] for k in per_key} for i in range(n)]


def qk_normed(cfg: ModelConfig, lp: Params, q: torch.Tensor,
              k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen3-family per-head RMSNorm on q/k before RoPE (no-op for weights
    without q_norm/k_norm)."""
    if "q_norm" in lp:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    return q, k


def _moe_ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    """Top-k mixture-of-experts FFN (Mixtral-style), dense over experts: every
    expert runs on every token and the one-hot routing weights zero the rest.
    Rounds where the JAX einsums do: router logits in h's dtype then f32,
    expert products and the weights (a one-hot in h's dtype times the gates
    cast to it) in h's dtype. h [..., D] -> [..., D]."""
    D = h.shape[-1]
    x = h.reshape(-1, D)
    gates, top_idx = top_k_gates((x @ lp["router"]).float(), cfg.experts_per_token)
    onehot = F.one_hot(top_idx, cfg.n_experts).to(h.dtype)       # [T, k, E]
    weights = torch.einsum("tke,tk->te", onehot, gates.to(h.dtype))
    # [T, D] @ [E, D, F] broadcasts to [E, T, F] without copying the weights.
    up = torch.matmul(x, lp["w1"])
    gate = torch.matmul(x, lp["w3"])
    out = torch.matmul(F.silu(up) * gate, lp["w2"])               # [E, T, D]
    return torch.einsum("etd,te->td", out, weights).reshape(h.shape)


def _ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    """Dense or MoE SwiGLU FFN, dispatched on the layer's parameters. Both
    MoE forms take any leading shape, so the JAX decode squeeze ([B, D] ->
    [B, 1, D]) has no counterpart here."""
    if "router" in lp:
        if cfg.moe_impl == "grouped":
            return moe_ffn_grouped(lp, h, cfg.n_experts, cfg.experts_per_token)
        return _moe_ffn(cfg, lp, h)
    return (F.silu(h @ lp["w1"]) * (h @ lp["w3"])) @ lp["w2"]


def _qkv(cfg: ModelConfig, lp: Params, x: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention-norm, projections, QK-norm and RoPE for x [B, S, D]."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, cfg.n_heads, Dh)
    k = (h @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, Dh)
    v = (h @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, Dh)
    q, k = qk_normed(cfg, lp, q, k)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _finish_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                  attn: torch.Tensor) -> torch.Tensor:
    x = x + attn.reshape(*x.shape[:-1], -1) @ lp["wo"]
    h = rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
    return x + _ffn(cfg, lp, h)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                     # [B, S] int
    positions: torch.Tensor | None = None,    # [B, S]
    *,
    want_kv: bool = False,
    want_hidden: bool = False,
    kv_valid: torch.Tensor | None = None,     # [B, S] padding mask
    mm_embeds: torch.Tensor | None = None,    # [B, M, D] multimodal vectors
    mm_positions: torch.Tensor | None = None,  # [B, M] target positions
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """Full-sequence forward (prefill). Returns (logits [B, S, V] f32 — or
    the final-norm hidden states [B, S, D] as f32 with ``want_hidden`` —,
    (K, V) each [L, B, S, Hkv, Dh] if ``want_kv``).

    Multimodal prefill (E/P/D): ``mm_embeds`` replace the token embeddings
    at ``mm_positions`` (encoder outputs spliced in at placeholder tokens),
    cast to the embeddings' dtype; a position ``>= S`` (a caller's padding)
    is dropped, as the JAX scatter's ``mode="drop"`` drops it."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    x = params["embed"][tokens.long()]
    if mm_embeds is not None:
        x = _splice(x, mm_embeds, mm_positions)
    ks, vs = [], []
    for lp in layer_params(params):
        q, k, v = _qkv(cfg, lp, x, cos, sin)
        attn = causal_attention(q, k, v, q_positions=positions,
                                kv_positions=positions, kv_valid=kv_valid)
        x = _finish_layer(cfg, lp, x, attn)
        if want_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs)) if want_kv else None
    if want_hidden:
        return x.float(), kv
    return (x @ params["lm_head"]).float(), kv


def _splice(x: torch.Tensor, mm_embeds: torch.Tensor,
            mm_positions: torch.Tensor) -> torch.Tensor:
    """``x`` [B, S, D] with rows ``mm_positions`` [B, M] overwritten by
    ``mm_embeds`` [B, M, D]. Indexing raises on an out-of-range position
    where the JAX scatter drops it, so such positions (negative ones count
    from the end, as in JAX) write a scratch row past the end, sliced off
    afterwards: no host sync to filter them."""
    B, S, D = x.shape
    pos = mm_positions.long()
    pos = torch.where(pos < 0, pos + S, pos)
    pos = torch.where((pos >= 0) & (pos < S), pos, torch.full_like(pos, S))
    rows = torch.arange(B, device=x.device)[:, None].expand_as(pos)
    out = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)
    out[rows, pos] = mm_embeds.to(x.dtype)
    return out[:, :S]


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B] current input token per sequence
    positions: torch.Tensor,     # [B] 0-based position of that token
    k_pages: torch.Tensor,       # [L, N_blocks, block, Hkv, Dh]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    paged_attention: Callable[..., torch.Tensor] = paged_decode_attention_cuda,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step with paged KV; returns (logits [B, V] f32, k_pages,
    v_pages), the pages updated in place.

    The layer loop only reads the pages; the current token attends to itself
    through the ``cur_k``/``cur_v`` column, and all layers' current-token KV
    is written afterwards with one scatter per page tensor. Inactive lanes
    point their block table at the trash block 0. A lane that has passed its
    block table (a fused decode chunk keeps stepping a finished lane) writes
    through the table's last entry, clamped explicitly here (JAX clamps the
    gather index silently); the kernel bounds its page walk the same way.
    """
    B = tokens.shape[0]
    block = k_pages.shape[2]
    W = block_tables.shape[1]
    Dh = cfg.head_dim
    positions = positions.to(torch.int32)
    cos, sin = rope_table(positions, Dh, cfg.rope_theta)     # [B, half]
    seq_lens = positions + 1
    lane = torch.arange(B, device=tokens.device)
    blk_idx = block_tables[lane, (positions // block).clamp(max=W - 1).long()].long()
    slot = (positions % block).long()

    x = params["embed"][tokens.long()][:, None]              # [B, 1, D]
    k_cur, v_cur = [], []
    for li, lp in enumerate(layer_params(params)):
        q, k, v = _qkv(cfg, lp, x, cos[:, None], sin[:, None])
        q, k, v = q[:, 0], k[:, 0], v[:, 0]                  # [B, H(kv), Dh]
        attn = paged_attention(q, k_pages[li], v_pages[li], block_tables,
                               seq_lens, k, v)
        x = _finish_layer(cfg, lp, x, attn[:, None])
        k_cur.append(k)
        v_cur.append(v)
    k_pages[:, blk_idx, slot] = torch.stack(k_cur).to(k_pages.dtype)
    v_pages[:, blk_idx, slot] = torch.stack(v_cur).to(v_pages.dtype)

    x = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float(), k_pages, v_pages


def prefill_with_prefix(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [1, S] suffix tokens (may be padded)
    suffix_len: torch.Tensor,    # [1] valid suffix tokens
    prefix_len: torch.Tensor,    # [1] tokens already present in the pages
    k_pages: torch.Tensor,       # [L, N, block, Hkv, Dh]
    v_pages: torch.Tensor,
    block_table_row: torch.Tensor,  # [1, max_blocks] full table (KV scatter)
    prior_table_row: torch.Tensor | None = None,  # [1, P] gather window
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill continuing from cached prefix KV (automatic prefix caching).

    The suffix attends to the cached prefix gathered from the pages plus
    itself causally; its KV is written into the pages at prefix_len + t.
    Returns (last-token logits [1, V] f32, k_pages, v_pages), pages updated
    in place."""
    B, S = tokens.shape
    assert B == 1
    block = k_pages.shape[2]
    if prior_table_row is None:
        prior_table_row = block_table_row
    W = block_table_row.shape[1]
    T = prior_table_row.shape[1] * block
    Dh, Hkv = cfg.head_dim, cfg.n_kv_heads
    dev = tokens.device
    suffix_len = suffix_len.to(dev)
    prefix_len = prefix_len.to(dev)

    t_idx = torch.arange(S, dtype=torch.int32, device=dev)
    positions = prefix_len[:, None].int() + t_idx[None, :]           # [1, S]
    cos, sin = rope_table(positions, Dh, cfg.rope_theta)
    suffix_valid = t_idx[None, :] < suffix_len[:, None]
    prior_pos = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    prior_valid = prior_pos < prefix_len[:, None]
    kv_positions = torch.cat([prior_pos, positions], dim=1)
    kv_valid = torch.cat([prior_valid, suffix_valid], dim=1)
    prior = prior_table_row[0].long()

    x = params["embed"][tokens.long()]
    k_new, v_new = [], []
    for li, lp in enumerate(layer_params(params)):
        q, k, v = _qkv(cfg, lp, x, cos, sin)
        k_prior = k_pages[li][prior].reshape(1, T, Hkv, Dh)
        v_prior = v_pages[li][prior].reshape(1, T, Hkv, Dh)
        attn = causal_attention(q, torch.cat([k_prior, k], dim=1),
                                torch.cat([v_prior, v], dim=1),
                                q_positions=positions,
                                kv_positions=kv_positions, kv_valid=kv_valid)
        x = _finish_layer(cfg, lp, x, attn)
        k_new.append(k[0])
        v_new.append(v[0])

    # Scatter suffix KV at offset positions (padding -> trash block 0).
    tgt = prefix_len[0] + t_idx
    valid = t_idx < suffix_len[0]
    table_blk = block_table_row[0, (tgt // block).clamp(max=W - 1).long()]
    blk_for_t = torch.where(valid, table_blk, torch.zeros_like(table_blk)).long()
    slot_for_t = torch.where(valid, tgt % block, torch.zeros_like(tgt)).long()
    k_pages[:, blk_for_t, slot_for_t] = torch.stack(k_new).to(k_pages.dtype)
    v_pages[:, blk_for_t, slot_for_t] = torch.stack(v_new).to(v_pages.dtype)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[0, (suffix_len[0] - 1).long()][None]
    logits = (last @ params["lm_head"]).float()
    return logits, k_pages, v_pages


def write_prefill_kv(
    k_pages: torch.Tensor,       # [L, N, block, Hkv, Dh]
    v_pages: torch.Tensor,
    k_new: torch.Tensor,         # [L, B, S, Hkv, Dh] from forward(want_kv=True)
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks]
    seq_lens: torch.Tensor,      # [B] valid prompt tokens
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write freshly prefilled KV rows into their pages, in place.

    Token t of sequence b lands in block block_tables[b, t // block] at slot
    t % block; padding tokens (t >= seq_lens[b]) go to the trash block 0."""
    L, B, S, Hkv, Dh = k_new.shape
    block = k_pages.shape[2]
    W = block_tables.shape[1]
    dev = k_pages.device
    t = torch.arange(S, dtype=torch.int32, device=dev)
    blk_for_t = block_tables[:, (t // block).clamp(max=W - 1).long()]  # [B, S]
    valid = t[None, :] < seq_lens.to(dev)[:, None]
    blk_for_t = torch.where(valid, blk_for_t, torch.zeros_like(blk_for_t))
    slot_for_t = torch.where(valid, (t % block)[None, :].expand(B, S),
                             torch.zeros((B, S), dtype=torch.int32, device=dev))
    bidx = blk_for_t.reshape(-1).long()
    sidx = slot_for_t.reshape(-1).long()
    k_pages[:, bidx, sidx] = k_new.reshape(L, B * S, Hkv, Dh).to(k_pages.dtype)
    v_pages[:, bidx, sidx] = v_new.reshape(L, B * S, Hkv, Dh).to(v_pages.dtype)
    return k_pages, v_pages
