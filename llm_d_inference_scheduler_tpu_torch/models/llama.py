"""Dense Llama-family model in PyTorch (port of ``llm_d_inference_scheduler_tpu/models/llama.py``).

- Parameters are a plain dict with the JAX package's keys and layout: layer
  weights stacked on a leading ``[L, ...]`` axis, matmul weights ``[in, out]``
  (``x @ w``), so ``models/convert_jax.py`` carries JAX weights over as they
  are. The layer loop is a Python loop over per-layer views.
- Matmuls run in the parameters' dtype with f32 norm/rope/softmax
  accumulation; logits are f32. On CUDA the norms and RoPE run in kernel
  K4 (``ops/fused_norm.py``), which has no backward: the train step passes
  the eager functions (``forward``'s ``norms``).
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
- Tensor/expert/pipeline parallel (``parallel/serve.py``): every function
  also takes ``ShardedParams``, one dict per rank. The ranks form pipeline
  stages (one without ``pp``), each holding its slab of the layers and run
  in turn; within a stage attention runs per ``tp`` rank on its local
  heads and its own pages (then a list of page tensors, one per (stage,
  tp) rank), with one sum after ``wo`` and one after ``w2``; the embedding
  is a masked lookup per vocab shard and a sum, the logits are gathered,
  both on stage 0. One rank runs the same code with no sum, no gather and
  no hop: single-device serving is that case.
- Multi-process (``engine/multihost.py``): a process holds some of the
  ranks and runs only those. Without pp its tp ranks' partial sums and
  vocab slices take a second leg over the group (``par.reduce_sum``,
  ``par.gather_last``); under pp it runs only the stages it holds, in turn
  order, and the activation hops to the next stage's process by a send and
  a receive (``_Model.hop``). Functions return the head's outputs (logits,
  hidden states) on the processes that hold stage 0 and None elsewhere.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..ops import fused_norm
from ..ops.attention import causal_attention
from ..ops.moe import moe_ffn_grouped, top_k_gates
from ..ops.paged_attention import paged_decode_attention_cuda
from ..ops.prefill_attention import prefill_attention
from ..ops.rope import rope_table
from ..parallel import serve as par
from ..utils.device import resolve_device, torch_dtype
from .configs import ModelConfig

Params = dict[str, Any]


def init_params(cfg: ModelConfig, device: str | torch.device = "cuda",
                dtype: str | torch.dtype | None = None,
                generator: torch.Generator | None = None,
                layout: par.ServeLayout | None = None) -> Params:
    """Random-init parameters in the stacked-layer layout, drawn directly on
    ``device`` in ``dtype`` (a full-width f32 draw on the host would need
    ~32 GB for llama3-8b). Normal(0, 1) * fan_in**-0.5, as the JAX package.
    MoE configs get expert-stacked FFN weights and a router. With ``layout``
    the same full weights are drawn one tensor at a time on the layout's
    first (local) device and split into its shards (``ShardedParams``): the
    counterpart of the JAX ``init_sharded_params`` and ``init_pp_params``.
    Every process of a group draws the same full tensors from the same seed
    and keeps its own ranks' shards."""
    if layout is not None:
        par.validate_degrees(cfg, layout.tp, layout.ep, layout.pp)
        device = layout.first_device
    device = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    D, F_ = cfg.d_model, cfg.d_ff
    shapes = param_shapes(cfg)
    flat: dict[str, Any] = {}

    def keep(name, t):
        flat[name] = t if layout is None else par.split_to_ranks(name, t, cfg, layout)

    def w(name, fan_in):
        t = torch.randn(shapes[name], generator=generator, device=device, dtype=dtype)
        keep(name, t.mul_(fan_in ** -0.5))

    def ones(name):
        keep(name, torch.ones(shapes[name], device=device, dtype=dtype))

    # The draw order fixes the weights a seed gives.
    w("embed", D)
    for name, fan_in in (("wq", D), ("wk", D), ("wv", D),
                         ("wo", cfg.n_heads * cfg.head_dim), ("w1", D), ("w2", F_),
                         ("w3", D)):
        w(f"layers.{name}", fan_in)
    for name in ("ln_attn", "ln_mlp") + (("q_norm", "k_norm") if cfg.qk_norm else ()):
        ones(f"layers.{name}")
    if cfg.n_experts:
        w("layers.router", D)
    ones("final_norm")
    w("lm_head", D)
    if layout is not None:
        return par.from_rank_lists(flat, layout)
    return nested_params(flat)


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
    params: Params = {}
    for name, t in flat.items():
        if name.startswith("layers."):
            params.setdefault("layers", {})[name[len("layers."):]] = t
        else:
            params[name] = t
    return params


def layer_params(params: Params) -> list[dict[str, torch.Tensor]]:
    """Per-layer views of the stacked layer weights (no copies)."""
    stacked = params["layers"]
    per_key = {k: torch.unbind(v) for k, v in stacked.items()}
    n = len(next(iter(per_key.values())))
    return [{k: per_key[k][i] for k in per_key} for i in range(n)]


def _moe_ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor,
             ep_rank: int = 0, ep: int = 1) -> torch.Tensor:
    """Top-k mixture-of-experts FFN (Mixtral-style), dense over experts: every
    expert runs on every token and the one-hot routing weights zero the rest.
    Rounds where the JAX einsums do: router logits in h's dtype then f32,
    expert products and the weights (a one-hot in h's dtype times the gates
    cast to it) in h's dtype. h [..., D] -> [..., D]. Under ``ep`` the
    layer holds experts ``[ep_rank * E/ep, (ep_rank + 1) * E/ep)`` and the
    result is their part of the sum (the router is replicated, so every rank
    routes alike)."""
    D = h.shape[-1]
    x = h.reshape(-1, D)
    gates, top_idx = top_k_gates((x @ lp["router"]).float(), cfg.experts_per_token)
    onehot = F.one_hot(top_idx, cfg.n_experts).to(h.dtype)       # [T, k, E]
    weights = torch.einsum("tke,tk->te", onehot, gates.to(h.dtype))
    if ep > 1:
        local = cfg.n_experts // ep
        weights = weights[:, ep_rank * local:(ep_rank + 1) * local]
    # [T, D] @ [E, D, F] broadcasts to [E, T, F] without copying the weights.
    up = torch.matmul(x, lp["w1"])
    gate = torch.matmul(x, lp["w3"])
    out = torch.matmul(F.silu(up) * gate, lp["w2"])               # [E, T, D]
    return torch.einsum("etd,te->td", out, weights).reshape(h.shape)


def _ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor, ep_rank: int = 0,
         ep: int = 1) -> torch.Tensor:
    """Dense or MoE SwiGLU FFN, dispatched on the layer's parameters. Both
    MoE forms take any leading shape, so the JAX decode squeeze ([B, D] ->
    [B, 1, D]) has no counterpart here. On a shard the result is that
    rank's partial sum."""
    if "router" in lp:
        if cfg.moe_impl == "grouped":
            return moe_ffn_grouped(lp, h, cfg.n_experts, cfg.experts_per_token)
        return _moe_ffn(cfg, lp, h, ep_rank, ep)
    return (F.silu(h @ lp["w1"]) * (h @ lp["w3"])) @ lp["w2"]


def _qkv(cfg: ModelConfig, lp: Params, x: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor, norms=fused_norm
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention-norm, projections, QK-norm and RoPE for x [B, S, D], over
    the heads the layer's projections hold (all, or a tp rank's). The norms
    and RoPE go through ``norms`` (K4's wrappers, ``ops/fused_norm.py``, or
    ``fused_norm.PLAIN``): the Qwen3 family's per-head q/k RMSNorm where the
    layer holds ``q_norm``/``k_norm``, then RoPE, in one call over q and k."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    h = norms.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, -1, Dh)
    k = (h @ lp["wk"]).reshape(B, S, -1, Dh)
    v = (h @ lp["wv"]).reshape(B, S, -1, Dh)
    q, k = norms.qk_norm_rope(q, k, cos, sin, lp.get("q_norm"), lp.get("k_norm"),
                              cfg.norm_eps)
    return q, k, v


class _Stage:
    """One pipeline stage's ranks (all of them without stages) with
    per-layer views, and the sharded layer's two collective steps; ``x``
    (the residual stream) lives on the stage's first local rank's device.
    ``held``: this process holds ranks of the stage; ``local_tp``: the tp
    ranks whose attention and pages it holds."""

    def __init__(self, layout: par.ServeLayout, shards: list[Params]):
        self.layout, self.shards = layout, shards
        self.tp, self.ep = layout.tp, layout.ep
        self.comm = layout.comm  # the stage spans processes (no pp)
        local = [r for r, _, _ in layout.ranks()]
        self.held = bool(local)
        self.dev = layout.first_device if self.held else None
        self.first = local[0] if local else None
        self.local_tp = [t for t in range(self.tp) if layout.tp_device(t) is not None]
        per = {r: layer_params(shards[r]) for r in local}
        n = len(per[local[0]]) if local else 0
        self.layers = [[per[r][i] if r in per else None for r in range(len(shards))]
                       for i in range(n)]  # [L/pp][rank]

    def tp_shard(self, t: int) -> Params:
        return self.shards[t * self.ep]

    def layer(self, cfg: ModelConfig, lps, x: torch.Tensor, attend,
              norms=fused_norm) -> torch.Tensor:
        """One decoder layer: ``attend(t, lp, x_t)`` gives tp rank t's
        attention output over its heads; one sum after ``wo``, one after the
        FFN (``w2``). The residual add after ``wo`` and the MLP norm are one
        ``norms.rms_norm`` call (one K4 launch)."""
        parts = []
        for t in self.local_tp:
            lp = lps[t * self.ep]
            xt = x.to(self.layout.tp_device(t))
            attn = attend(t, lp, xt)
            parts.append(attn.reshape(*xt.shape[:-1], -1) @ lp["wo"])
        x, h = norms.rms_norm(par.reduce_sum(parts, self.dev, self.comm),
                              lps[self.first]["ln_mlp"], cfg.norm_eps, residual=x)
        return x + par.reduce_sum(
            [_ffn(cfg, lps[r], h.to(self.layout.devices[r]), e, self.ep)
             for r, _, e in self.layout.ranks()], self.dev, self.comm)


class _Model:
    """The parameters as ranks (one for a plain dict), grouped into
    pipeline stages (one without ``pp``). The embedding, the final norm and
    the head are stage 0's: the residual stream enters and leaves there, on
    the first rank's device."""

    def __init__(self, params):
        if isinstance(params, par.ShardedParams):
            self.layout, shards = params.layout, params.shards
        else:
            self.layout, shards = par.single_layout(params), [params]
        self.tp, self.ep, self.pp = self.layout.tp, self.layout.ep, self.layout.pp
        n = self.tp * self.ep
        self.stages = [_Stage(self.layout.stage(s), shards[s * n:(s + 1) * n])
                       for s in range(self.pp)]
        self.head = self.stages[0]
        self.dev = self.head.dev
        # The residual stream's dtype (the weights'), for a hop's receiver.
        self.dtype = next(iter(shards[next(r for r, _, _ in self.layout.ranks())]
                               ["layers"].values())).dtype
        self.comm = self.layout.comm if self.pp > 1 else None
        self._sends: list = []

    def stage_pages(self, pages, s: int) -> list[torch.Tensor | None]:
        """Stage ``s``'s page tensors, one per tp rank (None: another
        process's)."""
        return _page_list(pages)[s * self.tp:(s + 1) * self.tp]

    def hop(self, x: torch.Tensor | None, src: int, dst: int, shape) -> torch.Tensor | None:
        """The activation ``x`` (of ``shape``) of stage ``src`` on stage
        ``dst``'s device, the JAX ``ppermute``: a copy within a process,
        else a send from ``src``'s process and a receive on ``dst``'s.
        None on a process that does not hold ``dst``. Sends are posted, not
        awaited (``flush``), so a schedule in which every process sends
        before it receives cannot deadlock."""
        st = self.stages[dst]
        a, b = self.layout.stage_proc(src), self.layout.stage_proc(dst)
        if self.comm is None or a == b:
            return None if x is None or not st.held else x.to(st.dev)
        if self.comm.rank == a:
            self._sends.append(self.comm.send(x, b))
        elif self.comm.rank == b:
            return self.comm.recv(shape, self.dtype, st.dev, a)
        return None

    def flush(self) -> None:
        """Wait for every posted hop send."""
        for w in self._sends:
            w.wait()
        self._sends = []

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings: a masked lookup in each vocab shard, summed
        (the other shards add exact zeros)."""
        st = self.head
        if self.tp == 1:
            return st.shards[st.first]["embed"][tokens.long()]
        parts = []
        for t in st.local_tp:
            emb = st.tp_shard(t)["embed"]
            n = emb.shape[0]
            ids = tokens.long().to(emb.device) - t * n
            ok = (ids >= 0) & (ids < n)
            rows = emb[ids.clamp(0, n - 1)]
            parts.append(torch.where(ok[..., None], rows, torch.zeros_like(rows)))
        return par.reduce_sum(parts, self.dev, st.comm)

    def final_norm(self, x: torch.Tensor, cfg: ModelConfig, norms=fused_norm) -> torch.Tensor:
        """The final RMSNorm, on stage 0's device (where the ring wraps)."""
        return norms.rms_norm(x.to(self.dev), self.head.shards[self.head.first]["final_norm"],
                              cfg.norm_eps)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of final-norm hidden states, gathered over the vocab
        shards."""
        st = self.head
        return par.gather_last(
            [(x.to(st.layout.tp_device(t)) @ st.tp_shard(t)["lm_head"]).float()
             for t in st.local_tp], self.dev, st.comm)


def _page_list(pages) -> list[torch.Tensor]:
    return list(pages) if isinstance(pages, (list, tuple)) else [pages]


def lm_logits(params, x: torch.Tensor) -> torch.Tensor:
    """f32 logits of final-norm hidden states ``x`` (in the params' dtype),
    on the first rank's device (a process of stage 0)."""
    return _Model(params).logits(x)


def forward(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                     # [B, S] int
    positions: torch.Tensor | None = None,    # [B, S]
    *,
    want_kv: bool = False,
    want_hidden: bool = False,
    kv_valid: torch.Tensor | None = None,     # [B, S] padding mask
    mm_embeds: torch.Tensor | None = None,    # [B, M, D] multimodal vectors
    mm_positions: torch.Tensor | None = None,  # [B, M] target positions
    attention_fn: Callable[..., torch.Tensor] = causal_attention,
    norms=fused_norm,
) -> tuple[torch.Tensor, tuple | None]:
    """Full-sequence forward (prefill, training). Returns (logits [B, S, V] f32 — or
    the final-norm hidden states [B, S, D] as f32 with ``want_hidden`` —,
    (K, V) each [L, B, S, Hkv, Dh] if ``want_kv``; with ``ShardedParams``
    K and V are lists over the (stage, tp) ranks of [L/pp, B, S, Hkv/tp,
    Dh], index ``s * tp + t``, None where another process holds the rank).

    Multimodal prefill (E/P/D): ``mm_embeds`` replace the token embeddings
    at ``mm_positions`` (encoder outputs spliced in at placeholder tokens),
    cast to the embeddings' dtype; a position ``>= S`` (a caller's padding)
    is dropped, as the JAX scatter's ``mode="drop"`` drops it. The splice
    happens before stage 0. Each stage runs its layers in turn, the
    activation moving to the next stage's device (the JAX ``ppermute``).

    ``attention_fn`` (the JAX hook) computes each layer's attention, called
    once per tp rank on that rank's heads with ``causal_attention``'s
    keyword arguments: the sequence-parallel paths (``parallel/
    ring_attention.py``, ``parallel/ulysses.py``) substitute theirs, and the
    engine's serving prefills pass K3 (``ops/prefill_attention.causal``).
    ``norms`` computes the layers' RMSNorms, QK-norm and RoPE and the final
    norm (``rms_norm``, ``qk_norm_rope``): K4's wrappers by default, which
    raise where autograd would need their backward; the train step passes
    the eager ``fused_norm.PLAIN``."""
    m = _Model(params)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    x = m.embed(tokens) if m.head.held else None
    if mm_embeds is not None and x is not None:
        x = _splice(x, mm_embeds, mm_positions)
    n = m.pp * m.tp
    ks: list[list[torch.Tensor]] = [[] for _ in range(n)]
    vs: list[list[torch.Tensor]] = [[] for _ in range(n)]
    shape = (B, S, cfg.d_model)
    for s, st in enumerate(m.stages):
        if s > 0:
            x = m.hop(x, s - 1, s, shape)
        if not st.held:
            continue
        kv_out = ((ks[s * m.tp:(s + 1) * m.tp], vs[s * m.tp:(s + 1) * m.tp])
                  if want_kv else None)
        x = run_stage(cfg, st, x, positions, cos, sin, kv_valid=kv_valid,
                      attention_fn=attention_fn, kv_out=kv_out, norms=norms)
    x = m.hop(x, m.pp - 1, 0, shape)
    m.flush()
    kv = None
    if want_kv:
        kv = ([torch.stack(k) if k else None for k in ks],
              [torch.stack(v) if v else None for v in vs])
        if not isinstance(params, par.ShardedParams):
            kv = (kv[0][0], kv[1][0])
    if x is None:
        return None, kv
    x = m.final_norm(x, cfg, norms)
    if want_hidden:
        return x.float(), kv
    return m.logits(x), kv


def run_stage(cfg: ModelConfig, st: _Stage, x: torch.Tensor, positions: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor, *,
              kv_valid: torch.Tensor | None = None,
              attention_fn: Callable[..., torch.Tensor] = causal_attention,
              kv_out: tuple[list, list] | None = None, norms=fused_norm) -> torch.Tensor:
    """Stage ``st``'s layers over the full sequences ``x`` [B, S, D] (the
    JAX layer scan): returns the stage's output on its device. Each tp rank
    attends through ``attention_fn`` on its own heads, its norms and RoPE
    through ``norms`` (``forward``'s); with ``kv_out`` (K and V lists, one
    list per tp rank) each layer's K and V are appended."""
    per_tp = {}
    for t in st.local_tp:
        dev = st.layout.tp_device(t)
        per_tp[t] = (cos.to(dev), sin.to(dev), positions.to(dev),
                     None if kv_valid is None else kv_valid.to(dev))

    def attend(t, lp, xt):
        c, s_, pos, valid = per_tp[t]
        q, k, v = _qkv(cfg, lp, xt, c, s_, norms)
        if kv_out is not None:
            kv_out[0][t].append(k)
            kv_out[1][t].append(v)
        return attention_fn(q, k, v, q_positions=pos, kv_positions=pos, kv_valid=valid)

    x = x.to(st.dev)
    for lps in st.layers:
        x = st.layer(cfg, lps, x, attend, norms)
    return x


def _splice(x: torch.Tensor, mm_embeds: torch.Tensor,
            mm_positions: torch.Tensor) -> torch.Tensor:
    """``x`` [B, S, D] with rows ``mm_positions`` [B, M] overwritten by
    ``mm_embeds`` [B, M, D]. Indexing raises on an out-of-range position
    where the JAX scatter drops it, so such positions (negative ones count
    from the end, as in JAX) write a scratch row past the end, sliced off
    afterwards: no host sync to filter them."""
    B, S, D = x.shape
    pos = mm_positions.long().to(x.device)
    pos = torch.where(pos < 0, pos + S, pos)
    pos = torch.where((pos >= 0) & (pos < S), pos, torch.full_like(pos, S))
    rows = torch.arange(B, device=x.device)[:, None].expand_as(pos)
    out = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)
    out[rows, pos] = mm_embeds.to(x.device, x.dtype)
    return out[:, :S]


def decode_slab(cfg: ModelConfig, st: _Stage, x: torch.Tensor, kps, vps,
                block_tables: torch.Tensor, positions: torch.Tensor,
                paged_attention: Callable[..., torch.Tensor] = paged_decode_attention_cuda,
                ) -> torch.Tensor:
    """One stage's layers for one decode token of every lane in ``x`` [B,
    1, D] (the JAX ``_decode_slab``): returns the stage's output on its
    device, the stage's pages (``kps``/``vps``, one per tp rank) written in
    place.

    The layer loop only reads the pages; the current token attends to itself
    through the ``cur_k``/``cur_v`` column, and the stage's current-token KV
    is written afterwards with one scatter per page tensor. Inactive lanes
    point their block table at the trash block 0. A lane that has passed its
    block table (a fused decode chunk keeps stepping a finished lane) writes
    through the table's last entry, clamped explicitly here (JAX clamps the
    gather index silently); the kernel bounds its page walk the same way.
    Each tp rank attends over its own pages (one kernel launch per rank and
    layer)."""
    B = x.shape[0]
    block = next(k for k in kps if k is not None).shape[2]
    W = block_tables.shape[1]
    positions = positions.to(st.dev, torch.int32)
    block_tables = block_tables.to(st.dev)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)  # [B, half]
    seq_lens = positions + 1
    lane = torch.arange(B, device=st.dev)
    blk_idx = block_tables[lane, (positions // block).clamp(max=W - 1).long()].long()
    slot = (positions % block).long()
    per_tp = {}
    for t in st.local_tp:
        dev = kps[t].device
        per_tp[t] = (cos[:, None].to(dev), sin[:, None].to(dev),
                     block_tables.to(dev), seq_lens.to(dev))

    x = x.to(st.dev)
    k_cur: list[list[torch.Tensor]] = [[] for _ in range(st.tp)]
    v_cur: list[list[torch.Tensor]] = [[] for _ in range(st.tp)]
    for li, lps in enumerate(st.layers):
        def attend(t, lp, xt):
            c, s_, tab, lens = per_tp[t]
            q, k, v = _qkv(cfg, lp, xt, c, s_)
            q, k, v = q[:, 0], k[:, 0], v[:, 0]              # [B, H(kv), Dh]
            attn = paged_attention(q, kps[t][li], vps[t][li], tab, lens, k, v)
            k_cur[t].append(k)
            v_cur[t].append(v)
            return attn[:, None]

        x = st.layer(cfg, lps, x, attend)
    for t in st.local_tp:
        dev = kps[t].device
        bi, si = blk_idx.to(dev), slot.to(dev)
        kps[t][:, bi, si] = torch.stack(k_cur[t]).to(kps[t].dtype)
        vps[t][:, bi, si] = torch.stack(v_cur[t]).to(vps[t].dtype)
    return x


def decode_step(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B] current input token per sequence
    positions: torch.Tensor,     # [B] 0-based position of that token
    k_pages,                     # [L, N_blocks, block, Hkv, Dh] (a list per (stage, tp) rank)
    v_pages,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    paged_attention: Callable[..., torch.Tensor] = paged_decode_attention_cuda,
) -> tuple[torch.Tensor, Any, Any]:
    """One decode step with paged KV; returns (logits [B, V] f32, k_pages,
    v_pages), the pages updated in place. Every lane's token goes through
    stage 0, 1, ..., then the head (``decode_slab`` per stage): with
    stages, the broadcast ring of the JAX ``_ring_decode_step``, which runs
    only the stage whose turn it is."""
    m = _Model(params)
    shape = (tokens.shape[0], 1, cfg.d_model)
    x = m.embed(tokens)[:, None] if m.head.held else None    # [B, 1, D]
    for s, st in enumerate(m.stages):
        if s > 0:
            x = m.hop(x, s - 1, s, shape)
        if st.held:
            x = decode_slab(cfg, st, x, m.stage_pages(k_pages, s),
                            m.stage_pages(v_pages, s), block_tables, positions,
                            paged_attention)
    x = m.hop(x, m.pp - 1, 0, shape)
    m.flush()
    if x is None:
        return None, k_pages, v_pages
    return m.logits(m.final_norm(x[:, 0], cfg)), k_pages, v_pages


def prefill_with_prefix(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [1, S] suffix tokens (may be padded)
    suffix_len: torch.Tensor,    # [1] valid suffix tokens
    prefix_len: torch.Tensor,    # [1] tokens already present in the pages
    k_pages,                     # [L, N, block, Hkv, Dh] (a list per (stage, tp) rank)
    v_pages,
    block_table_row: torch.Tensor,  # [1, max_blocks] full table (KV scatter)
    prior_table_row: torch.Tensor | None = None,  # [1, P] gather window
) -> tuple[torch.Tensor, Any, Any]:
    """Prefill continuing from cached prefix KV (automatic prefix caching).

    The suffix attends to the cached prefix gathered from the pages plus
    itself causally (K3, ``ops/prefill_attention.py``, with the gathered
    prefix and the suffix as its two column parts; the plain version on the
    CPU); its KV is written into the pages at prefix_len + t.
    With stages, each stage reads the prior KV of its layers from its own
    pages and writes its own (the JAX ``make_pp_prefill_with_prefix``).
    Returns (last-token logits [1, V] f32, k_pages, v_pages), pages updated
    in place."""
    m = _Model(params)
    kps, vps = _page_list(k_pages), _page_list(v_pages)
    B, S = tokens.shape
    assert B == 1
    block = next(k for k in kps if k is not None).shape[2]
    if prior_table_row is None:
        prior_table_row = block_table_row
    W = block_table_row.shape[1]
    T = prior_table_row.shape[1] * block
    Dh = cfg.head_dim
    dev = tokens.device
    suffix_len = suffix_len.to(dev)
    prefix_len = prefix_len.to(dev)

    t_idx = torch.arange(S, dtype=torch.int32, device=dev)
    positions = prefix_len[:, None].int() + t_idx[None, :]           # [1, S]
    cos, sin = rope_table(positions, Dh, cfg.rope_theta)
    prior_len, new_len = prefix_len.int(), suffix_len.int()
    prior = prior_table_row[0].long()
    # Suffix KV goes to offset positions (padding -> trash block 0).
    tgt = prefix_len[0] + t_idx
    valid = t_idx < suffix_len[0]
    table_blk = block_table_row[0, (tgt // block).clamp(max=W - 1).long()]
    blk_for_t = torch.where(valid, table_blk, torch.zeros_like(table_blk)).long()
    slot_for_t = torch.where(valid, tgt % block, torch.zeros_like(tgt)).long()

    x = m.embed(tokens) if m.head.held else None
    shape = (1, S, cfg.d_model)
    for s, st in enumerate(m.stages):
        if s > 0:
            x = m.hop(x, s - 1, s, shape)
        if not st.held:
            continue
        skp, svp = m.stage_pages(kps, s), m.stage_pages(vps, s)
        per_tp = {t: tuple(a.to(skp[t].device) for a in (cos, sin, prior_len, new_len,
                                                          prior))
                  for t in st.local_tp}
        k_new: list[list[torch.Tensor]] = [[] for _ in range(m.tp)]
        v_new: list[list[torch.Tensor]] = [[] for _ in range(m.tp)]
        x = x.to(st.dev)
        for li, lps in enumerate(st.layers):
            def attend(t, lp, xt):
                c, s_, n_prior, n_new, pr = per_tp[t]
                q, k, v = _qkv(cfg, lp, xt, c, s_)
                Hkv = k.shape[2]
                k_prior = skp[t][li][pr].reshape(1, T, Hkv, Dh)
                v_prior = svp[t][li][pr].reshape(1, T, Hkv, Dh)
                k_new[t].append(k[0])
                v_new[t].append(v[0])
                return prefill_attention(q, k, v, k_prior=k_prior, v_prior=v_prior,
                                         prior_len=n_prior, new_len=n_new)

            x = st.layer(cfg, lps, x, attend)
        for t in st.local_tp:
            d = skp[t].device
            bi, si = blk_for_t.to(d), slot_for_t.to(d)
            skp[t][:, bi, si] = torch.stack(k_new[t]).to(skp[t].dtype)
            svp[t][:, bi, si] = torch.stack(v_new[t]).to(svp[t].dtype)

    x = m.hop(x, m.pp - 1, 0, shape)
    m.flush()
    if x is None:
        return None, k_pages, v_pages
    x = m.final_norm(x, cfg)
    last = x[0, (suffix_len[0] - 1).long().to(x.device)][None]
    return m.logits(last), k_pages, v_pages


def write_prefill_kv(
    k_pages,                     # [L, N, block, Hkv, Dh] (a list per tp rank)
    v_pages,
    k_new,                       # [L, B, S, Hkv, Dh] from forward(want_kv=True)
    v_new,
    block_tables: torch.Tensor,  # [B, max_blocks]
    seq_lens: torch.Tensor,      # [B] valid prompt tokens
) -> tuple[Any, Any]:
    """Write freshly prefilled KV rows into their pages, in place (per tp
    rank where pages and KV are lists).

    Token t of sequence b lands in block block_tables[b, t // block] at slot
    t % block; padding tokens (t >= seq_lens[b]) go to the trash block 0."""
    kps, vps = _page_list(k_pages), _page_list(v_pages)
    kns, vns = _page_list(k_new), _page_list(v_new)
    L, B, S, _, Dh = next(k for k in kns if k is not None).shape
    block = next(k for k in kps if k is not None).shape[2]
    W = block_tables.shape[1]
    dev = block_tables.device
    t = torch.arange(S, dtype=torch.int32, device=dev)
    blk_for_t = block_tables[:, (t // block).clamp(max=W - 1).long()]  # [B, S]
    valid = t[None, :] < seq_lens.to(dev)[:, None]
    blk_for_t = torch.where(valid, blk_for_t, torch.zeros_like(blk_for_t))
    slot_for_t = torch.where(valid, (t % block)[None, :].expand(B, S),
                             torch.zeros((B, S), dtype=torch.int32, device=dev))
    bidx = blk_for_t.reshape(-1).long()
    sidx = slot_for_t.reshape(-1).long()
    for kp, vp, kn, vn in zip(kps, vps, kns, vns):
        if kp is None:  # another process's rank
            continue
        Hkv = kn.shape[3]
        bi, si = bidx.to(kp.device), sidx.to(kp.device)
        kp[:, bi, si] = kn.reshape(L, B * S, Hkv, Dh).to(kp.device, kp.dtype)
        vp[:, bi, si] = vn.reshape(L, B * S, Hkv, Dh).to(vp.device, vp.dtype)
    return k_pages, v_pages
