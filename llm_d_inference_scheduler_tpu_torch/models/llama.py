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
  functions write the pages in place and return the same tensors; one
  helper (``_write_kv``) writes new K/V rows into them for ``prefill`` and
  ``decode_slab``.
- Serving runs two functions: ``prefill`` writes the KV of N rows' prompt
  windows, each continuing from the KV its block table already holds or
  from nothing, and returns their next-token logits (attention in kernel
  K3, ``ops/prefill_attention.py``); ``decode_step`` takes one token per
  lane, its paged attention a parameter defaulting to the CUDA kernel K1's
  wrapper (which computes the plain version on CPU tensors) — the
  counterpart of the JAX ``use_pallas`` switch. ``forward`` (no pages)
  serves training, embeddings and whole-sequence logits.
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

    def run_stages(self, x: torch.Tensor | None, shape, stage) -> torch.Tensor | None:
        """Stage 0's input ``x`` (of ``shape``) through every stage in turn,
        back on stage 0: ``stage(s, st, x)`` runs stage ``s`` where this
        process holds it. None on a process without stage 0."""
        for s, st in enumerate(self.stages):
            if s > 0:
                x = self.hop(x, s - 1, s, shape)
            if st.held:
                x = stage(s, st, x)
        x = self.hop(x, self.pp - 1, 0, shape)
        self.flush()
        return x

    def stage0_input(self, tokens: torch.Tensor, mm_embeds: torch.Tensor | None = None,
                     mm_positions: torch.Tensor | None = None) -> torch.Tensor | None:
        """The embeddings of ``tokens``, the multimodal rows spliced in
        (``_splice``); None on a process without stage 0."""
        if not self.head.held:
            return None
        x = self.embed(tokens)
        return x if mm_embeds is None else _splice(x, mm_embeds, mm_positions)

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


def _write_kv(kp: torch.Tensor, vp: torch.Tensor, ks: list[torch.Tensor],
              vs: list[torch.Tensor], tables: torch.Tensor, positions: torch.Tensor,
              valid: torch.Tensor | None = None) -> None:
    """Write new K/V rows into one rank's pages ``kp``/``vp`` [L, N, block,
    Hkv, Dh], in place, with one scatter each: ``ks``/``vs`` hold one tensor
    per layer, [B, S, Hkv, Dh] (a decode step's [B, Hkv, Dh]), of the tokens
    at ``positions`` [B, S] ([B]) of the rows whose block tables are
    ``tables`` [B, W]. Position p of row b lands in block tables[b, p //
    block] at slot p % block; a position past the table writes through its
    last entry (a finished lane still stepping in a fused decode chunk; JAX
    clamps the gather index silently), one where ``valid`` is False in the
    trash block 0."""
    dev = kp.device
    block, W = kp.shape[2], tables.shape[1]
    pos = positions.to(dev).long().reshape(tables.shape[0], -1)
    blk = tables.to(dev).long().gather(1, (pos // block).clamp(max=W - 1))
    slot = pos % block
    if valid is not None:
        invalid = ~valid.to(dev)
        blk, slot = blk.masked_fill(invalid, 0), slot.masked_fill(invalid, 0)
    bi, si = blk.reshape(-1), slot.reshape(-1)
    for pages, rows in ((kp, ks), (vp, vs)):
        new = torch.stack(rows)
        pages[:, bi, si] = new.reshape(len(rows), bi.numel(), *new.shape[-2:]).to(pages.dtype)


def forward(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                     # [B, S] int
    positions: torch.Tensor | None = None,    # [B, S]
    *,
    want_hidden: bool = False,
    kv_valid: torch.Tensor | None = None,     # [B, S] padding mask
    mm_embeds: torch.Tensor | None = None,    # [B, M, D] multimodal vectors
    mm_positions: torch.Tensor | None = None,  # [B, M] target positions
    attention_fn: Callable[..., torch.Tensor] = causal_attention,
    norms=fused_norm,
) -> tuple[torch.Tensor | None, None]:
    """Full-sequence forward over no pages (training, embeddings, the logits
    of every position). Returns (logits [B, S, V] f32 — or the final-norm
    hidden states [B, S, D] as f32 with ``want_hidden`` —, None): the JAX
    function's pair, whose K/V half serving writes into the pages through
    ``prefill`` instead.

    Multimodal (E/P/D): ``mm_embeds`` replace the token embeddings at
    ``mm_positions`` before stage 0 (``_splice``). Each stage runs its
    layers in turn, the activation moving to the next stage's device (the
    JAX ``ppermute``).

    ``attention_fn`` (the JAX hook) computes each layer's attention, called
    once per tp rank on that rank's heads with ``causal_attention``'s
    keyword arguments: the sequence-parallel paths (``parallel/
    ring_attention.py``, ``parallel/ulysses.py``) substitute theirs, and the
    engine's embeddings and logits pass K3 (``ops/prefill_attention.causal``).
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
    x = m.run_stages(m.stage0_input(tokens, mm_embeds, mm_positions), (B, S, cfg.d_model),
                     lambda s, st, x: run_stage(cfg, st, x, positions, cos, sin,
                                                kv_valid=kv_valid, attention_fn=attention_fn,
                                                norms=norms))
    if x is None:
        return None, None
    x = m.final_norm(x, cfg, norms)
    return (x.float() if want_hidden else m.logits(x)), None


def run_stage(cfg: ModelConfig, st: _Stage, x: torch.Tensor, positions: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor, *,
              kv_valid: torch.Tensor | None = None,
              attention_fn: Callable[..., torch.Tensor] = causal_attention,
              norms=fused_norm) -> torch.Tensor:
    """Stage ``st``'s layers over the full sequences ``x`` [B, S, D] (the
    JAX layer scan): returns the stage's output on its device. Each tp rank
    attends through ``attention_fn`` on its own heads, its norms and RoPE
    through ``norms`` (``forward``'s)."""
    per_tp = {}
    for t in st.local_tp:
        dev = st.layout.tp_device(t)
        per_tp[t] = (cos.to(dev), sin.to(dev), positions.to(dev),
                     None if kv_valid is None else kv_valid.to(dev))

    def attend(t, lp, xt):
        c, s_, pos, valid = per_tp[t]
        q, k, v = _qkv(cfg, lp, xt, c, s_, norms)
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


def prefill(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                      # [N, S] each row's window (padded)
    new_len: torch.Tensor,                     # [N] real tokens of each window
    k_pages,                                   # [L, N_blocks, block, Hkv, Dh]; a list
    v_pages,                                   # per (stage, tp) rank when sharded
    block_tables: torch.Tensor,                # [N, W] int32
    prior_len: torch.Tensor | None = None,     # [N] tokens already in the pages
    prior_tables: torch.Tensor | None = None,  # [N, P] the blocks that hold them
    *,
    mm_embeds: torch.Tensor | None = None,     # [N, M, D] multimodal vectors
    mm_positions: torch.Tensor | None = None,  # [N, M] their window positions
) -> tuple[torch.Tensor | None, Any, Any]:
    """Serving prefill: N rows' windows through every layer, their KV
    written into the pages. Returns (logits [N, V] f32 at each row's last
    real token, k_pages, v_pages), the pages written in place.

    Row n's tokens sit at positions ``prior_len[n] + t`` (from 0 without
    ``prior_len``). Each layer attends through K3
    (``ops/prefill_attention.py``; its plain version on the CPU): over the
    row's first ``prior_len[n]`` tokens, gathered from its blocks
    ``prior_tables[n]`` (``block_tables[n]`` without them), then causally
    over the window's first ``new_len[n]`` tokens. Without ``prior_len`` K3
    gets no prior columns: a whole prompt, or a batch of them. The window's
    KV goes to ``block_tables[n]`` at ``prior_len[n] + t``, padding
    positions to the trash block 0 (``_write_kv``). The final norm and the
    head run on each row's last real token only.

    ``mm_embeds`` are spliced in before stage 0, as in ``forward``. With
    stages, each stage reads the prior KV of its layers from its own pages
    and writes its own, as the JAX pp prefill does."""
    m = _Model(params)
    N, S = tokens.shape
    dev = tokens.device
    new_len = new_len.to(dev, torch.int32)
    t = torch.arange(S, dtype=torch.int32, device=dev)
    if prior_len is None:
        positions = t.expand(N, S)
    else:
        prior_len = prior_len.to(dev, torch.int32)
        positions = prior_len[:, None] + t
        prior_tables = (block_tables if prior_tables is None else prior_tables).long()
    valid = t < new_len[:, None]
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)

    def stage(s, st, x):
        kps, vps = m.stage_pages(k_pages, s), m.stage_pages(v_pages, s)
        per_tp = {r: tuple(None if a is None else a.to(kps[r].device)
                           for a in (cos, sin, prior_len, new_len, prior_tables))
                  for r in st.local_tp}
        ks: list[list[torch.Tensor]] = [[] for _ in range(st.tp)]
        vs: list[list[torch.Tensor]] = [[] for _ in range(st.tp)]
        x = x.to(st.dev)
        for li, lps in enumerate(st.layers):
            def attend(r, lp, xt):
                c, s_, n_prior, n_new, tab = per_tp[r]
                q, k, v = _qkv(cfg, lp, xt, c, s_)
                ks[r].append(k)
                vs[r].append(v)
                if tab is None:
                    return prefill_attention(q, k, v, new_len=n_new)
                cols = (N, -1, *k.shape[2:])
                return prefill_attention(q, k, v, k_prior=kps[r][li][tab].reshape(cols),
                                         v_prior=vps[r][li][tab].reshape(cols),
                                         prior_len=n_prior, new_len=n_new)

            x = st.layer(cfg, lps, x, attend)
        for r in st.local_tp:
            _write_kv(kps[r], vps[r], ks[r], vs[r], block_tables, positions, valid)
        return x

    x = m.run_stages(m.stage0_input(tokens, mm_embeds, mm_positions), (N, S, cfg.d_model),
                     stage)
    if x is None:
        return None, k_pages, v_pages
    last = x[torch.arange(N, device=x.device), (new_len - 1).long().to(x.device)]
    return m.logits(m.final_norm(last, cfg)), k_pages, v_pages


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
    is written afterwards (``_write_kv``). Inactive lanes point their block
    table at the trash block 0; a lane that has passed its block table (a
    fused decode chunk keeps stepping a finished lane) writes through the
    table's last entry, and the kernel bounds its page walk the same way.
    Each tp rank attends over its own pages (one kernel launch per rank and
    layer)."""
    positions = positions.to(st.dev, torch.int32)
    block_tables = block_tables.to(st.dev)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)  # [B, half]
    seq_lens = positions + 1
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
        _write_kv(kps[t], vps[t], k_cur[t], v_cur[t], block_tables, positions)
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
    x = m.run_stages(m.stage0_input(tokens[:, None]), (tokens.shape[0], 1, cfg.d_model),
                     lambda s, st, x: decode_slab(cfg, st, x, m.stage_pages(k_pages, s),
                                                  m.stage_pages(v_pages, s), block_tables,
                                                  positions, paged_attention))
    if x is None:
        return None, k_pages, v_pages
    return m.logits(m.final_norm(x[:, 0], cfg)), k_pages, v_pages
