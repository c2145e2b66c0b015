"""TorchEngine: continuous-batching PyTorch engine, on one device or sharded.

Port of ``TpuEngine`` (``llm_d_inference_scheduler_tpu/engine/core.py``):

- One engine thread owns the device and alternates admission/prefill with
  fused decode chunks. The HTTP handlers talk to it through thread-safe
  submission and per-request asyncio queues (events hop back to the event
  loop with ``call_soon_threadsafe``).
- Admission matches the prompt's complete blocks against the prefix cache
  (``PrefixCachingAllocator``), allocates the rest and prefills. Every
  prefill is one device op (``prefill``, ``llama.prefill``) over N rows,
  each a window of tokens continuing from the KV already in its first
  blocks or from nothing: a plain prompt (N = 1, or a batch), a cache
  hit's suffix over the cached prefix, a window of a long prompt, a
  multimodal prompt with its embeddings spliced in. It writes the rows'
  KV, attends through K3 (``ops/prefill_attention.py``) and samples each
  row's first token in the same dispatch; the token is read back after
  the next decode chunk has been queued.
- Decode runs ``decode_chunk`` decode+sample steps back to back on the device
  over the active slots, compacted into a power-of-two batch bucket, with ONE
  host readback of the [K, B] sampled tokens per chunk. Padding lanes point
  at the trash block 0. A lane that hits a stop or length limit mid-chunk
  keeps stepping; the host discards its overshoot.
- JAX's donated page buffers become in-place updates: the KV pages
  ``[L, N, block, Hkv, Dh]`` are allocated once and written in place by the
  prefill and decode functions.
- Incremental prefill (``prefill_chunk``): a long prompt prefills one
  block-aligned window per engine step, between decode chunks, each
  continuing from the blocks written (or matched in the cache) before it;
  the prefix-cache commit waits for the last window.
- P/D KV handoff, host-staged over HTTP (single device): a prefill tagged
  ``do_remote_decode`` gathers its blocks to host memory (pow2-padded block
  count) and finishes with ``kv_transfer_params`` naming this engine; with
  ``stream_chunks`` each prefill window's newly complete blocks are staged as
  a chunk as soon as they are written. A decode request carrying
  ``remote_host`` pulls the export (whole, or chunk by chunk over the
  ``/kv`` long-poll) on a fetch thread, scatters it into fresh blocks and
  emits the exporter's first token; every failure falls back to local
  prefill. Exports are released by the importer's ``DELETE`` or swept after
  ``KV_EXPORT_TTL_S``.
- KV events (``engine/kv_events.py``): ``stored`` when a prefill or an
  import commits its complete blocks, ``removed`` when the prefix cache
  evicts them (or, with caching off, when the slot frees them), and a
  ``stored`` snapshot of the whole cache at most once a second, idle or
  not, so a subscriber that joins late learns it.
- ``embed``: the mean-pooled final-norm hidden state of a prompt, computed
  on the engine thread (requests queue to it with a ``Future``), touching
  no page or slot.
- Multimodal prefill (E/P/D): a request carrying encoder embeddings
  (``mm_embeds``) prefills its whole prompt in one window with the
  embeddings spliced in at ``mm_positions``, bypassing the prefix cache,
  the KV events and the incremental-prefill window; the vision tower that
  makes such embeddings (``vision``, ``encode_images``) serves ``/v1/encode``.
- Shared-storage probe: a request with ``cache_hit_threshold`` whose prefix
  hit ratio is below it ends at admission with ``CACHE_THRESHOLD``, before
  any block is allocated.
- Warm-up (``cfg.warmup``): before admitting anything the engine thread
  builds the model's CUDA kernels and runs each serving path once on the
  trash block; a failure stops the engine (``failure``), it never serves
  without a kernel.

- Batched prefill (``prefill_batch``): same-bucket plain prompts admitted
  together prefill in one [N, S] dispatch, grouped by the JAX engine's rules
  (``_flush_admissions``).
- Weights: passed in, drawn from the seed, or loaded from a converted
  directory (``engine/checkpoint.py``) named by ``model`` or
  ``checkpoint_path``.
- Tensor/expert parallel (``tp_size``, ``ep_size``; ``parallel/serve.py``):
  the params are ``ShardedParams`` (passed-in full weights are split, a
  checkpoint is split as it is read) and the pages one K/V pair per tp rank
  ``[L, N, block, Hkv/tp, Dh]``. Every path runs on them; the ``/kv`` wire
  is unchanged: an export joins the kv-head shards into the single-device
  layout and an import splits them, so sharded and single-device engines
  (port or JAX) hand KV to each other as before. The grouped MoE FFN is
  refused there: the sharded path stays dense, as in the JAX engine.
- Pipeline parallel (``pp_size``; ``parallel/pp_serve.py``): the ranks form
  ``pp`` stages, each holding its slab of the layers and their pages (one
  K/V pair per (stage, tp rank) ``[L/pp, N, block, Hkv/tp, Dh]``), the
  embedding and head on stage 0. Prefill and the embeddings run the
  stages in turn; a decode chunk takes the lane-group interleave when its
  batch bucket divides by ``pp`` and the broadcast ring otherwise (the JAX
  ``"auto"`` schedule). Block ids stay global, so
  the allocator, prefix caching, the events and ``/debug/kv`` do not
  change; the ``/kv`` export joins the stages along the layer axis after
  the kv-head shards, so it keeps the single-device layout. A pp engine
  prefills one prompt at a time, as the JAX one (``prefill_batch`` has no
  effect), and ``grouped_moe`` runs under pp alone (each stage holds its
  layers' experts whole).
- A TLS exporter names ``https`` as its ``remote_scheme``; the importer
  dials it with the engine's client TLS policy (``utils/tls.py``).
- Multi-process serving (``dist_*``; ``engine/multihost.py``): a group of
  processes serves as one engine, its ranks split over them
  (``parallel/serve.py``). Every device call goes through ``_device_call``
  as an op of plain numpy arrays and ints (the JAX op kinds); the leader
  broadcasts it before running it, followers replay it. A lost follower or a
  broken channel latches ``dist_degraded``: everything is aborted, new work
  refused, ``/health`` answers 503.
- Device wire (``engine/kv_transfer.py``, ``kv_transfer``): an exporter
  stages its page shards on the device and serves CUDA IPC handles; a
  single-process importer copies device to device, then releases the export
  with ``consumed="device"``. A multi-process group hands KV to another
  over per-process shard wires (``kv_wire``: the device wire or the host
  ``engine/shard_wire.py``), each process pulling its own shards from its
  counterpart; a group has no host ``/kv`` path, so an importer group with
  no usable wire prefills locally. The port advertises its wires under keys
  of its own (``kv_wire_device``, ``kv_wire_host``), never the JAX
  ``transfer_address``/``transfer_shards``, whose pull blocks on a peer that
  is not JAX; it ignores those keys from a JAX exporter.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import http.client
import json
import logging
import os
import threading
import time
import urllib.parse
import uuid
from typing import Any

import numpy as np
import torch

from ..models import llama, vision
from ..ops import _build, fused_norm, grouped_moe, paged_attention, prefill_attention
from ..ops.moe import check_tileable
from ..parallel import pp_serve
from ..parallel import serve as par
from ..utils.device import resolve_device, torch_dtype
from ..utils.hashing import chain_block_hashes
from ..utils.tls import client_verify
from . import checkpoint, kv_shards, kv_transfer, kv_wire, multihost, shard_wire
from .blocks import BlockAllocator, PrefixCachingAllocator
from .config import EngineConfig
from .kv_events import KvEventPublisher, zmq_available
from .request import EngineRequest, FinishReason, TokenEvent
from .sampling import SamplingKnobs, sample_tokens
from .telemetry import EngineTelemetry, PrefixHitLog
from .tokenizer import get_tokenizer

log = logging.getLogger("engine.torch")

KV_EXPORT_TTL_S = 60.0


@dataclasses.dataclass
class _Slot:
    req: EngineRequest
    out: asyncio.Queue
    loop: asyncio.AbstractEventLoop
    blocks: list[int]
    position: int              # next token position to be written
    generated: list[int]
    last_token: int
    first_emitted: bool = False
    cached_tokens: int = 0
    # The prefill's sampled first token, still on the device; the slot joins
    # decode chunks once _finalize_prefills has read it back.
    pending_tok: torch.Tensor | None = None
    prompt_len: int = 0
    # Incremental prefill: while True the slot stays out of decode batches;
    # _advance_prefills writes one window per engine step. chunk_meta holds
    # (hashes, caching) for the prefix-cache commit after the last window.
    prefilling: bool = False
    prefill_rest: list[int] = dataclasses.field(default_factory=list)
    prefill_written: int = 0
    chunk_meta: Any = None
    # Chain hashes of the complete prompt blocks this slot committed (the
    # KV events' unit), set with caching or events on.
    block_hashes: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _PendingImport:
    """A decode request whose KV is being (or has been) pulled: the
    exporter's geometry headers and its K and V as host tensors (the /kv
    route), or its shards on the device (the device wire; ``done`` closes
    them), or, in a group, a coordinated pull the engine thread runs as an
    op on every process (``dist_pull``)."""
    req: EngineRequest
    out: asyncio.Queue
    loop: asyncio.AbstractEventLoop
    kv: tuple[torch.Tensor, torch.Tensor] | None = None
    headers: dict[str, str] | None = None
    shards: list[torch.Tensor] | None = None
    done: Any = None
    open_s: float = 0.0  # the device pull's handle exchange and open
    dist_pull: bool = False
    error: str | None = None


class TorchEngine:
    """Continuous-batching engine over models.llama with paged KV on the device."""

    def __init__(self, cfg: EngineConfig, params: dict[str, Any] | None = None,
                 *, comm: par.Comm | None = None):
        """``comm``: the group's collectives, for a multi-process engine
        whose caller built the group (tests with a store shared by threads);
        by default the engine joins the group ``cfg.dist_*`` names."""
        self.cfg = cfg
        self.mcfg = cfg.model_config
        # The grouped FFN: the engine's switch, or a model directory whose
        # model_config.json selects it (moe_impl "grouped", as the JAX one).
        if (cfg.grouped_moe or self.mcfg.moe_impl == "grouped") and self.mcfg.n_experts:
            if cfg.tp_size > 1 or cfg.ep_size > 1:
                raise ValueError("grouped_moe requires tp_size=ep_size=1 "
                                 "(the sharded path stays dense)")
            # A geometry the kernel cannot tile fails here, not mid-serve.
            check_tileable(self.mcfg.d_model, self.mcfg.d_ff)
            self.mcfg = dataclasses.replace(self.mcfg, moe_impl="grouped")
        if (not cfg.checkpoint_path and params is None
                and os.path.isfile(os.path.join(cfg.model, "model_config.json"))):
            # A converted directory (models/convert_hf.py): its weights are
            # the checkpoint. One the port cannot read (Orbax, no weights)
            # is refused by the load below, never served with random weights.
            cfg.checkpoint_path = cfg.model
        # pp_size * tp_size * ep_size > 1: the ranks' devices
        # (parallel/serve.py); the first (stage 0's) holds the embedding,
        # the head, sampling and the vision tower.
        self.layout: par.ServeLayout | None = None
        self._dist = cfg.dist
        self.comm = None
        if cfg.pp_size * cfg.tp_size * cfg.ep_size > 1 or self._dist:
            par.validate_degrees(self.mcfg, cfg.tp_size, cfg.ep_size, cfg.pp_size)
            names = cfg.rank_devices()
            if self._dist:
                par.validate_dist(cfg.tp_size, cfg.ep_size, cfg.pp_size,
                                  cfg.dist_num_processes)
                self.comm = comm or multihost.maybe_init_distributed(
                    cfg, [resolve_device(d) for d in (names or ["cuda"])])
            self.layout = par.make_serve_layout(names, cfg.tp_size, cfg.ep_size,
                                                cfg.pp_size, self.comm)
            self.device = self.layout.first_device
        else:
            self.device = resolve_device((cfg.rank_devices() or [cfg.device])[0])
        # Before any weight is read: a tokenizer that cannot load fails fast.
        self.tokenizer = get_tokenizer(cfg.tokenizer, self.mcfg.vocab_size)
        # Passed-in params fix the dtype unless the config names one.
        self.dtype = torch_dtype(
            cfg.dtype or (_embed(params).dtype if params is not None
                          else self.mcfg.dtype))
        if params is None and cfg.checkpoint_path:
            params = checkpoint.load_params(cfg.checkpoint_path, self.mcfg,
                                            self.device, self.dtype,
                                            layout=self.layout)
        self.engine_id = cfg.engine_id or f"torch-{uuid.uuid4().hex[:8]}"
        self.model_name = cfg.model_name

        block = self.mcfg.kv_block_size
        self.n_blocks = max(cfg.num_kv_blocks(), 2)  # >= trash + 1 usable
        self.max_blocks_per_seq = -(-cfg.max_model_len // block)
        self.allocator = (PrefixCachingAllocator(self.n_blocks, block)
                          if cfg.enable_prefix_caching
                          else BlockAllocator(self.n_blocks, block))
        self.telemetry = EngineTelemetry(block_size=block, num_blocks=self.n_blocks)
        # Admission wait per request (submit() stamps, the FIRST _admit pop
        # measures; the server pops it for x-engine-queue-ms). Bounded.
        self._queue_submit: dict[str, float] = {}
        self.queue_waits: dict[str, float] = {}
        self._queue_wait_order: collections.deque[str] = collections.deque()
        # Engine-confirmed prefix-hit depth per request (x-kv-hit-* headers).
        self.kv_hits = PrefixHitLog(self.telemetry, block)
        # Host-staged P/D exports: request_id -> record. Written by the
        # engine thread, read and popped by the server's event loop under
        # _exports_lock; the /kv long-poll reads a record's counters without
        # it (chunk data is appended before the counters move).
        self.kv_exports: dict[str, dict[str, Any]] = {}
        self._exports_lock = threading.Lock()
        # The port a decode peer dials for /kv; the server sets the port it
        # actually bound (cfg.port may be 0).
        self.advertised_port = cfg.port
        # Per-request pull stats (request_id -> {ms, bytes, route[,
        # exposed_ms]}), written by the fetch thread, popped by the server
        # for x-kv-pull-*. Bounded ring.
        self.kv_import_stats: dict[str, dict[str, Any]] = {}
        # Pulls by wire: the device wire, or host bytes (/kv or a shard wire).
        self.kv_import_device_count = 0
        self.kv_import_host_count = 0
        self._kv_import_order: collections.deque[str] = collections.deque()
        # KV events (None when cfg.resolved_kv_events_port() is 0); the
        # server attaches the SSE hub, start() decides the ZMQ leg.
        self.kv_events: KvEventPublisher | None = (
            KvEventPublisher(self.engine_id, host=cfg.host)
            if cfg.resolved_kv_events_port() else None)
        self._last_kv_snapshot = 0.0
        # Device ops other threads ask of the engine thread (embeddings, the
        # group's launch counts): (op, args, Future), run in order with the
        # engine's own, so a group's followers replay them in order too.
        self._op_reqs: list[tuple[tuple, dict, concurrent.futures.Future]] = []
        # P/D KV wires (engine/kv_transfer.py, engine/shard_wire.py), started
        # before the instruction channel so a follower's hello names them.
        self.kv_device_wire: kv_transfer.DeviceWireServer | None = None
        self.kv_shard_wire: shard_wire.ShardWireServer | None = None
        self._kv_wire = cfg.kv_wire
        if self._kv_wire == "auto":
            self._kv_wire = "device" if self.device.type == "cuda" else "host"
        transfer = cfg.kv_transfer
        if transfer == "auto":
            transfer = "device" if self.device.type == "cuda" else "host"
        if self._dist:
            if self._kv_wire == "host":
                self.kv_shard_wire = shard_wire.ShardWireServer(cfg.host)
            else:
                self.kv_device_wire = kv_transfer.DeviceWireServer(cfg.host, self.device)
        elif transfer == "device":
            try:
                self.kv_device_wire = kv_transfer.DeviceWireServer(cfg.host, self.device)
            except Exception:
                if cfg.kv_transfer == "device":
                    raise
                log.info("device wire unavailable; host-staged /kv handoff only",
                         exc_info=True)
        # Multi-process: the instruction channel, and the degrade latch set
        # when a follower dies or the channel breaks (a further collective
        # would hang: the engine aborts everything and refuses work).
        self.dist_degraded = False
        self._release_reqs: list[tuple[str, str]] = []
        self._instr_channel: multihost.InstructionChannel | None = None
        if self._dist:
            self._instr_channel = multihost.InstructionChannel(
                leader=cfg.dist_process_id == 0,
                host=cfg.dist_instr_host or cfg.host, port=cfg.dist_instr_port,
                n_followers=cfg.dist_num_processes - 1,
                recv_timeout=cfg.dist_recv_timeout_s,
                hello={"process_id": cfg.dist_process_id,
                       "shard_wire_address": self._wire_address(self.kv_shard_wire),
                       "device_wire_address": self._wire_address(self.kv_device_wire)})
            if self._instr_channel.leader:
                self._instr_channel.on_peer_lost = self._on_follower_lost

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            params = llama.init_params(self.mcfg, self.device, self.dtype, gen,
                                       layout=self.layout)
        elif self.layout is not None and not isinstance(params, par.ShardedParams):
            # Full weights (init_params, params_from_numpy, convert_hf) are
            # split here; on a device that holds them the shards are views.
            params = par.shard_params(params, self.mcfg, self.layout)
        embed = _embed(params)
        if embed.device.type != self.device.type or embed.dtype != self.dtype:
            raise ValueError(f"params are {embed.dtype} on {embed.device}; the "
                             f"engine runs {self.dtype} on {self.device}")
        self.params = params
        # One K/V page pair on one device, or one per tp rank (a list).
        if self.layout is not None:
            self.k_pages, self.v_pages = par.alloc_sharded_pages(
                self.mcfg, self.layout, self.n_blocks, self.dtype)
        else:
            kshape = (self.mcfg.n_layers, self.n_blocks, block,
                      self.mcfg.n_kv_heads, self.mcfg.head_dim)
            self.k_pages = torch.zeros(kshape, dtype=self.dtype, device=self.device)
            self.v_pages = torch.zeros(kshape, dtype=self.dtype, device=self.device)
        self._client_ssl = None  # client_tls()'s context, built on first use

        # /health answers 503 "warming" until the engine thread has warmed
        # up; a warm-up failure is kept here and stops the engine.
        self.warming = cfg.warmup
        self.failure: BaseException | None = None
        # The E/P/D vision tower, built on first use (vision()).
        self._vision: tuple[vision.VisionConfig, dict] | None = None
        self._vision_lock = threading.Lock()
        self.slots: list[_Slot | None] = [None] * cfg.max_batch
        self._waiting: list[tuple[EngineRequest, asyncio.Queue, asyncio.AbstractEventLoop]] = []
        self._abort_ids: set[str] = set()
        # Pulled (or failed) imports waiting for a slot, and pulls in flight
        # on fetch threads (both keep the drain gate closed).
        self._import_ready: list[_PendingImport] = []
        self._kv_fetching = 0
        self._cond = threading.Condition()
        self._stop = False
        self._thread: threading.Thread | None = None
        self._sample_gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.decode_steps = 0  # decode steps run (a chunk of K adds K)
        # ... of them by pp schedule (parallel/pp_serve.py).
        self.decode_steps_by_schedule = {"ring": 0, "interleave": 0}

    # ---- public API (event-loop side) ---------------------------------

    async def start(self):
        if self.kv_events is not None:
            self.kv_events.zmq_port = self._zmq_events_port()
        self._thread = threading.Thread(target=self._run, name="torch-engine",
                                        daemon=True)
        self._thread.start()

    async def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify()
        if self._thread:
            self._thread.join(timeout=30)
        self._fail_ops("engine stopping")
        self.close()

    def close(self) -> None:
        """Release the followers (leader), and close the instruction
        channel, the KV wires and the event publisher."""
        if self._instr_channel is not None:
            if self._instr_channel.leader:
                # The channel's threads outlive close() by up to a ping
                # interval: they must not keep the engine (its weights) alive.
                self._instr_channel.on_peer_lost = None
                try:
                    self._instr_channel.broadcast(("stop",), {})
                except Exception:
                    log.exception("failed to release followers")
            self._instr_channel.close()
        for wire in (self.kv_device_wire, self.kv_shard_wire):
            if wire is not None:
                wire.close()
        if self.kv_events is not None:
            self.kv_events.close()

    @staticmethod
    def _wire_address(wire) -> str | None:
        return wire.address() if wire is not None else None

    def layout_summary(self) -> str:
        lay = self.layout
        if lay is None:
            return f"one rank on {self.device}"
        return (f"pp={lay.pp} tp={lay.tp} ep={lay.ep}, process {lay.comm.rank if lay.comm else 0}"
                f" of {lay.procs}, ranks on {[str(d) for d in lay.devices]}"
                + (f", backend {lay.comm.backend}" if lay.comm else ""))

    def _zmq_events_port(self) -> int:
        """The ZMQ leg's port: an explicit ``kv_events_port`` needs pyzmq
        (raises without it); the default (-1) is the serving port + 1000,
        off without pyzmq or without a bound serving port."""
        if self.cfg.kv_events_port > 0:
            if not zmq_available():
                raise RuntimeError(
                    f"kv_events_port={self.cfg.kv_events_port} asks for the "
                    "ZMQ event leg, but pyzmq is not installed; pass "
                    "kv_events_port=-1 for SSE alone or 0 for no events")
            return self.cfg.kv_events_port
        if not zmq_available():
            log.warning("pyzmq is not installed: the ZMQ leg of the KV event "
                        "stream is off; /kv_events (SSE) serves the events")
            return 0
        if self.advertised_port <= 0:
            log.info("no bound serving port: the ZMQ leg of the KV event "
                     "stream is off; /kv_events (SSE) serves the events")
            return 0
        return self.advertised_port + 1000

    def idle(self) -> bool:
        """True when nothing is admitted, queued, importing or fetching and
        no export is held for a decode peer (the SIGTERM drain gate)."""
        with self._cond:
            if (any(s is not None for s in self.slots) or self._waiting
                    or self._import_ready or self._kv_fetching
                    or self._op_reqs or self._release_reqs):
                return False
        with self._exports_lock:
            return not self.kv_exports

    def submit(self, req: EngineRequest) -> asyncio.Queue:
        """Thread-safe enqueue; returns the per-request event queue."""
        out: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()
        with self._cond:
            self._queue_submit[req.request_id] = time.monotonic()
            while len(self._queue_submit) > 2048:
                self._queue_submit.pop(next(iter(self._queue_submit)))
            self._waiting.append((req, out, loop))
            self.telemetry.waiting.set(len(self._waiting))
            self._cond.notify()
        return out

    def abort(self, request_id: str) -> None:
        """Thread-safe abort: stops decode and frees blocks for the request."""
        with self._cond:
            self._abort_ids.add(request_id)
            self._cond.notify()

    def release_kv_export(self, request_id: str, *, consumed: str = "host") -> None:
        """Drop a staged P/D export once the decode side has pulled it
        (``consumed``: over which wire; the staged tensors go either way).
        In a group every process staged its own shards, so the release is
        queued for the engine thread, which broadcasts it as an op."""
        if self._dist:
            with self._cond:
                self._release_reqs.append((request_id, consumed))
                self._cond.notify()
            return
        self._release_export_local(request_id)

    def _release_export_local(self, request_id: str) -> None:
        with self._exports_lock:
            rec = self.kv_exports.pop(request_id, None)
        if rec is not None and rec.get("tuid") is not None:
            for wire in (self.kv_device_wire, self.kv_shard_wire):
                if wire is not None:
                    wire.unregister(rec["tuid"])

    def get_kv_export(self, request_id: str) -> dict[str, Any] | None:
        with self._exports_lock:
            return self.kv_exports.get(request_id)

    EMBED_TIMEOUT_S = 600.0

    def embed(self, ids: list[int]) -> np.ndarray:
        """Mean-pooled final-norm hidden state of a prompt ([d_model] f32),
        the /v1/embeddings surface; blocks the caller until the engine
        thread has computed it. Touches no KV page or slot. The prompt
        runs unpadded: the JAX engine pads to a pow2 bucket to bound its
        compile cache, which eager PyTorch does not have, and padding only
        adds rows (and, on MoE models, routed rows) that the mean leaves
        out."""
        if not ids:
            raise ValueError("embed needs at least one token")
        return self._on_engine_thread(("embed",), {"ids": np.asarray(ids, np.int64)},
                                      "embeddings")

    def group_launches(self, reset: bool = False) -> list[dict[str, int]]:
        """Every process's kernel launch counts (``ops.kernel_launches``), in
        process order (one entry for a single process), read on the engine
        thread in order with its ops; ``reset`` sets them to 0 after the
        read."""
        return self._on_engine_thread(("launches",), {"reset": bool(reset)},
                                      "launch counts")

    def last_logits(self, ids: list[int]) -> np.ndarray:
        """The f32 logits [V] at the last position of a prompt's forward
        (every process of a group takes part), read on the engine thread:
        the diagnostic that holds a sharded or staged model to one rank."""
        return self._on_engine_thread(("logits",), {"ids": np.asarray(ids, np.int64)},
                                      "logits")

    def check_kernels(self, atol: float, rtol: float, moe_rel: float,
                      seed: int = 0) -> list[dict[str, tuple[float, bool]]]:
        """Every process launches its kernels at its own shapes and weights,
        on its own devices, and holds each to its plain version: K1 for each
        page shard it holds, on random pages of that shard's geometry (block
        size, local KV heads, head dim, dtype) read through a shuffled block
        table as wide as ``max_model_len``, one row at that length and three
        shorter (elementwise within ``atol + rtol * |plain|``); K2 on its
        first layer's experts where the grouped FFN serves (within
        ``moe_rel * (|plain| + rms(plain))``). The engine's own pages are
        neither read nor written. Returns
        {kernel: (max abs error, within tolerance)} per process, in process
        order. Its launches count like any other: read the counts after."""
        return self._on_engine_thread(("kernel_check",), dict(
            atol=float(atol), rtol=float(rtol), moe_rel=float(moe_rel), seed=int(seed)),
            "kernel checks")

    def page_digests(self, blocks: list[int], n_tokens: int) -> list[list[str]]:
        """Every process's ``kv_shards.shard_digest`` of each page shard it
        holds (K then V, canonical order) at ``blocks``' first ``n_tokens``
        positions, in process order: the bytes of an import, compared
        without moving them."""
        return self._on_engine_thread(("page_digest",), {
            "blocks": np.asarray(blocks, np.int64), "n_tokens": int(n_tokens)},
            "page digests")

    def _on_engine_thread(self, op: tuple, args: dict, what: str):
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cond:
            if self._stop or self._thread is None:
                raise ValueError(f"engine unavailable for {what} "
                                 "(not started or stopping)")
            if self.dist_degraded:
                raise ValueError(f"engine degraded: no {what}")
            self._op_reqs.append((op, args, fut))
            self._cond.notify()
        return fut.result(timeout=self.EMBED_TIMEOUT_S)

    def vision(self) -> tuple[vision.VisionConfig, dict]:
        """The vision tower (config, params) of ``/v1/encode``: ``VIT_TINY``
        projecting into the served model's ``d_model``, so its embeddings
        splice into this model's prefill, with weights drawn from the
        engine's seed on its device. Built on first use."""
        with self._vision_lock:
            if self._vision is None:
                self._vision = vision.build_tower(self.mcfg.d_model, self.cfg.seed,
                                                  self.device)
            return self._vision

    def encode_images(self, pixels: np.ndarray) -> np.ndarray:
        """The tower over ``pixels`` [N, H, W, C] as host f32 embeddings
        [N * n_patches, d_model], item after item. Thread-safe (plain
        PyTorch ops, no kernel wrapper): the server runs it off the event
        loop."""
        return vision.encode_to_host(*self.vision(), pixels, self.device)

    # ---- engine thread -------------------------------------------------

    def _emit(self, slot: _Slot, ev: TokenEvent):
        slot.loop.call_soon_threadsafe(slot.out.put_nowait, ev)

    def _emit_to(self, out, loop, ev: TokenEvent):
        loop.call_soon_threadsafe(out.put_nowait, ev)

    def _abort_to(self, out, loop, req: EngineRequest, prompt_tokens: int) -> None:
        self._emit_to(out, loop, TokenEvent(
            request_id=req.request_id, token_id=None,
            finish_reason=FinishReason.ABORT, prompt_tokens=prompt_tokens))

    def _free_blocks(self, blocks: list[int]) -> None:
        with self._cond:
            self.allocator.free(blocks)
            self.telemetry.observe_allocator(self.allocator)

    def _run(self):
        if self.kv_events is not None:
            # The PUB socket lives on the thread that publishes.
            self.kv_events.bind_now()
        with torch.no_grad():
            if self.cfg.warmup:
                try:
                    self._warmup()
                except Exception as e:
                    # No path serves without its kernel: stop, answering
                    # whatever was queued meanwhile.
                    log.exception("engine warm-up failed; the engine stops")
                    self.failure = e
                    with self._cond:
                        self._stop = True
                    self._abort_all()
                    return
                self.warming = False
            while True:
                with self._cond:
                    while (not self._stop and not self._waiting
                           and not self._import_ready and not self._op_reqs
                           and not self._release_reqs and not self._abort_ids
                           and not any(self.slots)):
                        self._cond.wait(timeout=0.1)
                        self._sweep_exports()
                        # A subscriber that joins an idle, warm engine must
                        # still learn its cache (SSE and PUB replay nothing).
                        self._publish_kv_snapshot()
                    if self._stop:
                        return
                if self.dist_degraded:
                    # Drain everything, queued work included, without
                    # touching the device: a collective would hang on the
                    # lost peer.
                    with self._cond:
                        self._abort_ids.clear()
                        self._release_reqs.clear()
                    self._abort_all("multi-host peer lost")
                    continue
                try:
                    self._step()
                except multihost.ChannelBroken:
                    log.error("instruction channel broken; degrading")
                    self.dist_degraded = True
                except Exception:
                    log.exception("engine loop failure; aborting in-flight requests")
                    self._abort_all()

    def _warmup(self):
        """Build every CUDA kernel the model's paths launch (K1, K3, K4; K2
        with the grouped MoE FFN), then run each serving shape once with all
        writes on the trash block 0: a 16-token prefill; with
        ``prefill_chunk``, one window with no prior part and one over one
        prior block; with ``prefill_batch``, a batched prefill; one decode
        chunk at every batch bucket ``_batch_bucket`` can produce; with role
        ``encode``, the vision tower. Greedy lanes draw nothing from the
        sampling generator, so the outputs do not depend on the warm-up."""
        t0 = time.monotonic()
        if self.device.type == "cuda":
            kernels = [paged_attention.KERNEL, prefill_attention.KERNEL, fused_norm.KERNEL]
            if self.mcfg.moe_impl == "grouped":
                kernels.append(grouped_moe.KERNEL)
            _build.build(kernels)
        block = self.mcfg.kv_block_size
        row = np.zeros((1, self.max_blocks_per_seq), np.int32)
        windows = [(min(16, self.cfg.max_model_len - 1), 0)]
        win = self._prefill_window()
        if win:
            windows += [(min(win, self.cfg.max_model_len - 1), 0),
                        (min(win, self.cfg.max_model_len - 1 - block), block)]
        for n, prior in windows:
            if n > 0:
                self._prefill_rows([_DUMMY_REQ], [[0] * n], row, prior_len=[prior])
        K, n = self._prefill_batch(), windows[0][0]
        if K > 1 and n > 0:
            self._prefill_rows([_DUMMY_REQ] * K, [[0] * n] * K,
                               np.zeros((K, self.max_blocks_per_seq), np.int32))
        steps = self.decode_steps, dict(self.decode_steps_by_schedule)
        W, b = self.max_blocks_per_seq, 1
        while True:
            B = self._batch_bucket(b)
            self._decode_chunk(np.zeros((B,), np.int32), np.zeros((B,), np.int32),
                               np.zeros((B, W), np.int32), [_DUMMY_REQ] * B)
            if B >= self.cfg.max_batch:
                break
            b = 2 * B
        self.decode_steps, self.decode_steps_by_schedule = steps
        if self.cfg.role == "encode":
            vcfg, _ = self.vision()
            self.encode_images(np.zeros(
                (1, vcfg.image_size, vcfg.image_size, vcfg.channels), np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log.info("engine warm-up ran prefill, decode buckets up to %d%s in %.1fs",
                 self.cfg.max_batch,
                 " and the vision tower" if self.cfg.role == "encode" else "",
                 time.monotonic() - t0)

    def _step(self):
        self._drain_release_reqs()
        self._drain_op_reqs()
        self._sweep_exports()
        self._publish_kv_snapshot()
        self._process_aborts()
        self._process_imports()
        self._admit()
        self._advance_prefills()
        if any(s is not None and s.pending_tok is None and not s.prefilling
               for s in self.slots):
            # Queue the decode chunk of the established lanes, then land the
            # pending first tokens (the chunk's readback synchronised them).
            self._decode_once()
            self._finalize_prefills()
        elif any(s is not None for s in self.slots):
            self._finalize_prefills()
        else:
            with self._cond:
                if (self._waiting or self._import_ready) and not self._abort_ids:
                    # Head-of-line can't be placed yet: sleep until it can.
                    self._cond.wait(timeout=0.05)

    def _abort_all(self, why: str = "engine loop failure"):
        for i, s in enumerate(self.slots):
            if s is not None:
                self._finish_slot(i, FinishReason.ABORT)
        with self._cond:
            drained, self._waiting = self._waiting, []
            self.telemetry.waiting.set(0)
            imports, self._import_ready = self._import_ready, []
        self._fail_ops(why)
        for pi in imports:
            if pi.done is not None:
                pi.done()  # close a device pull's IPC handles
        drained += [(pi.req, pi.out, pi.loop) for pi in imports]
        for req, out, loop in drained:
            self._abort_to(out, loop, req, len(req.prompt_token_ids))

    def _fail_ops(self, why: str) -> None:
        with self._cond:
            reqs, self._op_reqs = self._op_reqs, []
        for op, _, fut in reqs:
            if not fut.done():
                fut.set_exception(ValueError(f"{op[0]} not run: {why}"))

    def _drain_op_reqs(self):
        with self._cond:
            reqs, self._op_reqs = self._op_reqs, []
        for op, args, fut in reqs:
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(self._device_call(op, args))
            except multihost.ChannelBroken as e:
                fut.set_exception(e)
                raise
            except Exception as e:
                fut.set_exception(e)

    def _drain_release_reqs(self):
        """Broadcast the queued export releases (multi-process: every process
        drops its own staged shards)."""
        with self._cond:
            reqs, self._release_reqs = self._release_reqs, []
        for rid, consumed in reqs:
            self._device_call(("release_kv_export",),
                              {"request_id": rid, "consumed": consumed})

    def _on_follower_lost(self, idx: int, why: str) -> None:
        """The instruction channel's peer-monitor callback (its watch
        thread): the group's lockstep is over."""
        log.error("follower %d lost (%s): engine degrading; the group needs "
                  "a coordinated restart", idx, why)
        self.dist_degraded = True
        if self.comm is not None:
            self.comm.abort()  # a collective in flight raises now
        with self._cond:
            self._cond.notify()

    def _publish_kv_snapshot(self):
        """Re-publish the cache's block hashes at most once a second (SSE
        and PUB have no replay: a late subscriber converges from this). With
        prefix caching the content-addressed map is the cache (active and
        parked blocks); without it, the live slots' blocks."""
        if self.kv_events is None:
            return
        now = time.monotonic()
        if now - self._last_kv_snapshot < 1.0:
            return
        self._last_kv_snapshot = now
        if isinstance(self.allocator, PrefixCachingAllocator):
            hashes = self.allocator.cached_hashes()
        else:
            hashes = [h for s in self.slots if s is not None
                      for h in s.block_hashes]
        self.kv_events.stored(hashes)

    def _publish(self, event: str, hashes: list[int]) -> None:
        if self.kv_events is not None and hashes:
            self.kv_events.publish(event, hashes)

    def _sweep_exports(self):
        if self._instr_channel is not None and not self._instr_channel.leader:
            return  # a follower's exports go with the leader's releases
        now = time.monotonic()
        with self._exports_lock:
            expired = [rid for rid, rec in self.kv_exports.items()
                       if now - rec["created"] > KV_EXPORT_TTL_S]
        for rid in expired:
            log.warning("kv export %s expired unclaimed; dropping", rid)
            self.release_kv_export(rid)

    def _process_aborts(self):
        with self._cond:
            ids, self._abort_ids = self._abort_ids, set()
            if not ids:
                return
            keep = []
            for req, out, loop in self._waiting:
                if req.request_id in ids:
                    self._abort_to(out, loop, req, len(req.prompt_token_ids))
                else:
                    keep.append((req, out, loop))
            self._waiting = keep
            self.telemetry.waiting.set(len(self._waiting))
        for i, s in enumerate(self.slots):
            if s is not None and s.req.request_id in ids:
                self._finish_slot(i, FinishReason.ABORT)

    # ---- admission -----------------------------------------------------

    def _blocks_needed(self, req: EngineRequest) -> int:
        total = min(len(req.prompt_token_ids) + req.max_tokens,
                    self.cfg.max_model_len)
        need = self.allocator.blocks_for_tokens(total)
        ktp = req.kv_transfer_params or {}
        if ktp.get("remote_num_blocks"):
            need = max(need, int(ktp["remote_num_blocks"]))
        return need

    def _record_queue_wait(self, request_id: str) -> None:
        """First-pop-wins admission wait, popped by the server for
        x-engine-queue-ms."""
        t0 = self._queue_submit.pop(request_id, None)
        if t0 is None:
            return
        self.queue_waits[request_id] = (time.monotonic() - t0) * 1e3
        self._queue_wait_order.append(request_id)
        while len(self._queue_wait_order) > 512:
            self.queue_waits.pop(self._queue_wait_order.popleft(), None)

    def _admit(self):
        group: list[tuple[int, EngineRequest, Any, Any, int]] = []
        for i, slot in enumerate(self.slots):
            if slot is not None:
                continue
            with self._cond:
                if not self._waiting:
                    break
                req, out, loop = self._waiting[0]
                need = self._blocks_needed(req)
                if need > self.n_blocks - 1:
                    # Impossible request: reject instead of wedging the queue.
                    self._waiting.pop(0)
                    self.telemetry.waiting.set(len(self._waiting))
                    self._record_queue_wait(req.request_id)
                    self._abort_to(out, loop, req, len(req.prompt_token_ids))
                    continue
                if (req.kv_transfer_params or {}).get("remote_host") is not None:
                    # Pull off-thread; the KV comes back via _import_ready.
                    self._waiting.pop(0)
                    self.telemetry.waiting.set(len(self._waiting))
                    self._record_queue_wait(req.request_id)
                    self._start_kv_fetch(req, out, loop)
                    continue
                available = getattr(self.allocator, "reusable_blocks",
                                    self.allocator.free_blocks)
                if need + sum(g[4] for g in group) > available:
                    break  # head-of-line waits for capacity
                self._waiting.pop(0)
                self.telemetry.waiting.set(len(self._waiting))
                self._record_queue_wait(req.request_id)
            group.append((i, req, out, loop, need))
        self._flush_admissions(group)

    # ---- batched prefill -------------------------------------------------

    def _bucket(self, n: int) -> int:
        """The JAX engine's prefill bucket: a power of two from 16, capped at
        ``max_model_len``. Batched prefill groups prompts by it."""
        b = 16
        while b < n:
            b *= 2
        return min(b, self.cfg.max_model_len)

    def _flush_admissions(self, group):
        """Dispatch the collected admissions, with the JAX engine's grouping:
        same-bucket plain prompts batch, up to ``prefill_batch`` at a time,
        into one [N, S] prefill; multimodal prompts, cache probes,
        remote-decode exports, prompts longer than the incremental window,
        prefix-cache hits, in-group duplicate chains and groups that shrink
        to one take the single path. Batches go first, so the single path's
        prefix matches see the hashes they committed. A failed dispatch
        answers every entry not dispatched yet with ABORT (they are off the
        queue already) and frees its blocks."""
        K = self._prefill_batch()
        win = self._prefill_window()
        singles: list[tuple] = []    # (i, req, out, loop, need, pre | None)
        by_bucket: dict[int, list[tuple]] = {}
        for i, req, out, loop, need in group:
            if (K <= 1 or req.mm_embeds is not None
                    or req.cache_hit_threshold is not None
                    or (req.kv_transfer_params or {}).get("do_remote_decode")):
                singles.append((i, req, out, loop, need, None))
                continue
            pre = self._prompt_and_hashes(req)
            if win and len(pre[0]) > win:
                singles.append((i, req, out, loop, need, pre))
                continue
            by_bucket.setdefault(self._bucket(len(pre[0])), []).append(
                (i, req, out, loop, need, pre))
        batches: list[list[tuple]] = []  # entries + their blocks
        seen_chains: set[tuple] = set()
        for entries in by_bucket.values():
            while entries:
                chunk, entries = entries[:K], entries[K:]
                if len(chunk) == 1:
                    singles.append(chunk[0])
                    continue
                prepared = []
                for entry in chunk:
                    _, req, _, _, need, (prompt, hashes, caching) = entry
                    blocks = None
                    if not (hashes and tuple(hashes) in seen_chains):
                        blocks = self._try_prepare_batch_entry(need, prompt, hashes,
                                                               caching)
                    if blocks is None:  # a duplicate or a prefix hit
                        singles.append(entry)
                        continue
                    if hashes:
                        seen_chains.add(tuple(hashes))
                    prepared.append((*entry, blocks))
                if len(prepared) == 1:
                    # The group shrank to one: the single path allocates
                    # its own blocks (fewer after a prefix match).
                    *entry, blocks = prepared[0]
                    self._free_blocks(blocks)
                    singles.append(tuple(entry))
                elif prepared:
                    batches.append(prepared)
        n_started = 0
        try:
            for prepared in batches:
                n_started += 1
                self._run_batched_prefill(prepared)
            while singles:
                self._prefill_into_slot(*singles.pop(0))
        except Exception:
            # The failing dispatch answered its own entries.
            for prepared in batches[n_started:]:
                for _, req, out, loop, _, pre, blocks in prepared:
                    self._free_blocks(blocks)
                    self._abort_to(out, loop, req, len(pre[0]))
            for _, req, out, loop, _, _ in singles:
                self._abort_to(out, loop, req, len(req.prompt_token_ids))
            raise

    def _prefill_batch(self) -> int:
        """Prompts per prefill dispatch: ``prefill_batch``, or 1 for a pp
        engine, which prefills one prompt at a time as the JAX one does (its
        stage ring is traced at [1, S])."""
        return 1 if self.cfg.pp_size > 1 else max(self.cfg.prefill_batch, 1)

    def _prompt_and_hashes(self, req: EngineRequest):
        """(truncated prompt, chain hashes, caching on) of a request, shared
        by the single and batched paths. A multimodal prompt is not
        content-addressable by its token ids (the same placeholders carry
        other images): no prefix cache and no KV events for it."""
        prompt = req.prompt_token_ids[: self.cfg.max_model_len - 1]
        if len(prompt) < len(req.prompt_token_ids):
            log.warning("request %s: prompt truncated %d -> %d tokens",
                        req.request_id, len(req.prompt_token_ids), len(prompt))
        mm = req.mm_embeds is not None
        caching = isinstance(self.allocator, PrefixCachingAllocator) and not mm
        hashes = (chain_block_hashes(self.model_name, prompt, "", self.mcfg.kv_block_size)
                  if caching or (self.kv_events is not None and not mm) else [])
        return prompt, hashes, caching

    def _try_prepare_batch_entry(self, need: int, prompt, hashes, caching: bool):
        """The blocks of a batchable prompt, or None when it has a prefix-cache
        hit (the single path prefills only its suffix)."""
        with self._cond:
            if caching and hashes:
                max_match = (len(prompt) - 1) // self.mcfg.kv_block_size
                if self.allocator.match_prefix(hashes)[:max_match]:
                    return None
            blocks = self.allocator.alloc(need)
            evicted = list(getattr(self.allocator, "last_evicted_hashes", []))
            self.telemetry.observe_allocator(self.allocator)
        self._publish("removed", evicted)
        return blocks

    def _run_batched_prefill(self, entries: list[tuple]):
        """One prefill of N plain prompts (``_prefill_rows``); each
        slot lands pending with its row of the sampled first tokens. On a
        failure every entry not slotted yet is freed and answered ABORT."""
        block = self.mcfg.kv_block_size
        t0 = time.monotonic()
        try:
            rows = np.zeros((len(entries), self.max_blocks_per_seq), np.int32)
            for k, e in enumerate(entries):
                rows[k, : len(e[6])] = e[6]
            toks = self._prefill_rows([e[1] for e in entries],
                                      [e[5][0] for e in entries], rows)
            self.telemetry.prefill_step.observe(time.monotonic() - t0)
            for k, (i, req, out, loop, _, pre, blocks) in enumerate(entries):
                prompt, hashes, caching = pre
                self.telemetry.prompt_tokens.inc(len(prompt))
                self.kv_hits.note(req.request_id, 0, len(prompt))
                slot = _Slot(req=req, out=out, loop=loop, blocks=blocks,
                             position=len(prompt), generated=[], last_token=-1,
                             pending_tok=toks[k], prompt_len=len(prompt))
                n_complete = len(prompt) // block
                if caching:
                    with self._cond:
                        self.allocator.commit_hashes(blocks[:n_complete],
                                                     hashes[:n_complete])
                slot.block_hashes = hashes[:n_complete]
                self._publish("stored", slot.block_hashes)
                self.slots[i] = slot
        except Exception:
            for i, req, out, loop, _, pre, blocks in entries:
                s = self.slots[i]
                if s is None or s.req is not req:
                    self._free_blocks(blocks)
                    self._abort_to(out, loop, req, len(pre[0]))
            raise
        finally:
            self.telemetry.running.set(sum(s is not None for s in self.slots))

    # ---- prefill -------------------------------------------------------

    def _prefill_into_slot(self, idx, req, out, loop, need: int, precomputed=None):
        block = self.mcfg.kv_block_size
        prompt, hashes, caching = precomputed or self._prompt_and_hashes(req)
        mm = req.mm_embeds is not None

        # Automatic prefix caching: reuse the longest cached run of complete
        # prompt blocks, keeping >= 1 suffix token so logits can be computed.
        max_match = (len(prompt) - 1) // block
        matched_bids: list[int] = []
        if caching and hashes:
            with self._cond:
                matched_bids = self.allocator.match_prefix(hashes)[:max_match]
        if req.cache_hit_threshold is not None and prompt:
            # Shared-storage probe: end before any allocation when the cache
            # covers too little of the matchable prefix (complete blocks
            # less the suffix token, so a fully warm cache scores 1.0); the
            # sidecar then prefills remotely and asks again.
            ratio = len(matched_bids) / max_match if max_match else 1.0
            if ratio < req.cache_hit_threshold:
                cached = len(matched_bids) * block
                self.kv_hits.note(req.request_id, cached, len(prompt), kind="probe")
                self.telemetry.request_success.labels(
                    finished_reason=FinishReason.CACHE_THRESHOLD.value).inc()
                self._emit_to(out, loop, TokenEvent(
                    request_id=req.request_id, token_id=None,
                    finish_reason=FinishReason.CACHE_THRESHOLD,
                    prompt_tokens=len(prompt), cached_tokens=cached))
                return
        with self._cond:
            if matched_bids:
                self.allocator.acquire_cached(matched_bids)
            blocks = matched_bids + self.allocator.alloc(need - len(matched_bids))
            evicted = list(getattr(self.allocator, "last_evicted_hashes", []))
            self.telemetry.observe_allocator(self.allocator)
        self._publish("removed", evicted)

        cached_tokens = len(matched_bids) * block
        suffix = prompt[cached_tokens:]
        self.kv_hits.note(req.request_id, cached_tokens, len(prompt))
        if matched_bids:
            self.telemetry.prefix_cached_tokens.inc(cached_tokens)

        win = self._prefill_window()
        if win and len(suffix) > win and not mm:
            # Long prompt: park the slot PREFILLING; _advance_prefills
            # writes one window per engine step (interleaved with decode).
            self.slots[idx] = _Slot(
                req=req, out=out, loop=loop, blocks=blocks, position=len(prompt),
                generated=[], last_token=-1, cached_tokens=cached_tokens,
                prompt_len=len(prompt), prefilling=True, prefill_rest=list(suffix),
                prefill_written=cached_tokens, chunk_meta=(hashes, caching))
            self.telemetry.running.set(sum(s is not None for s in self.slots))
            return

        row = np.zeros((1, self.max_blocks_per_seq), np.int32)
        row[0, : len(blocks)] = blocks
        t0 = time.monotonic()
        try:
            tok_dev = self._run_prefill(req, prompt, suffix, cached_tokens,
                                        matched_bids, row)
        except Exception:
            self._free_blocks(blocks)
            self._abort_to(out, loop, req, len(prompt))
            raise
        self.telemetry.prefill_step.observe(time.monotonic() - t0)
        self.telemetry.prompt_tokens.inc(len(suffix))

        slot = _Slot(req=req, out=out, loop=loop, blocks=blocks,
                     position=len(prompt), generated=[], last_token=-1,
                     cached_tokens=cached_tokens, pending_tok=tok_dev,
                     prompt_len=len(prompt))
        n_complete = len(prompt) // block
        if caching:
            # Content-address the freshly computed complete prompt blocks.
            with self._cond:
                self.allocator.commit_hashes(
                    blocks[len(matched_bids):n_complete],
                    hashes[len(matched_bids):n_complete])
        slot.block_hashes = hashes[:n_complete]
        self._publish("stored", slot.block_hashes)
        self.slots[idx] = slot
        self.telemetry.running.set(sum(s is not None for s in self.slots))

    def _to_dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _run_prefill(self, req, prompt, suffix, cached_tokens, matched_bids,
                     row) -> torch.Tensor:
        """One request's prefill (``_prefill_rows`` with one row) and
        first-token sample; returns the token on the device. ``suffix``,
        the tokens of ``prompt`` from ``cached_tokens`` on (the whole
        prompt, a cache hit's suffix or a window), continues from the KV of
        those tokens' blocks ``matched_bids``, the head of ``row``; a
        multimodal request's embeddings are spliced in. The dispatch reads
        ``suffix``, ``cached_tokens`` and ``row``; ``h100_bench/trace.py``
        wraps this call by its whole signature."""
        return self._prefill_rows([req], [suffix], row, prior_len=[cached_tokens],
                                  **self._mm_args(req))[0]

    def _prefill_rows(self, reqs, windows, rows: np.ndarray, prior_len=None,
                      **mm) -> torch.Tensor:
        """One prefill dispatch of N rows (the ``prefill`` op): row k
        computes ``windows[k]`` at positions ``prior_len[k]`` on (0
        without), attending over the KV its block-table row ``rows[k]``
        holds before them (a block multiple), and writes its KV into that
        row, padding positions into the trash block 0. S is the longest
        window (eager PyTorch has no compile cache to bound, so no padding
        rows and no bucket padding). Returns the N tokens sampled at the
        rows' last real positions, on the device."""
        N, S = len(windows), max(len(w) for w in windows)
        tokens = np.zeros((N, S), np.int32)
        for k, w in enumerate(windows):
            tokens[k, : len(w)] = w
        args = dict(tokens=tokens, new_len=np.asarray([len(w) for w in windows], np.int32),
                    rows=rows)
        P = max(prior_len or [0]) // self.mcfg.kv_block_size
        if P:
            args |= dict(prior_len=np.asarray(prior_len, np.int32),
                         prior=np.ascontiguousarray(rows[:, :P]))
        return self._device_call(("prefill",), args | self._sample_args(reqs) | mm)

    def _mm_args(self, req: EngineRequest) -> dict[str, np.ndarray]:
        """The ``prefill`` op's splice arguments for a multimodal request
        (a batch of one); missing or short ``mm_positions`` default to the
        image-first layout, as in the JAX engine."""
        if req.mm_embeds is None:
            return {}
        mm = np.asarray(req.mm_embeds, np.float32)
        positions = list(req.mm_positions or [])
        positions += range(len(positions), mm.shape[0])
        return {"mm_embeds": mm[None],
                "mm_positions": np.asarray([positions[: mm.shape[0]]], np.int64)}

    def _finalize_prefills(self):
        """Land pending first tokens and emit/finish accordingly."""
        for idx, slot in enumerate(self.slots):
            if slot is None or slot.pending_tok is None or slot.prefilling:
                continue
            tok = int(slot.pending_tok.item())
            slot.pending_tok = None
            slot.generated = [tok]
            slot.last_token = tok
            req = slot.req
            self.telemetry.ttft.observe(time.monotonic() - req.arrival_time)
            self.telemetry.generation_tokens.inc()
            if (req.kv_transfer_params or {}).get("do_remote_decode"):
                # Remote-decode prefill: hand the KV off instead of decoding.
                self._finish_slot(idx, FinishReason.LENGTH,
                                  retain_for_transfer=True, first_token=tok)
                continue
            self._emit(slot, TokenEvent(
                request_id=req.request_id, token_id=tok,
                text=self.tokenizer.decode([tok]), is_first=True,
                prompt_tokens=slot.prompt_len, completion_tokens=1,
                cached_tokens=slot.cached_tokens))
            slot.first_emitted = True
            self._maybe_finish_after_token(idx, tok)

    # ---- incremental prefill -------------------------------------------

    def _prefill_window(self) -> int:
        """Incremental-prefill window in tokens (a KV-block multiple, so every
        intermediate boundary is block-aligned); 0 = disabled."""
        w = self.cfg.prefill_chunk
        if w <= 0:
            return 0
        block = self.mcfg.kv_block_size
        return max(block, -(-w // block) * block)

    def _advance_prefills(self):
        """Write ONE window for the first PREFILLING slot. The last window's
        sample becomes the pending first token (earlier windows' samples are
        discarded); the prefix-cache commit waits for it."""
        for idx, s in enumerate(self.slots):
            if s is None or not s.prefilling:
                continue
            block = self.mcfg.kv_block_size
            window = s.prefill_rest[: self._prefill_window()]
            last = len(window) == len(s.prefill_rest)
            written = s.prefill_written
            req = s.req
            row = np.zeros((1, self.max_blocks_per_seq), np.int32)
            row[0, : len(s.blocks)] = s.blocks
            t0 = time.monotonic()
            try:
                tok_dev = self._run_prefill(req, window, window, written,
                                            s.blocks[: written // block], row)
            except Exception:
                self.slots[idx] = None
                self._drop_partial_export(req.request_id)
                self._free_blocks(s.blocks)
                self._abort_to(s.out, s.loop, req, s.prompt_len)
                self.telemetry.running.set(sum(x is not None for x in self.slots))
                raise
            self.telemetry.prefill_step.observe(time.monotonic() - t0)
            self.telemetry.prompt_tokens.inc(len(window))
            s.prefill_written = written + len(window)
            s.prefill_rest = s.prefill_rest[len(window):]
            if not last:
                # A chunk-streamed export stages the window's newly complete
                # blocks now; the final partial block rides _finish_slot.
                self._maybe_stage_chunk(s)
                return
            hashes, caching = s.chunk_meta
            s.chunk_meta = None
            s.prefilling = False
            s.pending_tok = tok_dev
            n_complete = s.prompt_len // block
            if caching:
                matched_n = s.cached_tokens // block
                with self._cond:
                    self.allocator.commit_hashes(s.blocks[matched_n:n_complete],
                                                 hashes[matched_n:n_complete])
            s.block_hashes = hashes[:n_complete]
            self._publish("stored", s.block_hashes)
            return  # one window per step

    # ---- P/D export (prefill side) ---------------------------------------

    def _page_pairs(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """(K, V) pages per (stage, tp) rank this process holds (one pair on
        one device), in canonical shard order."""
        if self.layout is None:
            return [(self.k_pages, self.v_pages)]
        return list(zip(kv_shards.local_unique_shards(self.k_pages),
                        kv_shards.local_unique_shards(self.v_pages)))

    def _gather_to_host(self, ids: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """The pages of ``ids`` as host tensors [L, len(ids), block, Hkv, Dh]:
        the single-device layout, with a sharded engine's kv-head shards
        joined in rank order and its stages along the layer axis. Blocks the
        engine thread until the device has written them (the copy waits
        behind any decode chunk already queued)."""
        ks, vs = [], []
        for kp, vp in self._page_pairs():
            idx = torch.tensor(ids, dtype=torch.long, device=kp.device)
            ks.append(kp[:, idx].cpu())
            vs.append(vp[:, idx].cpu())
        tp = self.cfg.tp_size
        return par.join_pages(ks, tp), par.join_pages(vs, tp)

    def _maybe_stage_chunk(self, s: _Slot) -> None:
        """Chunk-streamed remote-decode prefill (``stream_chunks``): gather the
        newly COMPLETE blocks to the host and append them to the request's
        export record, created at the first chunk (``complete=False``) so the
        drain gate holds the engine for the decode peer from then on."""
        ktp = s.req.kv_transfer_params or {}
        if not (ktp.get("do_remote_decode") and ktp.get("stream_chunks")) or self._dist:
            return  # a group's export has no host /kv route
        rid = s.req.request_id
        with self._exports_lock:
            rec = self.kv_exports.get(rid)
        upto = min(s.prefill_written // self.mcfg.kv_block_size, len(s.blocks))
        staged = rec["blocks_staged"] if rec is not None else 0
        if upto <= staged:
            return
        if rec is None:
            rec = {"created": time.monotonic(), "seq_len": s.prompt_len,
                   "num_blocks": len(s.blocks), "chunk_data": [],
                   "chunk_blocks": [], "chunks_staged": 0, "blocks_staged": 0,
                   "complete": False}
            with self._exports_lock:
                self.kv_exports[rid] = rec
        k, v = self._gather_to_host(s.blocks[staged:upto])
        # Data BEFORE the counters: the /kv long-poll reads chunks_staged
        # without the lock, and a reader that sees N chunks must find N.
        rec["chunk_data"].append((k, v))
        rec["chunk_blocks"].append(upto - staged)
        rec["blocks_staged"] = upto
        rec["chunks_staged"] += 1

    def _op_stage_kv(self, request_id: str, idx: np.ndarray, tuid: int,
                     stream: bool, meta: dict[str, Any]) -> dict[str, Any]:
        """Stage a finished remote-decode prefill's blocks (``idx``,
        pow2-padded) as its export record (the ``stage_kv`` op, run on every
        process of a group): on the host for the /kv route (one process),
        and each page shard on the device for the KV wires, registered under
        ``tuid``. A chunk-streamed export keeps the chunks already staged and
        reads incomplete until _finalize_chunk_export stages the tail."""
        rec: dict[str, Any] = {"created": time.monotonic(), **meta}
        pairs = self._page_pairs()
        ids = torch.from_numpy(np.ascontiguousarray(idx)).long()
        ks = kv_transfer.stage([k for k, _ in pairs], ids)
        vs = kv_transfer.stage([v for _, v in pairs], ids)
        if not self._dist:
            # The /kv wire's single-device layout (kv-head shards joined,
            # then stages along the layer axis).
            tp = self.cfg.tp_size
            rec["k"] = par.join_pages([t.cpu() for t in ks], tp)
            rec["v"] = par.join_pages([t.cpu() for t in vs], tp)
        if self.kv_device_wire is not None or self.kv_shard_wire is not None:
            shards = ks + vs
            for wire in (self.kv_device_wire, self.kv_shard_wire):
                if wire is not None:
                    wire.register(tuid, shards)
            rec["tuid"] = tuid
            if self.comm is not None:
                # Every process's shards are registered before the leader
                # names the export: an importer's process may pull at once.
                self.comm.barrier(self.device)
        with self._exports_lock:
            prev = self.kv_exports.get(request_id)
            if prev is not None and "chunks_staged" in prev:
                for key in ("chunk_data", "chunk_blocks", "chunks_staged",
                            "blocks_staged"):
                    rec[key] = prev[key]
                rec["complete"] = False
            elif stream and not self._dist:
                # A short stream_chunks prompt (no mid-prefill chunks): a
                # puller may already be polling its pre-assigned id.
                rec.update({"chunk_data": [], "chunk_blocks": [],
                            "chunks_staged": 0, "blocks_staged": 0,
                            "complete": False})
            self.kv_exports[request_id] = rec
        return rec

    @staticmethod
    def _finalize_chunk_export(rec: dict[str, Any], n_blocks: int) -> None:
        """The blocks not staged yet (the final partial block included)
        become the last chunk, sliced from the full staged tensors; then
        ``complete`` flips and the decode peer's long-poll ends."""
        staged = rec["blocks_staged"]
        if n_blocks > staged:
            rec["chunk_data"].append((rec["k"][:, staged:n_blocks],
                                      rec["v"][:, staged:n_blocks]))
            rec["chunk_blocks"].append(n_blocks - staged)
            rec["blocks_staged"] = n_blocks
            rec["chunks_staged"] += 1
        rec["complete"] = True

    def _drop_partial_export(self, request_id: str) -> None:
        """Reclaim a partly staged chunk export whose prefill died: the decode
        peer's next poll 404s and it falls back to local prefill. Completed
        exports stay for the importer's release or the TTL sweep."""
        with self._exports_lock:
            rec = self.kv_exports.get(request_id)
            if rec is not None and not rec.get("complete", True):
                self.kv_exports.pop(request_id, None)

    # ---- P/D import (decode side) ----------------------------------------

    def _start_kv_fetch(self, req, out, loop):
        """Pull the exporter's staged KV on a thread of its own (the engine
        thread keeps decoding meanwhile)."""
        pi = _PendingImport(req=req, out=out, loop=loop)
        with self._cond:
            self._kv_fetching += 1

        def fetch():
            try:
                self._fetch(pi, req.kv_transfer_params or {})
            finally:
                with self._cond:
                    self._kv_fetching -= 1
                    self._cond.notify()

        threading.Thread(target=fetch, name="kv-fetch", daemon=True).start()

    KV_IMPORT_STATS_CAP = 512
    # Overall stall bound of one chunk-streamed pull (each poll is bounded by
    # the server's KV_CHUNK_WAIT_CAP_MS).
    KV_CHUNK_STREAM_TIMEOUT_S = 120.0

    def _note_kv_import(self, request_id: str, t0: float, nbytes: int,
                        route: str, exposed_ms: float | None = None) -> None:
        """Record one pull's duration and bytes for x-kv-pull-* on the decode
        response; chunk-streamed pulls also carry the non-overlapped tail."""
        if route == "device":
            self.kv_import_device_count += 1
        else:
            self.kv_import_host_count += 1
        if request_id not in self.kv_import_stats:
            self._kv_import_order.append(request_id)
        stats = {"ms": (time.monotonic() - t0) * 1e3, "bytes": int(nbytes),
                 "route": route}
        if exposed_ms is not None:
            stats["exposed_ms"] = exposed_ms
        self.kv_import_stats[request_id] = stats
        while len(self._kv_import_order) > self.KV_IMPORT_STATS_CAP:
            self.kv_import_stats.pop(self._kv_import_order.popleft(), None)

    def _wire_route(self, ktp: dict[str, Any]) -> tuple[str, list[str]] | None:
        """(wire, per-process addresses) of a port exporter's KV wire this
        engine pulls over, or None when the exporter names none it can use
        (a JAX exporter's keys are never used). Raises when the exporter's
        page geometry differs from this engine's."""
        if self._dist:
            wire = self._kv_wire
        elif self.kv_device_wire is not None:
            wire = "device"
        else:
            return None
        addrs = ktp.get(f"kv_wire_{wire}")
        if not addrs or not all(addrs) or ktp.get("transfer_uuid") is None:
            return None
        theirs = ktp.get("kv_mesh")
        if theirs != self._mesh_descriptor():
            raise ValueError(f"page sharding mismatch: {theirs} vs "
                             f"{self._mesh_descriptor()}")
        if len(addrs) != (theirs["n_procs"] if theirs else 1):
            raise ValueError("shard address count != exporter processes")
        if wire == "device" and not all(kv_transfer.on_this_node(str(a).rpartition(":")[0])
                                        for a in addrs):
            # CUDA IPC works only within a node; refused before a group's
            # leader broadcasts a pull its followers could not finish.
            raise ValueError(f"device wire addresses {addrs} are not all on this node")
        return wire, list(addrs)

    def _mesh_descriptor(self) -> dict[str, Any] | None:
        """The JAX ``mesh_descriptor`` of this engine's page sharding (None
        for one rank's pages)."""
        lay = self.layout
        if lay is None:
            return None
        return kv_shards.mesh_descriptor(lay.tp, lay.ep, lay.pp, lay.procs)

    def _fetch(self, pi: _PendingImport, ktp: dict[str, Any]) -> None:
        """Fetch-thread body: pull over the exporter's KV wire (a group's
        pull only preflights here: it runs as an op on every process), or
        over its /kv route (whole, or chunk by chunk), release the export,
        and hand the import to the engine thread; any failure is recorded on
        ``pi`` (local prefill)."""
        t0 = time.monotonic()
        try:
            route = self._wire_route(ktp)
            if route is not None:
                wire, addrs = route
                if self._dist:
                    for addr in addrs:
                        _tcp_preflight(addr)
                    pi.dist_pull = True
                else:
                    pi.shards, pi.done = kv_transfer.pull(addrs[0], int(ktp["transfer_uuid"]))
                    pi.open_s = time.monotonic() - t0
                with self._cond:
                    self._import_ready.append(pi)
                    self._cond.notify()
                return
        except Exception as e:
            log.warning("kv wire pull for %s failed (%s); %s", pi.req.request_id, e,
                        "local prefill" if self._dist else "host /kv fallback")
        if self._dist:
            # No host path for a group (its pages live in several
            # processes): prefill locally.
            pi.error = "no usable sharded transfer route"
            with self._cond:
                self._import_ready.append(pi)
                self._cond.notify()
            return
        try:
            scheme = ktp.get("remote_scheme") or "http"
            if scheme not in ("http", "https"):
                raise ValueError(f"{scheme} /kv pull: this engine dials http or https")
            path = "/kv/" + urllib.parse.quote(str(ktp["remote_request_id"]), safe="")
            context = self.client_tls() if scheme == "https" else None
            with kv_wire.KvClient(ktp["remote_host"], ktp["remote_port"],
                                  context=context) as c:
                if ktp.get("stream_chunks"):
                    self._pull_host_chunks(pi, c, path, t0)
                else:
                    self._pull_full(pi, c, path, t0)
                try:
                    c.delete(path)
                except (OSError, http.client.HTTPException, kv_wire.KvHTTPError):
                    pass  # the exporter's TTL sweep reclaims it
        except Exception as e:
            pi.error = f"{type(e).__name__}: {e}"
        with self._cond:
            self._import_ready.append(pi)
            self._cond.notify()

    def client_tls(self):
        """The TLS context of the engine's client legs (the /kv pull here,
        the server's /ec pulls): skip-verify for pod-local certificates by
        default, or a CA bundle, which takes precedence. Built once (the
        config does not change)."""
        if self._client_ssl is None:
            self._client_ssl = client_verify(self.cfg.client_insecure_skip_verify,
                                             self.cfg.client_ca_cert_path or None)
        return self._client_ssl

    def _pull_full(self, pi: _PendingImport, c: kv_wire.KvClient, path: str,
                   t0: float) -> None:
        status, headers, body = c.get(path)
        if status != 200:
            raise ValueError(f"GET {path} answered {status}")
        shape = tuple(int(d) for d in json.loads(headers["x-kv-shape"]))
        pi.kv = kv_wire.decode_kv(body, kv_wire.dtype_from_name(headers["x-kv-dtype"]),
                                  shape)
        pi.headers = headers
        self._note_kv_import(pi.req.request_id, t0, len(body), "host")

    def _pull_host_chunks(self, pi: _PendingImport, c: kv_wire.KvClient,
                          path: str, t0: float) -> None:
        """Pipelined pull: long-poll ``?chunk=N`` so chunk k moves while the
        exporter computes chunk k+1, then join the chunks along the block axis
        (per layer) and synthesise the geometry headers of a full GET. An exporter that staged no chunks
        completes with zero: fall back to the full GET."""
        ks: list[torch.Tensor] = []
        vs: list[torch.Tensor] = []
        chunk = nbytes = 0
        complete_at: float | None = None
        dtype = None
        meta: dict[str, str] = {}
        deadline = t0 + self.KV_CHUNK_STREAM_TIMEOUT_S
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError("kv chunk stream stalled")
            status, hdrs, body = c.get(path, chunk=chunk, wait_ms=2000)
            if status == 202:  # chunk not staged yet: poll again
                continue
            if status == 204:  # complete, no further chunk
                meta = hdrs
                complete_at = complete_at or time.monotonic()
                break
            if hdrs.get("x-kv-complete") == "1" and complete_at is None:
                complete_at = time.monotonic()
            if hdrs.get("x-kv-chunk-shape"):
                # Each chunk is [L, chunk_blocks, ...] K then V: joined along
                # the block axis below, per layer.
                dtype = hdrs["x-kv-dtype"]
                k, v = kv_wire.decode_kv(
                    body, kv_wire.dtype_from_name(dtype),
                    tuple(int(d) for d in json.loads(hdrs["x-kv-chunk-shape"])))
                ks.append(k)
                vs.append(v)
                nbytes += len(body)
            chunk += 1
            if (hdrs.get("x-kv-complete") == "1"
                    and chunk >= int(hdrs.get("x-kv-chunks-staged") or 0)):
                meta = hdrs
                break
        if not ks:
            self._pull_full(pi, c, path, t0)
            return
        pi.kv = (torch.cat(ks, 1), torch.cat(vs, 1))
        pi.headers = {
            "x-kv-shape": json.dumps(list(pi.kv[0].shape)),
            "x-kv-seq-len": meta["x-kv-seq-len"],
            "x-kv-dtype": str(dtype),
            "x-kv-real-blocks": str(pi.kv[0].shape[1]),
            "x-kv-first-token": meta.get("x-kv-first-token", ""),
        }
        exposed_ms = (time.monotonic() - max(complete_at or t0, t0)) * 1e3
        self._note_kv_import(pi.req.request_id, t0, nbytes, "host-chunked",
                             exposed_ms=exposed_ms)

    def _process_imports(self):
        while True:
            free = [i for i, s in enumerate(self.slots) if s is None]
            with self._cond:
                if not self._import_ready or not free:
                    return
                pi = self._import_ready[0]
                blocks: list[int] = []
                evicted: list[int] = []
                if pi.error is None:
                    need = self._blocks_needed(pi.req)
                    available = getattr(self.allocator, "reusable_blocks",
                                        self.allocator.free_blocks)
                    if need > available:
                        return  # wait for capacity
                    blocks = self.allocator.alloc(need)
                    evicted = list(getattr(self.allocator,
                                           "last_evicted_hashes", []))
                    self.telemetry.observe_allocator(self.allocator)
                self._import_ready.pop(0)
            self._publish("removed", evicted)
            if pi.error is None:
                try:
                    self._import_into_slot(free[0], pi, blocks)
                    continue
                except Exception as e:
                    # Malformed payload or geometry mismatch: reclaim the
                    # allocation and prefill locally.
                    self._free_blocks(blocks)
                    pi.error = f"import rejected: {e}"
            log.warning("kv import for %s failed (%s); local prefill fallback",
                        pi.req.request_id, pi.error)
            with self._cond:
                self._waiting.insert(0, (self._strip_remote(pi.req), pi.out, pi.loop))
                self.telemetry.waiting.set(len(self._waiting))

    @staticmethod
    def _strip_remote(req: EngineRequest) -> EngineRequest:
        return dataclasses.replace(req, kv_transfer_params=None)

    def _validate_kv_geometry(self, shape, seq_len: int, real_nb: int,
                              n_alloc: int):
        """``shape``'s block dim may be pow2-padded; ``real_nb`` is the real
        count, which must fit the local allocation."""
        if len(shape) != 5:
            raise ValueError(f"bad kv shape {shape}")
        L, nb, block, Hkv, Dh = shape
        if (L, block, Hkv, Dh) != (self.mcfg.n_layers, self.mcfg.kv_block_size,
                                   self.mcfg.n_kv_heads, self.mcfg.head_dim):
            raise ValueError(f"kv geometry mismatch: {shape} vs model "
                             f"(L={self.mcfg.n_layers}, block={self.mcfg.kv_block_size}, "
                             f"Hkv={self.mcfg.n_kv_heads}, Dh={self.mcfg.head_dim})")
        if not (0 < real_nb <= nb):
            raise ValueError(f"real block count {real_nb} outside padded {nb}")
        if nb > self.max_blocks_per_seq or real_nb > n_alloc:
            raise ValueError(f"{real_nb}/{nb} exported blocks exceed budget "
                             f"(maxB={self.max_blocks_per_seq}, alloc={n_alloc})")
        if not (0 < seq_len <= real_nb * block):
            raise ValueError(f"kv seq_len {seq_len} outside exported blocks")
        return L, nb, block, Hkv, Dh

    def _import_into_slot(self, idx: int, pi: _PendingImport, blocks: list[int]):
        """Validate the pulled KV, copy its real blocks into ``blocks`` (host
        to device, then an in-place index_put_ on the pages) and emit the
        exporter's first token; raises on any malformed or mismatched import
        (the caller falls back to local prefill)."""
        req, headers = pi.req, pi.headers or {}
        ktp = req.kv_transfer_params or {}
        if pi.dist_pull or pi.shards is not None:
            shape = tuple(int(d) for d in ktp["kv_shape"])
            seq_len = int(ktp["remote_seq_len"])
            real_nb = int(ktp.get("remote_num_blocks") or shape[1])
        else:
            shape = tuple(pi.kv[0].shape)
            seq_len = int(headers["x-kv-seq-len"])
            real_nb = int(headers.get("x-kv-real-blocks") or shape[1])
        self._validate_kv_geometry(shape, seq_len, real_nb, len(blocks))
        first = int(ktp["remote_first_token"]
                    if ktp.get("remote_first_token") is not None
                    else headers["x-kv-first-token"])
        ids = np.asarray(blocks[:real_nb], np.int32)
        if pi.dist_pull:
            # Every process pulls its own shards from its counterpart.
            wire, addrs = self._wire_route(ktp)
            t0 = time.monotonic()
            self._device_call(("pull_kv_import",), dict(
                blocks=ids, addresses=addrs, wire=wire,
                tuid=int(ktp["transfer_uuid"]), shape=list(shape)))
            self._note_kv_import(req.request_id, t0, _kv_param_bytes(ktp),
                                 "device" if wire == "device" else "shard-wire")
            self._release_remote_export(ktp)
        elif pi.shards is not None:
            # The pull's time: its open on the fetch thread, then the copy.
            t0 = time.monotonic() - pi.open_s
            try:
                self._copy_shards(pi.shards, ids, shape)
            finally:
                pi.shards, done, pi.done = None, pi.done, None
                done()
            self._note_kv_import(req.request_id, t0, _kv_param_bytes(ktp), "device")
            self._release_remote_export(ktp)
        else:
            k, v = pi.kv
            pi.kv = None
            self._device_call(("import",), dict(
                blocks=ids, k=np.asarray(kv_wire.tensor_bytes(k[:, :real_nb])),
                v=np.asarray(kv_wire.tensor_bytes(v[:, :real_nb])),
                dtype=kv_wire.dtype_name(k.dtype), shape=[shape[0], real_nb, *shape[2:]]))

        slot = _Slot(req=req, out=pi.out, loop=pi.loop, blocks=blocks,
                     position=seq_len, generated=[first], last_token=first,
                     cached_tokens=seq_len, prompt_len=seq_len)
        block = self.mcfg.kv_block_size
        hashes = chain_block_hashes(self.model_name,
                                    req.prompt_token_ids[:seq_len], "", block)
        n_complete = seq_len // block
        slot.block_hashes = hashes[:n_complete]
        if isinstance(self.allocator, PrefixCachingAllocator):
            with self._cond:
                self.allocator.commit_hashes(blocks[:n_complete],
                                             hashes[:n_complete])
        # The imported blocks become visible to the router (a P/D decode
        # engine's cache).
        self._publish("stored", slot.block_hashes)
        self.slots[idx] = slot
        self.telemetry.running.set(sum(s is not None for s in self.slots))
        self.telemetry.ttft.observe(time.monotonic() - req.arrival_time)
        self._emit(slot, TokenEvent(
            request_id=req.request_id, token_id=first,
            text=self.tokenizer.decode([first]), is_first=True,
            prompt_tokens=seq_len, completion_tokens=1, cached_tokens=seq_len))
        slot.first_emitted = True
        self._maybe_finish_after_token(idx, first)

    # ---- decode --------------------------------------------------------

    def _sample_np(self, reqs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (np.array([r.temperature for r in reqs], np.float32),
                np.array([r.top_k for r in reqs], np.int32),
                np.array([r.top_p for r in reqs], np.float32))

    def _batch_bucket(self, n: int) -> int:
        """Smallest power-of-two lane count covering n active slots."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.cfg.max_batch)

    def _sample_args(self, reqs) -> dict[str, np.ndarray]:
        """Host-side sampling knobs of a batch, as op arguments (the
        generator's state is never shipped: every sampling process advances
        its own, seeded alike, by the same ops)."""
        return dict(zip(("temps", "top_k", "top_p"), self._sample_np(reqs)))

    def _decode_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                      tables: np.ndarray, reqs) -> np.ndarray:
        """``decode_chunk`` decode+sample steps on the device (the ``decode``
        op)."""
        return self._device_call(("decode",), dict(
            tokens=tokens, positions=positions, tables=tables,
            **self._sample_args(reqs)))

    def _op_decode(self, tokens, positions, tables, temps, top_k, top_p):
        """``decode_chunk`` decode+sample steps, each step's sampled tokens
        feeding the next; ONE readback of the [K, B] tokens (None on a
        process without stage 0). A pp engine takes the lane-group
        interleave when B divides by pp, else the broadcast ring
        (``llama.decode_step`` through the stages)."""
        K, B, P = self.cfg.decode_chunk, len(tokens), self.cfg.pp_size
        sample_np = (temps, top_k, top_p)
        tok = self._to_dev(tokens)
        pos = self._to_dev(positions)
        tab = self._to_dev(tables)
        if pp_serve.use_interleave(B, P):
            Bg = B // P
            knobs = [SamplingKnobs.from_numpy(*(a[g * Bg:(g + 1) * Bg] for a in sample_np),
                                              self.device) for g in range(P)]
            out = pp_serve.interleaved_chunk(
                self.params, self.mcfg, tok, pos, self.k_pages, self.v_pages, tab, K,
                lambda logits, g: sample_tokens(logits, self._sample_gen, knobs[g]))
            schedule = "interleave"
        else:
            knobs = SamplingKnobs.from_numpy(*sample_np, self.device)
            out = torch.empty((K, B), dtype=torch.int32, device=self.device)
            for k in range(K):
                logits, _, _ = llama.decode_step(self.params, self.mcfg, tok, pos,
                                                 self.k_pages, self.v_pages, tab)
                if logits is not None:
                    tok = sample_tokens(logits, self._sample_gen, knobs)
                    out[k] = tok
                pos = pos + 1
            schedule = "ring"
        self.decode_steps += K
        self.decode_steps_by_schedule[schedule] += K
        return None if out is None or not self._holds_head() else out.cpu().numpy()

    def _decode_once(self):
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.pending_tok is None and not s.prefilling]
        B = self._batch_bucket(len(active))
        W = self.max_blocks_per_seq
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.zeros((B, W), np.int32)
        # Compact active slots into the low lanes; padding lanes keep their
        # block table at the trash block 0 (their KV writes land there).
        for lane, i in enumerate(active):
            s = self.slots[i]
            tokens[lane] = s.last_token
            positions[lane] = s.position
            tables[lane, : len(s.blocks)] = s.blocks
        reqs = [self.slots[i].req for i in active]
        reqs += [_DUMMY_REQ] * (B - len(reqs))
        self.telemetry.batch_fill.set(len(active) / max(self.cfg.max_batch, 1))
        t0 = time.monotonic()
        sampled = self._decode_chunk(tokens, positions, tables, reqs)
        self.telemetry.decode_step.observe(time.monotonic() - t0)

        for lane, i in enumerate(active):
            for step in range(sampled.shape[0]):
                if self.slots[i] is None:
                    break  # stop/length hit mid-chunk; overshoot discarded
                s = self.slots[i]
                tok = int(sampled[step, lane])
                s.position += 1
                s.generated.append(tok)
                s.last_token = tok
                self.telemetry.generation_tokens.inc()
                if tok not in self._stop_ids(s.req):
                    self._emit(s, TokenEvent(
                        request_id=s.req.request_id, token_id=tok,
                        text=self.tokenizer.decode([tok]),
                        is_first=not s.first_emitted,
                        completion_tokens=len(s.generated)))
                    s.first_emitted = True
                self._maybe_finish_after_token(i, tok)

    def _stop_ids(self, req: EngineRequest) -> set[int]:
        stop_ids = set(req.stop_token_ids)
        if not req.ignore_eos:
            stop_ids.add(self.tokenizer.eos_id)
        return stop_ids

    def _maybe_finish_after_token(self, idx: int, tok: int):
        s = self.slots[idx]
        reason = None
        if tok in self._stop_ids(s.req):
            reason = FinishReason.STOP
        elif len(s.generated) >= s.req.max_tokens:
            reason = FinishReason.LENGTH
        elif s.position + 1 >= self.cfg.max_model_len:
            reason = FinishReason.LENGTH
        if reason is not None:
            self._finish_slot(idx, reason)

    def _finish_slot(self, idx: int, reason: FinishReason, *,
                     retain_for_transfer: bool = False,
                     first_token: int | None = None):
        s = self.slots[idx]
        self.slots[idx] = None
        kv_params = None
        if retain_for_transfer:
            kv_params = self._export(s, first_token)
        else:
            # Abort of a chunk-streaming prefill: reclaim its partial export.
            self._drop_partial_export(s.req.request_id)
        with self._cond:
            self.allocator.free(s.blocks)
            self.telemetry.observe_allocator(self.allocator)
            self._cond.notify()  # capacity freed: wake admission
        if not isinstance(self.allocator, PrefixCachingAllocator):
            # With prefix caching the blocks park instead: 'removed' goes
            # out when the LRU evicts them (the alloc paths).
            self._publish("removed", s.block_hashes)
        self.telemetry.running.set(sum(x is not None for x in self.slots))
        self.telemetry.request_success.labels(finished_reason=reason.value).inc()
        ev = TokenEvent(
            request_id=s.req.request_id, token_id=None, finish_reason=reason,
            kv_transfer_params=kv_params,
            prompt_tokens=len(s.req.prompt_token_ids),
            completion_tokens=len(s.generated))
        if retain_for_transfer and first_token is not None:
            ev.token_id = first_token
            ev.text = self.tokenizer.decode([first_token])
        self._emit(s, ev)

    def _export(self, s: _Slot, first_token: int) -> dict[str, Any]:
        """Stage a finished remote-decode prefill for pickup and return the
        ``kv_transfer_params`` that name it. The block count pads to a power
        of two, the tail on the trash block 0, as the JAX exporter does."""
        bucket = 1
        while bucket < len(s.blocks):
            bucket *= 2
        bucket = min(bucket, self.max_blocks_per_seq)
        padded = np.asarray(list(s.blocks) + [0] * (bucket - len(s.blocks)), np.int32)
        rid = s.req.request_id
        tuid = uuid.uuid4().int & ((1 << 63) - 1)
        # In a group every process gathers and registers its own shards.
        rec = self._device_call(("stage_kv",), dict(
            request_id=rid, idx=padded, tuid=tuid,
            stream=bool((s.req.kv_transfer_params or {}).get("stream_chunks")),
            meta={"num_blocks": len(s.blocks),  # real (un-padded) count
                  "seq_len": s.position,        # prompt tokens in cache
                  "first_token": first_token}))
        if "chunks_staged" in rec:
            # After the metadata: a puller that sees complete=1 always finds
            # seq_len and first_token.
            self._finalize_chunk_export(rec, len(s.blocks))
        kv = {
            "remote_engine_id": self.engine_id,
            "remote_request_id": rid,
            "remote_num_blocks": len(s.blocks),
            "remote_seq_len": s.position,
            "remote_first_token": first_token,
            "remote_host": self.cfg.host,
            "remote_port": self.advertised_port,
            # A TLS exporter's /kv is https: the importer dials that scheme.
            "remote_scheme": "https" if self.cfg.secure_serving else "http",
        }
        if rec.get("tuid") is not None:
            m = self.mcfg
            kv |= {"transfer_uuid": tuid,
                   "kv_shape": [m.n_layers, len(padded), m.kv_block_size,
                                m.n_kv_heads, m.head_dim],
                   "kv_dtype": kv_wire.dtype_name(self.dtype),
                   "kv_mesh": self._mesh_descriptor()}
            for wire, key, srv in (("device", "device_wire_address", self.kv_device_wire),
                                   ("host", "shard_wire_address", self.kv_shard_wire)):
                if srv is not None:
                    kv[f"kv_wire_{wire}"] = self._wire_addresses(key, srv)
        return kv

    def _wire_addresses(self, key: str, srv) -> list[str]:
        """A wire's address in each process of the group, in process order
        (one for a single process; "" where a follower named none)."""
        addrs = [srv.address()]
        if self._instr_channel is not None:
            for pid in range(1, self.cfg.dist_num_processes):
                addrs.append((self._instr_channel.hellos.get(pid) or {}).get(key) or "")
        return addrs

    def _release_remote_export(self, ktp: dict[str, Any]) -> None:
        """Best effort: tell the exporter its staged export was consumed
        over the device wire, so it drops it (its TTL sweep otherwise)."""
        path = ("/kv/" + urllib.parse.quote(str(ktp["remote_request_id"]), safe="")
                + "?consumed=device")
        scheme = ktp.get("remote_scheme") or "http"
        try:
            with kv_wire.KvClient(ktp["remote_host"], ktp["remote_port"], timeout=5.0,
                                  context=self.client_tls() if scheme == "https"
                                  else None) as c:
                c.delete(path)
        except Exception:
            pass

    # ---- device ops (replayed by a group's followers) -------------------
    # Every device call of the engine loop goes through _device_call, so a
    # follower (engine/multihost.py) replays the same sequence. Op arguments
    # are numpy arrays, ints and strings, never tensors.

    def _device_call(self, op: tuple, args: dict):
        if self._instr_channel is not None and self._instr_channel.leader:
            self._instr_channel.broadcast(op, args)
        return self._exec_op(op, args)

    def _exec_op(self, op: tuple, args: dict):
        kind = op[0]
        if kind == "decode":
            return self._op_decode(**args)
        if kind == "prefill":
            return self._op_prefill(**args)
        if kind == "import":
            return self._op_import(**args)
        if kind == "stage_kv":
            return self._op_stage_kv(**args)
        if kind == "release_kv_export":
            return self._release_export_local(args["request_id"])
        if kind == "pull_kv_import":
            return self._op_pull_kv_import(**args)
        if kind == "embed":
            return self._op_embed(**args)
        if kind == "launches":
            return self._op_launches(**args)
        if kind == "logits":
            return self._op_logits(**args)
        if kind == "kernel_check":
            return self._op_kernel_check(**args)
        if kind == "page_digest":
            return self._op_page_digest(**args)
        raise ValueError(f"unknown device op {op!r}")

    def _holds_head(self) -> bool:
        """This process holds stage 0: the embedding, the head and the
        sampler (every process without pp)."""
        return self.comm is None or self.layout.pp == 1 or self.comm.rank == 0

    def _sample(self, logits: torch.Tensor | None, temps, top_k, top_p):
        if logits is None:
            return None
        knobs = SamplingKnobs.from_numpy(temps, top_k, top_p, self.device)
        return sample_tokens(logits, self._sample_gen, knobs)

    def _op_prefill(self, tokens, new_len, rows, temps, top_k, top_p, prior_len=None,
                    prior=None, mm_embeds=None, mm_positions=None):
        to_dev = self._to_dev
        mm = {} if mm_embeds is None else dict(mm_embeds=to_dev(mm_embeds),
                                               mm_positions=to_dev(mm_positions))
        logits, _, _ = llama.prefill(
            self.params, self.mcfg, to_dev(tokens), to_dev(new_len), self.k_pages, self.v_pages,
            to_dev(rows), None if prior_len is None else to_dev(prior_len),
            None if prior is None else to_dev(prior), **mm)
        return self._sample(logits, temps, top_k, top_p)

    def _op_embed(self, ids):
        hidden, _ = llama.forward(self.params, self.mcfg,
                                  self._to_dev(np.asarray([ids], np.int32)),
                                  want_hidden=True, attention_fn=prefill_attention.causal)
        return None if hidden is None else hidden[0].mean(dim=0).cpu().numpy()

    def _op_import(self, blocks, k, v, dtype, shape):
        """Host-pulled KV (K and V bytes of ``shape``, the single-device
        layout) into ``blocks``, split into this engine's page shards."""
        dt = kv_wire.dtype_from_name(dtype)
        kt = torch.from_numpy(k).view(dt).reshape(shape)
        vt = torch.from_numpy(v).view(dt).reshape(shape)
        tp, pp = self.cfg.tp_size, self.cfg.pp_size
        for (kp, vp), ks, vs in zip(self._page_pairs(), par.split_pages(kt, tp, pp),
                                    par.split_pages(vt, tp, pp)):
            ids = torch.from_numpy(np.ascontiguousarray(blocks)).long().to(kp.device)
            kp[:, ids] = ks.to(kp.device, self.dtype)
            vp[:, ids] = vs.to(vp.device, self.dtype)

    def _copy_shards(self, shards: list[torch.Tensor], blocks: np.ndarray,
                     shape: tuple[int, ...]) -> None:
        """An export's page shards (this process's, canonical order: every K
        shard, then every V shard) into ``blocks`` of the pages, and wait
        for the copies (the shards may be another process's memory)."""
        pairs = self._page_pairs()
        if len(shards) != 2 * len(pairs):
            raise ValueError(f"{len(shards)} shards for {len(pairs)} page shards")
        L, nb, block, Hkv, Dh = shape
        lay = self.layout
        want = (L // (lay.pp if lay else 1), nb, block, Hkv // (lay.tp if lay else 1), Dh)
        for t in shards:
            if tuple(t.shape) != want:
                raise ValueError(f"shard shape {tuple(t.shape)} != {want}")
        n = len(blocks)
        for (kp, vp), ks, vs in zip(pairs, shards[:len(pairs)], shards[len(pairs):]):
            ids = torch.from_numpy(np.ascontiguousarray(blocks)).long().to(kp.device)
            kp[:, ids] = ks[:, :n].to(kp.device, self.dtype)
            vp[:, ids] = vs[:, :n].to(vp.device, self.dtype)
        for dev in {kp.device for kp, _ in pairs} | {t.device for t in shards}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _op_pull_kv_import(self, blocks, addresses, wire, tuid, shape):
        """Coordinated pull (every process of an importer group): this
        process's shards from its counterpart in the exporter group, over
        the host shard wire or the device wire, into ``blocks``. A failure
        raises: in a group that is a restart fault (the other processes are
        inside the op already)."""
        addr = addresses[self.comm.rank if self.comm is not None else 0]
        if wire == "host":
            shards, done = shard_wire.pull_shards(addr, tuid), (lambda: None)
        else:
            shards, done = kv_transfer.pull(addr, tuid)
        try:
            self._copy_shards(shards, blocks, tuple(shape))
        finally:
            done()
        if self.comm is not None:
            # Every process has copied its shards before the leader releases
            # the export (which drops them on every exporter process).
            self.comm.barrier(self.device)

    def _op_logits(self, ids):
        logits, _ = llama.forward(self.params, self.mcfg,
                                  self._to_dev(np.asarray([ids], np.int32)),
                                  attention_fn=prefill_attention.causal)
        return None if logits is None else logits[0, -1].float().cpu().numpy()

    def _op_kernel_check(self, atol, rtol, moe_rel, seed):
        from ..ops import attention, moe

        gen = torch.Generator(device=self.device).manual_seed(seed)
        block = self.mcfg.kv_block_size
        group = self.mcfg.n_heads // self.mcfg.n_kv_heads
        results: dict[str, tuple[float, bool]] = {}

        def note(name, out, ref, ok):
            err = float((out.float() - ref.float()).abs().max())
            prev = results.get(name, (0.0, True))
            results[name] = (max(prev[0], err), prev[1] and ok
                             and bool(torch.isfinite(out.float()).all()))

        B, W = 4, -(-self.cfg.max_model_len // block)
        for kp, _ in self._page_pairs():
            Hkv, D = kp.shape[3], kp.shape[4]

            def r(*shape):
                return torch.randn(*shape, generator=gen, device=self.device).to(
                    kp.device, kp.dtype)

            tables = (1 + torch.randperm(B * W, generator=gen, device=self.device)).to(
                kp.device, torch.int32).reshape(B, W)
            lens = torch.cat([torch.tensor([W * block], device=self.device),
                              torch.randint(1, W * block, (B - 1,), generator=gen,
                                            device=self.device)]).to(kp.device, torch.int32)
            args = (r(B, Hkv * group, D), r(B * W + 1, block, Hkv, D),
                    r(B * W + 1, block, Hkv, D), tables, lens, r(B, Hkv, D), r(B, Hkv, D))
            out = paged_attention.paged_decode_attention_cuda(*args)
            ref = attention.paged_decode_attention(*args[:5], cur_k=args[5], cur_v=args[6])
            note(paged_attention.KERNEL, out, ref,
                 bool(((out.float() - ref.float()).abs()
                       <= atol + rtol * ref.float().abs()).all()))
        if self.mcfg.moe_impl == "grouped":
            shard = (self.params if self.layout is None
                     else self.params.shards[next(r for r, _, _ in self.layout.ranks())])
            lp = {k: v[0] for k, v in shard["layers"].items()}
            x = torch.randn(8, self.mcfg.d_model, generator=gen,
                            device=self.device).to(lp["w1"].dtype)
            g = moe.group_rows(lp, x, self.mcfg.n_experts, self.mcfg.experts_per_token)
            kargs = (g.x_pad, g.tile_expert, lp["w1"], lp["w3"], lp["w2"], g.tm)
            out = grouped_moe.grouped_ffn_cuda(*kargs, g.rows_used)
            ref = moe.grouped_ffn_reference(*kargs).float()
            rms = float(ref[ref.abs().amax(-1) > 0].pow(2).mean().sqrt())
            note(grouped_moe.KERNEL, out, ref,
                 bool(((out.float() - ref).abs() <= moe_rel * (ref.abs() + rms)).all()))
        if self.comm is None:
            return [results]
        names = sorted(results)
        mine = torch.tensor([[v for n in names for v in (results[n][0], float(results[n][1]))]],
                            dtype=torch.float64, device=self.device)
        every = self.comm.all_gather_last(mine).reshape(self.comm.size, -1).cpu()
        return [{n: (float(row[2 * i]), bool(row[2 * i + 1])) for i, n in enumerate(names)}
                for row in every]

    def _op_page_digest(self, blocks, n_tokens):
        pairs = self._page_pairs()
        ids = torch.from_numpy(np.ascontiguousarray(blocks)).long()
        mine = [kv_shards.shard_digest(p[:, ids.to(p.device)], n_tokens)
                for p in [k for k, _ in pairs] + [v for _, v in pairs]]
        if self.comm is None:
            return [mine]
        raw = torch.tensor([list(bytes.fromhex("".join(mine)))], dtype=torch.uint8,
                           device=self.device)
        every = self.comm.all_gather_last(raw).reshape(self.comm.size, -1).cpu()
        return [[bytes(row[i:i + 32].tolist()).hex() for i in range(0, row.numel(), 32)]
                for row in every]

    def _op_launches(self, reset: bool):
        """Every process's kernel launch counts, gathered over the group."""
        from .. import ops

        counts = ops.kernel_launches()
        if reset:
            ops.reset_kernel_launches()
        if self.comm is None:
            return [counts]
        names = sorted(counts)
        mine = torch.tensor([[counts[n] for n in names]], dtype=torch.int64,
                            device=self.device)
        every = self.comm.all_gather_last(mine).reshape(-1, len(names)).cpu()
        return [dict(zip(names, (int(x) for x in row))) for row in every]


def _embed(params) -> torch.Tensor:
    """A weight of this process's first rank (the embedding table where it
    holds one): the params' device and dtype."""
    if isinstance(params, par.ShardedParams):
        shard = params.shards[next(r for r, _, _ in params.layout.ranks())]
        return shard.get("embed", next(iter(shard["layers"].values())))
    return params["embed"]


def _tcp_preflight(address: str, timeout: float = 2.0) -> None:
    """Fail fast on an unreachable wire, so that the fallback engages (and a
    group's leader never broadcasts a pull that would wedge its followers)."""
    import socket

    host, _, port = address.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=timeout):
        pass


def _kv_param_bytes(ktp: dict[str, Any]) -> int:
    """K+V bytes of a wire export, from its advertised geometry."""
    n = 1
    for d in ktp.get("kv_shape") or []:
        n *= int(d)
    dtype = kv_wire.dtype_from_name(str(ktp.get("kv_dtype") or "bfloat16"))
    return 2 * n * torch.empty((), dtype=dtype).element_size()


_DUMMY_REQ = EngineRequest(request_id="__pad__", prompt_token_ids=[0])
