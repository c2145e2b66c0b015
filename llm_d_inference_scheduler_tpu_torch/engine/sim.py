"""SimEngine: the CPU simulator (port of
``llm_d_inference_scheduler_tpu/engine/sim.py``).

A pod that looks like a real engine to the router (the OpenAI surface, the
``jetstream:*`` telemetry, the P/D handshake, the KV events and the prefix
hit accounting) with scripted latencies in place of a model, so the routing
stack runs without an accelerator; the chart's encode worker runs one
(``--backend=sim --platform=cpu``). It runs nothing on any device and
launches no kernel: tokens are lorem text, a prefill sleeps
``sim_prefill_ms_per_token`` per token the served-block LRU does not hold,
a decode step ``sim_decode_ms_per_token``, and a P/D import prices the pull
at ``sim_kv_pull_ms_per_block`` (or the prefill peer's own rate) instead of
moving bytes. ``/v1/encode`` runs the port's vision tower on the CPU, as
the JAX server runs its tower for a sim on the CPU platform.

The port's own telemetry, tokenizer, hashing and request modules serve it;
the chunk-streamed pull long-polls the peer's ``/kv`` with the port's
``kv_wire.KvClient`` (the JAX sim uses ``httpx``, which the port does not
need).
"""

from __future__ import annotations

import asyncio
import threading
import time
import uuid
import zlib
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from ..models import vision
from ..utils.hashing import chain_block_hashes
from ..utils.tls import client_verify
from . import kv_wire
from .config import EngineConfig
from .request import EngineRequest, FinishReason, TokenEvent
from .telemetry import EngineTelemetry, PrefixHitLog
from .tokenizer import get_tokenizer

_LOREM = "lorem ipsum dolor sit amet "
# An unclaimed export expires after this long (the real engine's
# KV_EXPORT_TTL_S): a decode peer can never pull real KV from a sim.
KV_EXPORT_TTL_S = 60.0
_STATS_CAP = 512


class _HubOnlyKvEvents:
    """SSE-only KV events: the duck type of ``kv_events.KvEventPublisher``
    (the server attaches ``hub``; ``/kv_events`` streams it) without the
    ZMQ leg, so a fleet of sims claims no port at serving port + 1000."""

    def __init__(self, engine_id: str):
        self.engine_id = engine_id
        self.hub = None  # attached by the engine server at start

    def publish(self, event: str, hashes: list[int]) -> None:
        if hashes and self.hub is not None:
            self.hub.push({"event": event, "engine_id": self.engine_id,
                           "hashes": hashes})

    def stored(self, hashes: list[int]) -> None:
        self.publish("stored", hashes)

    def removed(self, hashes: list[int]) -> None:
        self.publish("removed", hashes)

    def close(self) -> None:
        self.hub = None


def _cap(d: OrderedDict, key: str, value: Any) -> None:
    d[key] = value
    while len(d) > _STATS_CAP:
        d.popitem(last=False)


class SimEngine:
    """The simulator behind ``EngineServer`` (``backend="sim"``)."""

    warming = False
    failure = None

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.mcfg = cfg.model_config
        self.engine_id = cfg.engine_id or f"sim-{uuid.uuid4().hex[:8]}"
        self.tokenizer = get_tokenizer(cfg.tokenizer, self.mcfg.vocab_size)
        self.model_name = cfg.model_name
        block = self.mcfg.kv_block_size
        self.n_blocks = cfg.num_kv_blocks()
        self.telemetry = EngineTelemetry(block_size=block, num_blocks=self.n_blocks)
        self.advertised_port = cfg.port  # the server sets the bound port
        self._sem = asyncio.Semaphore(cfg.max_batch)
        self._waiting = 0
        self._running = 0
        self._blocks_used = 0
        self.kv_exports: dict[str, dict[str, Any]] = {}
        self._tasks: dict[str, asyncio.Task] = {}
        self._gen_tokens = self.tokenizer.encode(_LOREM, add_bos=False)
        # A capacity-bounded LRU of served block hashes stands in for the
        # prefix-caching allocator and feeds the same PrefixHitLog surfaces
        # (x-kv-hit-*, /debug/kv, the prefill/hit token counters).
        self._prefix_lru: OrderedDict[int, None] = OrderedDict()
        self.kv_hits = PrefixHitLog(self.telemetry, block)
        self.kv_events = (_HubOnlyKvEvents(self.engine_id)
                          if cfg.resolved_kv_events_port() else None)
        self._last_kv_snapshot = 0.0
        # The priced imports (x-kv-pull-*) and admission waits
        # (x-engine-queue-ms), popped by the server; bounded.
        self.kv_import_stats: OrderedDict[str, dict[str, Any]] = OrderedDict()
        self.queue_waits: OrderedDict[str, float] = OrderedDict()
        self._client_ssl = None
        self._tower: tuple[vision.VisionConfig, dict] | None = None
        self._tower_lock = threading.Lock()

    async def start(self):
        pass

    async def stop(self):
        pass

    # ---- what the server asks of an engine besides generation -----------

    def embed(self, ids: list[int]) -> np.ndarray:
        """A deterministic unit vector from the token ids (64 wide)."""
        seed = zlib.crc32(np.asarray(ids, np.int64).tobytes())
        v = np.random.default_rng(seed).normal(size=64).astype(np.float32)
        return v / max(float(np.linalg.norm(v)), 1e-6)

    def vision(self) -> tuple[vision.VisionConfig, dict]:
        """The E/P/D tower on the CPU, from the configured seed."""
        with self._tower_lock:
            if self._tower is None:
                self._tower = vision.build_tower(self.mcfg.d_model, self.cfg.seed,
                                                 torch.device("cpu"))
            return self._tower

    def encode_images(self, pixels: np.ndarray) -> np.ndarray:
        return vision.encode_to_host(*self.vision(), pixels, torch.device("cpu"))

    def client_tls(self):
        """The client legs' TLS context (the server's ``/ec`` pulls from
        https sources), as ``TorchEngine.client_tls``."""
        if self._client_ssl is None:
            self._client_ssl = client_verify(self.cfg.client_insecure_skip_verify,
                                             self.cfg.client_ca_cert_path or None)
        return self._client_ssl

    def get_kv_export(self, request_id: str) -> dict[str, Any] | None:
        return self.kv_exports.get(request_id)

    def release_kv_export(self, request_id: str, *, consumed: str = "host") -> None:
        rec = self.kv_exports.pop(request_id, None)
        if rec:
            self._blocks_used -= rec["n_blocks"]
            self._update_gauges()

    def submit(self, req: EngineRequest) -> asyncio.Queue:
        out: asyncio.Queue = asyncio.Queue()
        task = asyncio.get_running_loop().create_task(self._serve(req, out))
        self._tasks[req.request_id] = task
        task.add_done_callback(lambda _: self._tasks.pop(req.request_id, None))
        return out

    def idle(self) -> bool:
        """Drain gate: no live per-request task."""
        return not self._tasks

    def abort(self, request_id: str) -> None:
        task = self._tasks.get(request_id)
        if task is not None:
            task.cancel()

    # ---- gauges, exports, the served-block LRU ---------------------------

    def _update_gauges(self):
        self._sweep_exports()
        self._maybe_kv_snapshot()
        self.telemetry.waiting.set(self._waiting)
        self.telemetry.running.set(self._running)
        usable = max(self.n_blocks - 1, 1)
        self.telemetry.kv_usage.set(min(self._blocks_used / usable, 1.0))
        self.telemetry.free_blocks.set(max(usable - self._blocks_used, 0))
        self.telemetry.batch_fill.set(
            min(self._running / max(self.cfg.max_batch, 1), 1.0))

    def _sweep_exports(self):
        """Unclaimed exports expire, or kv_usage would ratchet to 1.0."""
        now = time.monotonic()
        for rid in [r for r, rec in self.kv_exports.items()
                    if now - rec.get("created", now) > KV_EXPORT_TTL_S]:
            self.release_kv_export(rid)

    def _commit_lru(self, hashes: list[int]) -> None:
        """Commit block hashes into the LRU, publishing stored/removed events
        for the delta (the real allocator's publication points)."""
        stored = []
        for h in hashes:
            if h not in self._prefix_lru:
                stored.append(h)
            self._prefix_lru[h] = None
            self._prefix_lru.move_to_end(h)
        evicted = []
        while len(self._prefix_lru) > max(self.n_blocks, 1):
            evicted.append(self._prefix_lru.popitem(last=False)[0])
        if self.kv_events is not None:
            self.kv_events.stored(stored)
            self.kv_events.removed(evicted)

    def _maybe_kv_snapshot(self) -> None:
        """Re-publish the whole served-block set at most once a second, so a
        subscriber that missed events re-converges."""
        if self.kv_events is None:
            return
        now = time.monotonic()
        if now - self._last_kv_snapshot < 1.0:
            return
        self._last_kv_snapshot = now
        self.kv_events.stored(list(self._prefix_lru))

    def _hashes(self, req: EngineRequest) -> list[int]:
        return chain_block_hashes(self.model_name, req.prompt_token_ids, "",
                                  self.mcfg.kv_block_size)

    def _note_prefix_hit(self, req: EngineRequest) -> int:
        """Match the prompt's chain against the LRU (from the start, >= 1
        suffix token kept, the allocator's rule), commit its blocks and
        record the hit; returns the hit depth in tokens."""
        block = self.mcfg.kv_block_size
        prompt = req.prompt_token_ids
        hashes = self._hashes(req)
        max_match = (len(prompt) - 1) // block if prompt else 0
        match = 0
        for h in hashes[:max_match]:
            if h not in self._prefix_lru:
                break
            self._prefix_lru.move_to_end(h)
            match += 1
        self._commit_lru(hashes)
        hit_tokens = match * block
        self.kv_hits.note(req.request_id, hit_tokens, len(prompt))
        return hit_tokens

    # ---- P/D ---------------------------------------------------------------

    async def _stream_prefill_export(self, req: EngineRequest, n_blocks: int,
                                     prompt_len: int, prefill_s: float,
                                     first: int) -> None:
        """Chunk-streamed remote-decode prefill: the export record exists
        from the start (``complete=False``) and gains one chunk per
        simulated prefill window, the real engine's schedule priced on the
        CPU. The record owns the request's blocks, so a cancellation
        releases them once."""
        block = self.mcfg.kv_block_size
        win = self.cfg.prefill_chunk
        win = max(block, -(-win // block) * block) if win > 0 else 0
        rec: dict[str, Any] = {
            "n_blocks": n_blocks, "seq_len": prompt_len,
            "created": time.monotonic(), "first_token": first,
            "chunk_blocks": [], "chunks_staged": 0,
            "blocks_staged": 0, "complete": False}
        self.kv_exports[req.request_id] = rec
        try:
            rest = prompt_len
            while True:
                step = min(win, rest) if win else rest
                rest -= step
                await asyncio.sleep(prefill_s * step / max(prompt_len, 1))
                done = rest <= 0
                upto = n_blocks if done else min((prompt_len - rest) // block, n_blocks)
                cb = upto - rec["blocks_staged"]
                if cb > 0:
                    rec["chunk_blocks"].append(cb)
                    rec["blocks_staged"] = upto
                    rec["chunks_staged"] += 1
                if done:
                    rec["complete"] = True
                    return
        except asyncio.CancelledError:
            self.release_kv_export(req.request_id)
            raise

    def _pull_kv_chunks(self, ktp: dict[str, Any], rate: float,
                        block: int) -> dict[str, Any] | None:
        """Pipelined import (thread body): long-poll the prefill peer's
        ``/kv`` chunks, sleeping the per-block price of each, so the pull
        overlaps the peer's remaining prefill in wall time. Returns the
        import stats with the non-overlapped ``exposed_ms``, or None on any
        failure (the caller prefills locally)."""
        t0 = time.monotonic()
        path = f"/kv/{ktp['remote_request_id']}"
        chunk = pulled = 0
        complete_at: float | None = None
        deadline = t0 + 60.0
        try:
            with kv_wire.KvClient(ktp["remote_host"], ktp["remote_port"],
                                  timeout=10.0) as c:
                while True:
                    if time.monotonic() > deadline:
                        return None
                    status, hdrs, _ = c.get(path, chunk=chunk, wait_ms=1000)
                    if status == 202:  # not staged yet: poll again
                        continue
                    if status == 204:  # no further chunk
                        complete_at = complete_at or time.monotonic()
                        break
                    cb = int(hdrs.get("x-kv-chunk-blocks") or 0)
                    done = hdrs.get("x-kv-complete") == "1"
                    if done and complete_at is None:
                        complete_at = time.monotonic()
                    time.sleep(rate * cb / 1000)
                    pulled += cb
                    chunk += 1
                    if done and chunk >= int(hdrs.get("x-kv-chunks-staged") or 0):
                        break
                try:
                    c.delete(path)
                except Exception:
                    pass  # the exporter's TTL sweep reclaims it
        except Exception:
            return None
        t_end = time.monotonic()
        # Exposed: the pull's tail after the export completed (before that
        # the prefill engine was computing anyway).
        exposed_s = t_end - max(complete_at or t0, t0)
        return {"ms": (t_end - t0) * 1e3, "exposed_ms": exposed_s * 1e3,
                "bytes": pulled * block * 1024, "route": "sim-chunked"}

    # ---- one request -------------------------------------------------------

    async def _serve(self, req: EngineRequest, out: asyncio.Queue):
        self._waiting += 1
        self._update_gauges()
        t_queue = time.monotonic()
        try:
            await self._sem.acquire()
        except asyncio.CancelledError:  # aborted while queued
            self._waiting -= 1
            self._update_gauges()
            out.put_nowait(TokenEvent(
                request_id=req.request_id, token_id=None,
                finish_reason=FinishReason.ABORT,
                prompt_tokens=len(req.prompt_token_ids)))
            return
        # Admission wait = the batch-slot semaphore (the sim's only queue).
        _cap(self.queue_waits, req.request_id, (time.monotonic() - t_queue) * 1e3)
        try:
            self._waiting -= 1
            self._running += 1
            prompt_len = len(req.prompt_token_ids)
            block = self.mcfg.kv_block_size
            n_blocks = -(-max(prompt_len + req.max_tokens, 1) // block)
            self._blocks_used += n_blocks
            self._update_gauges()
            ktp = req.kv_transfer_params or {}
            # A P/D decode leg with a staged remote export imports: it pays
            # the priced pull, commits the blocks (the pod holds them
            # afterwards) and records no hit. Everything else prefills
            # locally, paying only for the tokens the LRU does not hold.
            imported = ((bool(ktp.get("remote_block_ids"))
                         or bool(ktp.get("stream_chunks")))
                        and not ktp.get("do_remote_decode"))
            chunked_pull = imported and bool(ktp.get("stream_chunks"))
            pull_s = 0.0
            if imported:
                self._commit_lru(self._hashes(req))
                rate = self.cfg.sim_kv_pull_ms_per_peer.get(
                    f"{ktp.get('remote_host')}:{ktp.get('remote_port')}",
                    self.cfg.sim_kv_pull_ms_per_block)
                if not chunked_pull:
                    n_pull = len(ktp["remote_block_ids"])
                    pull_s = rate * n_pull / 1000
                    _cap(self.kv_import_stats, req.request_id, {
                        "ms": pull_s * 1e3,
                        "bytes": n_pull * block * 1024,  # nominal 1 KiB a token
                        "route": "sim"})
            else:
                hit_tokens = self._note_prefix_hit(req)
            try:
                if chunked_pull:
                    stats = await asyncio.to_thread(self._pull_kv_chunks, ktp, rate, block)
                    if stats is not None:
                        _cap(self.kv_import_stats, req.request_id, stats)
                    else:
                        # The prefill peer died mid-stream: prefill locally.
                        await asyncio.sleep(self.cfg.sim_prefill_ms_per_token
                                            * prompt_len / 1000)
                elif imported:
                    await asyncio.sleep(pull_s)
                else:
                    prefill_s = (self.cfg.sim_prefill_ms_per_token
                                 * max(prompt_len - hit_tokens, 0) / 1000)
                    if ktp.get("do_remote_decode") and ktp.get("stream_chunks"):
                        n_export, n_blocks = n_blocks, 0  # the export owns them
                        await self._stream_prefill_export(
                            req, n_export, prompt_len, prefill_s, self._gen_tokens[0])
                    else:
                        await asyncio.sleep(prefill_s)
                    # Import legs record no prefill sample, as the real
                    # engine observes only prefill dispatches.
                    self.telemetry.prefill_step.observe(prefill_s)
                self.telemetry.prompt_tokens.inc(prompt_len)
                self.telemetry.ttft.observe(time.monotonic() - req.arrival_time)
                first = self._gen_tokens[0]
                if ktp.get("do_remote_decode"):
                    rec = self.kv_exports.get(req.request_id)
                    if rec is None:  # serial 2-phase: staged at completion
                        rec = {"n_blocks": n_blocks, "seq_len": prompt_len,
                               "created": time.monotonic()}
                        self.kv_exports[req.request_id] = rec
                        n_blocks = 0  # held by the export, not released below
                    out.put_nowait(TokenEvent(
                        request_id=req.request_id, token_id=first,
                        text=self.tokenizer.decode([first]),
                        finish_reason=FinishReason.LENGTH, is_first=True,
                        kv_transfer_params={
                            "remote_engine_id": self.engine_id,
                            "remote_request_id": req.request_id,
                            "remote_block_ids": list(range(rec["n_blocks"])),
                            "remote_seq_len": prompt_len,
                            "remote_first_token": first,
                            "remote_host": self.cfg.host,
                            "remote_port": self.advertised_port,
                        },
                        prompt_tokens=prompt_len, completion_tokens=1))
                    self.telemetry.request_success.labels(
                        finished_reason=FinishReason.LENGTH.value).inc()
                    return

                n = max(req.max_tokens, 1)
                for i in range(n):
                    await asyncio.sleep(self.cfg.sim_decode_ms_per_token / 1000)
                    tok = self._gen_tokens[i % len(self._gen_tokens)]
                    self.telemetry.decode_step.observe(
                        self.cfg.sim_decode_ms_per_token / 1000)
                    self.telemetry.generation_tokens.inc()
                    out.put_nowait(TokenEvent(
                        request_id=req.request_id, token_id=tok,
                        text=self.tokenizer.decode([tok]), is_first=(i == 0),
                        prompt_tokens=prompt_len, completion_tokens=i + 1))
                out.put_nowait(TokenEvent(
                    request_id=req.request_id, token_id=None,
                    finish_reason=FinishReason.LENGTH,
                    prompt_tokens=prompt_len, completion_tokens=n))
                self.telemetry.request_success.labels(
                    finished_reason=FinishReason.LENGTH.value).inc()
            except asyncio.CancelledError:
                out.put_nowait(TokenEvent(
                    request_id=req.request_id, token_id=None,
                    finish_reason=FinishReason.ABORT, prompt_tokens=prompt_len))
                self.telemetry.request_success.labels(
                    finished_reason=FinishReason.ABORT.value).inc()
            finally:
                self._running -= 1
                self._blocks_used -= n_blocks
                self._update_gauges()
        finally:
            self._sem.release()
