"""Engine-side request/response types (copy of
``llm_d_inference_scheduler_tpu/engine/request.py``)."""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any


class FinishReason(str, enum.Enum):
    STOP = "stop"          # EOS or stop sequence
    LENGTH = "length"      # hit max_tokens
    ABORT = "abort"        # client disconnect / eviction
    CACHE_THRESHOLD = "cache_threshold"  # shared-storage probe: cache too cold


@dataclasses.dataclass
class EngineRequest:
    request_id: str
    prompt_token_ids: list[int]
    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0            # 0 = disabled
    top_p: float = 1.0        # 1.0 = disabled
    stop_token_ids: tuple[int, ...] = ()
    ignore_eos: bool = False   # benchmark/test knob (vLLM-compatible)
    stream: bool = False
    # Shared-storage probe (the sidecar's shared-storage connector): when the
    # prefix-cache hit ratio of the prompt's matchable blocks is below this,
    # the request ends at admission with FinishReason.CACHE_THRESHOLD,
    # before any block is allocated, and the sidecar prefills remotely.
    cache_hit_threshold: float | None = None
    # P/D disaggregation handshake, relayed by the router's sidecar: the
    # prefill leg sends {"do_remote_decode": true[, "stream_chunks": true]},
    # the decode leg the exporter's remote_* fields (engine/core.py).
    kv_transfer_params: dict[str, Any] | None = None
    # Multimodal prefill (E/P/D): encoder vectors [M, D] (numpy) that replace
    # the token embeddings at prompt positions mm_positions (placeholders).
    mm_embeds: Any = None
    mm_positions: list[int] | None = None
    arrival_time: float = dataclasses.field(default_factory=time.monotonic)


@dataclasses.dataclass
class TokenEvent:
    """One emitted token (or terminal event) on a request's output stream."""
    request_id: str
    token_id: int | None
    text: str = ""
    finish_reason: FinishReason | None = None
    # Set on the first event so servers can report TTFT.
    is_first: bool = False
    # Terminal event may carry KV handoff params back to the sidecar.
    kv_transfer_params: dict[str, Any] | None = None
    # usage accounting
    prompt_tokens: int = 0
    completion_tokens: int = 0
    cached_tokens: int = 0
