"""Request tracing for the engine: W3C trace context and a bounded span ring.

The port's own copy of the parts of ``llm_d_inference_scheduler_tpu/router/
tracing.py`` that the engine uses: ``traceparent`` parse and format, ``Span``
and the ``Tracer``'s ``span`` / ``span_from_headers`` / ``inject_headers`` /
``record`` / ``snapshot`` over a ring of finished span dicts, which the engine serves on
``GET /debug/traces``. The span dicts keep the router's keys, because the
gateway's ``/debug/traces?merge=1`` merges them with its own by ``span_id``.
No exporters. Configured like the router's tracer: ``TRACING_ENABLED=1``,
``TRACING_SAMPLE_RATIO`` (default 0.1) for traces that arrive without a
``traceparent``; an incoming one's sampled flag is honoured.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import time
import uuid
from collections import deque
from typing import Any

_current_span: contextvars.ContextVar["Span | object | None"] = \
    contextvars.ContextVar("engine_current_span", default=None)
_DROPPED = object()  # contextvar sentinel: this trace was sampled out

TRACEPARENT = "traceparent"
TRACESTATE = "tracestate"
_HEX = set("0123456789abcdef")


def format_traceparent(span: "Span") -> str:
    """W3C traceparent for ``span`` as the parent of the next hop."""
    return (f"00-{span.trace_id[:32].rjust(32, '0')}"
            f"-{span.span_id[:16].rjust(16, '0')}-01")


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s)


def parse_traceparent(value: str) -> tuple[str, str, bool] | None:
    """A traceparent header as (trace_id, parent_span_id, sampled), or None
    for anything malformed (field widths, non-hex, all-zero ids, extra
    fields under version 00, the forbidden version ff)."""
    parts = value.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[:4]
    if (len(version) != 2 or version == "ff"
            or len(trace_id) != 32 or len(span_id) != 16 or len(flags) < 2):
        return None
    if not (_is_hex(version) and _is_hex(trace_id) and _is_hex(span_id)
            and _is_hex(flags[:2])):
        return None
    if version == "00" and len(parts) != 4:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, bool(int(flags[:2], 16) & 0x01)


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start", "end",
                 "start_unix_ns", "attributes", "status", "tracestate")

    def __init__(self, name: str, trace_id: str, parent_id: str | None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.start = time.monotonic()        # duration measurement
        self.start_unix_ns = time.time_ns()  # wall-clock anchor
        self.end: float | None = None
        self.attributes: dict[str, Any] = {}
        self.status = "ok"
        self.tracestate: str | None = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "duration_ms": round(((self.end or time.monotonic()) - self.start) * 1e3, 3),
            "start_unix_ns": self.start_unix_ns,
            "attributes": self.attributes,
            "status": self.status,
        }


class _NoopSpan:
    def set_attribute(self, key: str, value: Any) -> None:
        pass


class Tracer:
    def __init__(self, *, enabled: bool | None = None,
                 sample_ratio: float | None = None, capacity: int = 512):
        self.enabled = (enabled if enabled is not None
                        else os.environ.get("TRACING_ENABLED", "") == "1")
        self.sample_ratio = (sample_ratio if sample_ratio is not None
                             else float(os.environ.get("TRACING_SAMPLE_RATIO", "0.1")))
        self.finished: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._rng = random.Random()

    @contextlib.contextmanager
    def span(self, name: str, *, remote_parent: tuple[str, str, bool] | None = None,
             tracestate: str | None = None, **attributes):
        """Open a span under the current one, or under ``remote_parent``
        ``(trace_id, parent_span_id, sampled)`` from inbound headers, whose
        sampling decision holds (False drops the subtree, True records
        without re-rolling); a fresh root is sampled at ``sample_ratio``."""
        parent = _current_span.get()
        if not self.enabled or parent is _DROPPED:
            yield _NoopSpan()
            return
        if parent is None and (
                (remote_parent is not None and not remote_parent[2])
                or (remote_parent is None
                    and self._rng.random() > self.sample_ratio)):
            # Sampled out: propagate the drop so children record nothing.
            token = _current_span.set(_DROPPED)
            try:
                yield _NoopSpan()
            finally:
                _current_span.reset(token)
            return
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif remote_parent is not None:
            trace_id, parent_id = remote_parent[0], remote_parent[1]
        else:
            trace_id, parent_id = uuid.uuid4().hex, None
        s = Span(name, trace_id, parent_id)
        s.tracestate = parent.tracestate if parent is not None else tracestate
        s.attributes.update(attributes)
        token = _current_span.set(s)
        try:
            yield s
        except BaseException as e:
            s.status = f"error: {type(e).__name__}"
            raise
        finally:
            s.end = time.monotonic()
            _current_span.reset(token)
            self.finished.append(s.to_dict())

    def span_from_headers(self, name: str, headers: Any, **attributes):
        """A span whose parent comes from inbound ``traceparent`` /
        ``tracestate`` headers (a mapping with lower-case keys); malformed
        or absent headers start a fresh root."""
        remote = state = None
        raw = headers.get(TRACEPARENT) if headers is not None else None
        if raw:
            remote = parse_traceparent(raw)
            if remote is not None:
                state = headers.get(TRACESTATE) or None
        return self.span(name, remote_parent=remote, tracestate=state,
                         **attributes)

    def inject_headers(self, headers: dict[str, str]) -> None:
        """Stamp the current span's W3C context onto an outbound header
        mapping; a sampled-out trace propagates as flags 00 (fresh ids: the
        receiver reads only the drop bit). No-op without a span context."""
        s = _current_span.get()
        if isinstance(s, Span):
            headers[TRACEPARENT] = format_traceparent(s)
            if s.tracestate:
                headers[TRACESTATE] = s.tracestate
        elif s is _DROPPED:
            headers[TRACEPARENT] = f"00-{uuid.uuid4().hex}-{uuid.uuid4().hex[:16]}-00"

    def current_span(self) -> Span | None:
        s = _current_span.get()
        return s if isinstance(s, Span) else None

    def record(self, name: str, start_monotonic: float, end_monotonic: float,
               *, parent: Span | None = None, **attributes) -> None:
        """Emit an already-timed phase span (windows known only after the
        fact, such as the engine's prefill and decode) under ``parent`` or
        the current span; dropped when there is neither or tracing is off."""
        if not self.enabled:
            return
        p = parent if parent is not None else self.current_span()
        if p is None:
            return
        s = Span(name, p.trace_id, p.span_id)
        s.start, s.end = start_monotonic, end_monotonic
        s.start_unix_ns = time.time_ns() - int(
            (time.monotonic() - start_monotonic) * 1e9)
        s.attributes.update(attributes)
        self.finished.append(s.to_dict())

    def snapshot(self) -> list[dict[str, Any]]:
        return list(self.finished)


# The engine process's tracer, configured from the environment (as the
# router's is); tests switch ``enabled`` on.
tracer = Tracer()
