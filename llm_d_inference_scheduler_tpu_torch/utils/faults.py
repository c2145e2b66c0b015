"""Deterministic fault injection: the engine's chaos shim.

The port's copy of ``FaultRule`` and ``FaultInjector``
(``llm_d_inference_scheduler_tpu/router/resilience.py``), with the same spec
grammar and the same decision, so a given seed and request id take the same
fault on a port engine as on a JAX one:

- a spec is comma-separated ``kind:pct[:arg]``, e.g.
  ``"reset:50,http503:25,delay:100:250,stall:25:10"``; the first matching
  rule wins;
- a rule fires when ``crc32(f"{seed}:{kind}:{id}") % 10000 < pct * 100``;
- the request kinds (``reset``, ``http503``, ``delay``, ``stall``; arg in
  ms) decide per request id, the lifecycle kinds (``spawn_fail``,
  ``slow_start`` arg ms, ``stall_drain`` arg phantom requests) once per
  pod identity (``host:port``);
- ``triggered`` counts firings per kind; ``enabled`` switches the shim off.
"""

from __future__ import annotations

import dataclasses
import zlib


@dataclasses.dataclass
class FaultRule:
    kind: str          # see FaultInjector.KINDS
    pct: float         # 0..100 of request-id hash space
    arg: float = 0.0   # delay/stall: ms; slow_start: ms; stall_drain: count


class FaultInjector:
    """Config/env-gated chaos shim; rules decide by a stable hash of
    (seed, rule kind, id)."""

    KINDS = ("reset", "http503", "delay", "stall",
             "spawn_fail", "slow_start", "stall_drain")
    LIFECYCLE_KINDS = ("spawn_fail", "slow_start", "stall_drain")

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        self.rules = rules
        self.seed = seed
        self.enabled = True
        self.triggered: dict[str, int] = {k: 0 for k in self.KINDS}

    @classmethod
    def from_spec(cls, spec: str | None, seed: int = 0) -> "FaultInjector | None":
        """The injector of ``spec``, or None for an empty one; an unknown
        kind raises ValueError."""
        spec = (spec or "").strip()
        if not spec:
            return None
        rules = []
        for part in spec.split(","):
            fields = [f.strip() for f in part.strip().split(":")]
            if not fields or not fields[0]:
                continue
            kind = fields[0]
            if kind not in cls.KINDS:
                raise ValueError(f"unknown fault kind {kind!r}; "
                                 f"known: {cls.KINDS}")
            pct = float(fields[1]) if len(fields) > 1 else 100.0
            arg = float(fields[2]) if len(fields) > 2 else 0.0
            rules.append(FaultRule(kind, pct, arg))
        return cls(rules, seed) if rules else None

    def _fires(self, rule: FaultRule, key: str) -> bool:
        h = zlib.crc32(f"{self.seed}:{rule.kind}:{key}".encode()) % 10000
        if h < rule.pct * 100:
            self.triggered[rule.kind] += 1
            return True
        return False

    def decide(self, request_id: str) -> FaultRule | None:
        """The request fault for ``request_id``, or None. Lifecycle rules
        key on pod identity and never take request traffic."""
        if not self.enabled:
            return None
        for rule in self.rules:
            if rule.kind not in self.LIFECYCLE_KINDS and self._fires(rule, request_id):
                return rule
        return None

    def decide_lifecycle(self, kind: str, pod_id: str) -> FaultRule | None:
        """The lifecycle fault ``kind`` for the pod ``pod_id`` (its
        host:port), or None: a fixed seed fails the same spawns every run."""
        if not self.enabled:
            return None
        for rule in self.rules:
            if rule.kind == kind and self._fires(rule, pod_id):
                return rule
        return None
