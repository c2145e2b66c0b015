"""What a traced run (``--trace 1``) records, from the benchmark's own
wrappers around the engine's calls into each layer.

``Recorder.install`` wraps, on one ``TorchEngine`` and only in a traced run:

- ``_step``: opens the profiled window on the engine thread (the one thread
  that launches device work) at a step boundary ``profile_at`` after the
  window opens, and closes it ``profile_s`` later, each after a
  ``torch.cuda.synchronize``; ``torch.profiler`` records the device's
  activity (CUDA only) between, and stops at the close. The profiler
  slows the host's enqueue and its stop stalls the engine for seconds, so
  the window sits at the end of the run's window, and the counter metrics
  (``counters``, ``queue_ms``, ``counted_until``) cover the run's window
  before it. Installed before the warm-up, the recorder starts the
  profiler once there, so that CUPTI's initialisation falls in set-up.
- ``_decode_chunk``: the lanes' positions, from which K1's bytes and the
  model's operations of the chunk follow.
- ``_run_prefill``: the tokens a prefill or prefill window computes and the
  cached context it continues from.
- ``ops.moe.group_rows``: each grouped FFN call's routed rows per expert
  (kept on the device and read once the window has closed).
- ``_record_queue_wait``: each request's admission wait, the engine's own
  measure (``x-engine-queue-ms``, which streamed responses do not carry).
- host spans (epoch ns, the profiler's clock) of the engine thread's
  admission, prefill, decode chunk and first-token readback, which label
  the device's idle gaps.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Any

import torch

from . import counts

class Recorder:
    def __init__(self, engine, arch, profile_at: float, profile_s: float, snapshot):
        self.engine, self.arch, self.snapshot = engine, arch, snapshot
        self.profile_at, self.profile_s = profile_at, profile_s
        self.counters: dict[str, float] | None = None  # snapshot at the profile's start
        self.counted_until: float | None = None
        self.window_open: float | None = None   # time.monotonic()
        self.on = False
        self.done = False
        self.warmed = False
        self.cost_s: dict[str, float] = {}   # the profiler's own start/stop
        self.prof = None
        self.peak = counts.PEAK_BF16_FLOPS
        self.t0 = self.t1 = 0.0
        self.model_flops = 0.0
        self.k1_least_s = 0.0
        self.k1_launches = 0
        self.k2_counts: list[torch.Tensor] = []
        self.queue_ms: list[float] = []
        self.spans: list[tuple[str, int, int]] = []
        self._undo: list[tuple[Any, str, Any, bool]] = []

    # ---- installation ---------------------------------------------------

    def _wrap(self, owner, name, make):
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig, name in vars(owner)))
        setattr(owner, name, make(orig))

    def install(self) -> None:
        from llm_d_inference_scheduler_tpu_torch.engine import core
        from llm_d_inference_scheduler_tpu_torch.ops import moe

        eng, arch = self.engine, self.arch
        dummy = core._DUMMY_REQ
        block = eng.mcfg.kv_block_size
        isz = torch.empty((), dtype=eng.dtype).element_size()
        self.peak = (counts.PEAK_BF16_FLOPS if eng.dtype == torch.bfloat16
                     else counts.PEAK_F32_FLOPS)

        def step(orig):
            def run():
                self._maybe_toggle()
                return orig()
            return run

        def decode_chunk(orig):
            def run(tokens, positions, tables, reqs):
                if self.on:
                    K, L = eng.cfg.decode_chunk, arch.n_layers
                    for k in range(K):
                        nb, fl = counts.k1_call([int(p) + k + 1 for p in positions],
                                                arch.n_heads, arch.n_kv_heads,
                                                arch.head_dim, block, isz)
                        self.k1_least_s += counts.least_seconds(nb, fl, self.peak) * L
                    self.k1_launches += K * L
                    ctx = []
                    for p, r in zip(positions, reqs):
                        if r is dummy:
                            continue
                        made = int(p) - len(r.prompt_token_ids) + 1
                        steps = max(0, min(K, r.max_tokens - made))
                        ctx += [int(p) + k + 1 for k in range(steps)]
                    self.model_flops += counts.tokens_flops(arch, ctx, len(ctx))
                return self._span("decode_chunk", orig, tokens, positions, tables, reqs)
            return run

        def run_prefill(orig):
            def run(req, prompt, suffix, cached_tokens, matched_bids, row):
                if self.on:
                    n = len(suffix)
                    self.model_flops += counts.tokens_flops(
                        arch, range(cached_tokens + 1, cached_tokens + n + 1), 1)
                return self._span("prefill", orig, req, prompt, suffix,
                                  cached_tokens, matched_bids, row)
            return run

        def spanned(label):
            def make(orig):
                def run(*a, **kw):
                    return self._span(label, orig, *a, **kw)
                return run
            return make

        def group_rows(orig):
            def run(*a, **kw):
                g = orig(*a, **kw)
                if self.on:
                    self.k2_counts.append(g.counts)
                return g
            return run

        def queue_wait(orig):
            def run(request_id):
                orig(request_id)
                ms = eng.queue_waits.get(request_id)
                if (ms is not None and self.window_open is not None
                        and not self.on and not self.done):
                    self.queue_ms.append(ms)
            return run

        self._wrap(eng, "_step", step)
        self._wrap(eng, "_decode_chunk", decode_chunk)
        self._wrap(eng, "_run_prefill", run_prefill)
        self._wrap(eng, "_admit", spanned("admit"))
        self._wrap(eng, "_finalize_prefills", spanned("first_token_readback"))
        self._wrap(eng, "_record_queue_wait", queue_wait)
        self._wrap(moe, "group_rows", group_rows)

    def uninstall(self) -> None:
        for owner, name, orig, own in reversed(self._undo):
            if own:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
        self._undo.clear()

    # ---- engine thread --------------------------------------------------

    def _span(self, label, fn, *a, **kw):
        if not self.on:
            return fn(*a, **kw)
        t0 = time.time_ns()
        try:
            return fn(*a, **kw)
        finally:
            self.spans.append((label, t0, time.time_ns()))

    def _maybe_toggle(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = self.engine.device.type == "cuda"
        if self.window_open is None:
            if cuda and not self.warmed:
                # The profiler's first start initialises CUPTI, which takes
                # seconds: pay it in set-up, on this thread.
                t = time.monotonic()
                warm = profile(activities=[ProfilerActivity.CUDA])
                warm.start()
                warm.stop()
                self.cost_s["profiler_warmup"] = time.monotonic() - t
            self.warmed = True
            return
        if self.done:
            return
        now = time.monotonic()
        if not self.on and now >= self.window_open + self.profile_at:
            self.counters, self.counted_until = self.snapshot(), time.monotonic()
            self._sync()
            if cuda:
                t = time.monotonic()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
                self.cost_s["profiler_start"] = time.monotonic() - t
            self.t0, self.t0_ns = time.monotonic(), time.time_ns()
            self.on = True
        elif self.on and now >= self.t0 + self.profile_s:
            self._sync()
            self.t1, self.t1_ns = time.monotonic(), time.time_ns()
            self.on = False
            self.done = True
            if self.prof is not None:
                t = time.monotonic()
                self.prof.stop()
                self.cost_s["profiler_stop"] = time.monotonic() - t

    def _sync(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    # ---- after the window -------------------------------------------------

    def summary(self) -> dict[str, Any] | None:
        """Device activity of the profiled window and the shapes recorded in
        it; None if the window never opened (the run ended first)."""
        if not self.done:
            return None
        from torch.autograd import DeviceType

        evs = [] if self.prof is None else [
            e for e in self.prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
        by_name: dict[str, float] = defaultdict(float)
        ivs = []
        for e in evs:
            # Device time inside the profiled window only.
            s, t = max(e.start_ns(), self.t0_ns), min(e.start_ns() + e.duration_ns(), self.t1_ns)
            if t > s:
                by_name[e.name()] += (t - s) / 1e9
                ivs.append((s, t))
        ivs.sort()
        busy, gaps, cur_s, cur_e = 0, [], None, None
        for s, t in ivs:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, t
            else:
                cur_e = max(cur_e, t)
        if cur_e is not None:
            busy += cur_e - cur_s
        window_s = self.t1 - self.t0
        k2_rows = []
        if self.k2_counts:
            k2_rows = torch.stack(self.k2_counts).cpu().tolist()
        eng, a = self.engine, self.arch
        isz = torch.empty((), dtype=eng.dtype).element_size()
        k2 = [counts.k2_call(c, a.d_model, a.d_ff, isz) for c in k2_rows]
        return {
            "window_s": window_s, "busy_s": busy / 1e9,
            "kernels_s": dict(by_name),
            "k1_s": sum(v for k, v in by_name.items() if "paged_decode" in k),
            "k2_s": sum(v for k, v in by_name.items() if "grouped_" in k),
            "k1_least_s": self.k1_least_s,
            "k1_launches": self.k1_launches,
            "k2_least_s": sum(counts.least_seconds(b, f, self.peak) for b, f in k2),
            "k2_launches": len(k2),
            "model_flops": self.model_flops,
            "idle_by_host": self._label_gaps(gaps),
            "profiler_cost_s": dict(self.cost_s),
        }

    def _label_gaps(self, gaps) -> list[tuple[str, float]]:
        """Idle seconds of the device by the innermost engine-thread span at
        each gap's midpoint ("engine_other": outside every span, between
        them inside a step or waiting for work)."""
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        out: dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) // 2
            label = "engine_other"
            for name, s, t in reversed(spans[max(0, bisect.bisect_right(starts, mid) - 8):
                                             bisect.bisect_right(starts, mid)]):
                if t >= mid:
                    label = name
                    break
            out[label] += (b - a) / 1e9
        return sorted(out.items(), key=lambda kv: -kv[1])
