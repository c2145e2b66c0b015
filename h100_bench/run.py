"""Run one cell of ``BENCHMARK.json`` once on one H100.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In one process: draw the cell's weights on the card from the seed, build a
``TorchEngine`` with them and the cell's engine settings, serve it through
``EngineServer`` on a free port, warm up every shape the cell's traffic
uses, then let the load generator (``loadgen.py``, a child process) drive
``POST /v1/completions`` for ``--seconds``. Once every request due in the
window has finished (or a minute has passed), read the metrics, stop the
server, free the engine, and hold the served tokens of the finished
requests that the cell's ``correct`` takes (a cap above the window's count
takes every one) against the plain reference (``reference/model.py``). The last line of standard
output is one JSON object; the numbers compared, each beside its limit, end
standard error and the result's ``checks``.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (with ``trace.Recorder`` installed and a profiled window
inside the run's window). The run refuses to start without a card, and
prints no result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """time.monotonic() of this process's start (from /proc, where it can
    be read; else now)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.monotonic() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T_START = _process_start()
# Libraries that load JAX on their own when it is installed stay off it.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "llm_d_inference_scheduler_tpu")
DRAIN_S = 60.0          # how long past the window's close a request may take
LEAD_S = 2.0            # the load generator's start-up before the window
# A traced run profiles the last 6 s of its window (trace.Recorder).
PROFILE_S = 6.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def byte_text(ids: list[int]) -> str:
    """What the byte tokenizer streams for these ids, one token at a time:
    ids 0-2 are its specials (no text), any other id its byte (id - 3) mod
    256, a lone byte past ASCII as U+FFFD."""
    return "".join(bytes([(i - 3) % 256]).decode("utf-8", errors="replace")
                   for i in ids if i >= 3)


# ---- the serving run ---------------------------------------------------------

async def _drive(server_port: int, loop: str, reqs, seconds: float, clients: int,
                 start: float) -> list[dict]:
    spec = {"host": "127.0.0.1", "port": server_port, "loop": loop,
            "clients": clients, "start": start, "seconds": seconds,
            "requests": [{"rid": r.rid, "due": r.due, "prompt": r.prompt,
                          "max_tokens": r.max_tokens} for r in reqs]}
    proc = await asyncio.create_subprocess_exec(
        sys.executable, str(HERE / "loadgen.py"), stdin=subprocess.PIPE,
        stdout=subprocess.PIPE)
    try:
        out, _ = await asyncio.wait_for(
            proc.communicate(json.dumps(spec).encode()),
            timeout=start - time.monotonic() + seconds + DRAIN_S + 30)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"the load generator exited with {proc.returncode}")
    return json.loads(out)


def _telemetry(engine) -> dict[str, float]:
    t = engine.telemetry
    return {"ttft_sum": t.ttft.sum, "ttft_count": t.ttft.count,
            "decode_sum": t.decode_step.sum, "decode_count": t.decode_step.count,
            "prefill_sum": t.prefill_step.sum, "prefill_count": t.prefill_step.count,
            "prompt_tokens": t.prompt_tokens.value,
            "generation_tokens": t.generation_tokens.value}


async def serve_window(cell, mcfg, arch, params, seed: int, seconds: float,
                       trace: bool, device: str) -> types.SimpleNamespace:
    """Build the engine and server, warm up, drive the window; returns the
    client records, the served token ids, counters and the trace."""
    from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
    from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
    from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer

    from h100_bench import traffic as traffic_mod
    from h100_bench.trace import Recorder

    import torch

    tf = cell.traffic
    # The engine reads a model it has no registry entry for from a
    # directory's model_config.json (weights passed in, none on disk).
    model_dir = tempfile.TemporaryDirectory(prefix="h100_bench_model_")
    with open(os.path.join(model_dir.name, "model_config.json"), "w") as f:
        json.dump({k: getattr(mcfg, k) for k in mcfg.__dataclass_fields__}, f)
    ecfg = EngineConfig(model=model_dir.name, served_model_name=cell.config["name"],
                        host="127.0.0.1", port=0, device=device,
                        seed=seed & (2**31 - 1), warmup=True, **cell.engine)
    engine = TorchEngine(ecfg, params)
    served: dict[str, list[int]] = {}
    # Per request the engine's arrival stamp and its first token's emit.
    engine_first: dict[str, tuple[float, float]] = {}
    emit = engine._emit

    def record_emit(slot, ev):
        if ev.token_id is not None:
            served.setdefault(ev.request_id, []).append(int(ev.token_id))
            if ev.is_first:
                engine_first[ev.request_id] = (slot.req.arrival_time, time.monotonic())
        emit(slot, ev)

    engine._emit = record_emit
    server = EngineServer(ecfg, engine)
    recorder = None
    try:
        await server.start()
        while engine.warming:
            if engine.failure is not None:
                raise RuntimeError("the engine's warm-up failed") from engine.failure
            await asyncio.sleep(0.05)
        if trace:
            profile_s = min(PROFILE_S, 0.5 * seconds)
            recorder = Recorder(engine, arch, seconds - profile_s, profile_s,
                                lambda: _telemetry(engine))
            recorder.install()
        warm = traffic_mod.warmup(tf, seed, mcfg.vocab_size,
                                  int(tf.get("warmup_requests", 8)))
        for r in warm:
            r.due = 0.0
        done = await _drive(server.port, "open", warm, 0.0, 1, time.monotonic() + 0.5)
        bad = [d for d in done if d.get("error")]
        if bad:
            raise RuntimeError(f"warm-up request failed: {bad[0]['error']}")
        reqs = traffic_mod.generate(tf, seed, seconds, mcfg.vocab_size)
        if device != "cpu":
            torch.cuda.synchronize()
        served.clear()
        engine_first.clear()
        before = _telemetry(engine)
        start = time.monotonic() + LEAD_S
        if recorder is not None:
            recorder.window_open = start
        setup_s = start - T_START
        records = await _drive(server.port, tf["loop"], reqs, seconds,
                               int(tf.get("clients", 1)), start)
        after = _telemetry(engine)
        summary = recorder.summary() if recorder is not None else None
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    finally:
        if recorder is not None:
            recorder.uninstall()
        await server.stop()
        model_dir.cleanup()
    queue_ms = list(recorder.queue_ms) if recorder is not None else []
    counted_until = start + seconds
    if recorder is not None and recorder.counters is not None:
        # A traced run's counters stop where its profiled window begins.
        after, counted_until = recorder.counters, recorder.counted_until
    counters = {k: after[k] - before[k] for k in after}
    del server, engine, recorder
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return types.SimpleNamespace(records=records, served=served, counters=counters,
                                 counted_until=counted_until, engine_first=engine_first,
                                 trace=summary, queue_ms=queue_ms, start=start,
                                 end=start + seconds, seconds=seconds,
                                 setup_s=setup_s, memory_peak_bytes=peak,
                                 requests={r.rid: r for r in reqs})


# ---- correctness ---------------------------------------------------------------

REF_TOKENS = 65536      # tokens of the sequences in one pass of the reference


def pick_sample(win, cell, seed: int) -> list[str]:
    """Finished requests in an order drawn from the seed, the longest
    first, until the cell's ``tokens`` served tokens or ``max_requests``
    requests (a cap above the window's count compares every one)."""
    import numpy as np

    ok = [r["rid"] for r in win.records
          if not r.get("error") and r["rid"] in win.served]
    if not ok:
        return []
    longest = max(ok, key=lambda rid: len(win.requests[rid].prompt) + len(win.served[rid]))
    rng = np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), 2]))
    order = [longest] + [ok[i] for i in rng.permutation(len(ok)) if ok[i] != longest]
    want, cap = int(cell.correct.get("tokens", 1)), int(cell.correct.get("max_requests", 8))
    out, n = [], 0
    for rid in order:
        if n >= want or len(out) >= cap:
            break
        out.append(rid)
        n += len(win.served[rid])
    return out


def gaps(params, arch, win, rids: list[str], device: str, *, quant: str | None = None,
         tf32: bool = True) -> list[float]:
    """At each served token's position, the reference's best logit less its
    logit of the served token (or, with ``quant``, of the token the
    lower-precision control puts first), over the sampled requests in
    order. The reference runs over groups of at most ``REF_TOKENS`` tokens."""
    groups, n = [[]], 0
    for rid in rids:
        size = len(win.requests[rid].prompt) + len(win.served[rid])
        if groups[-1] and n + size > REF_TOKENS:
            groups.append([])
            n = 0
        groups[-1].append(rid)
        n += size
    return [g for group in groups if group
            for g in _group_gaps(params, arch, win, group, device, quant, tf32)]


def _group_gaps(params, arch, win, rids, device, quant, tf32) -> list[float]:
    import torch

    from h100_bench.reference.model import logits_at

    seqs, pos, toks = [], [], []
    for rid in rids:
        prompt, out = win.requests[rid].prompt, win.served[rid]
        seqs.append(prompt + out[:-1])
        pos.append(list(range(len(prompt) - 1, len(prompt) + len(out) - 1)))
        toks.append(out)
    ref = logits_at(params, arch, seqs, pos, device=device, tf32=tf32)
    if quant is not None:
        ctl = logits_at(params, arch, seqs, pos, device=device, quant=quant, tf32=tf32)
        toks = [c.argmax(-1).tolist() for c in ctl]
    out = []
    for r, t in zip(ref, toks):
        t = torch.tensor(t, device=r.device, dtype=torch.long)
        out += (r.max(-1).values - r.gather(-1, t[:, None])[:, 0]).tolist()
    return out


def gap_numbers(g: list[float]) -> dict[str, float]:
    """The numbers a cell may hold its served tokens to: the widest gap,
    the mean gap, and the mean of the smallest nine tenths of the gaps.
    The last leaves out the few tokens whose expert routing flips at a
    near-tie between bf16 and f32 router logits, which move a sound MoE
    program's gap by up to ~3 and no precision change can cure."""
    low = sorted(g)[:max(1, len(g) * 9 // 10)]
    return {"max_logit_gap": max(g), "mean_logit_gap": sum(g) / len(g),
            "mean_gap_low90": sum(low) / len(low)}


def checks(cell, win, params, arch, seed: int, device: str
           ) -> tuple[dict[str, dict[str, float]], list[str], list[float]]:
    """Every number compared, with its limit: requests that failed or never
    finished, requests cut short of their ``max_tokens``, streams whose text
    differs from the tokens the engine served, and the gap numbers the
    cell's ``limits`` name, of the sampled requests' served tokens against
    the reference. Also returns the sample and its gaps."""
    due = win.records
    failed = sum(1 for r in due if r.get("error"))
    short = sum(1 for r in due if not r.get("error")
                and r.get("completion_tokens") != r["max_tokens"])
    garbled = sum(1 for r in due if not r.get("error")
                  and r["text"] != byte_text(win.served.get(r["rid"], [])))
    out = {"failed_requests": {"value": failed, "limit": 0},
           "short_requests": {"value": short, "limit": 0},
           "stream_mismatch": {"value": garbled, "limit": 0}}
    rids = pick_sample(win, cell, seed)
    g = gaps(params, arch, win, rids, device) if rids else []
    limits = cell.correct["limits"]
    got = gap_numbers(g) if g else {k: math.inf for k in limits}
    for k, lim in limits.items():
        out[k] = {"value": got[k], "limit": float(lim)}
    # The one number held from below: at least this many tokens compared.
    out["tokens_compared"] = {"value": len(g), "limit": int(cell.correct.get("min_tokens", 1))}
    return out, rids, g


def is_correct(ch: dict[str, dict[str, float]]) -> bool:
    return all(v["value"] >= v["limit"] if k == "tokens_compared" else v["value"] <= v["limit"]
               for k, v in ch.items())


# ---- metrics -------------------------------------------------------------------

def context(cell, win, arch, device_name: str) -> types.SimpleNamespace:
    """What the metric readers read (``metrics/<name>.py``)."""
    from h100_bench import counts

    return types.SimpleNamespace(cell=cell, arch=arch, records=win.records,
                                 start=win.start, end=win.end, seconds=win.seconds,
                                 wait_s=DRAIN_S, setup_s=win.setup_s,
                                 counters=win.counters, counted_until=win.counted_until,
                                 engine_first=win.engine_first,
                                 queue_ms=win.queue_ms,
                                 trace=win.trace, counts=counts, device=device_name)


def breakdown(trace: dict) -> dict[str, list]:
    ops = sorted(trace["kernels_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in trace["idle_by_host"][:10]]}


def serve(spec, cell_name: str, seed: int, seconds: float, trace: bool,
          device: str = "cuda") -> types.SimpleNamespace:
    """Draw the cell's weights and serve its window: what ``result`` reads."""
    import torch

    from h100_bench import spec as spec_mod
    from h100_bench import weights
    from h100_bench.reference.model import Arch

    cell = spec.cell(cell_name)
    mcfg = spec_mod.model_config(cell.config)
    arch = Arch.from_config(cell.config)
    params = weights.draw(mcfg, seed, device, getattr(torch, mcfg.dtype))
    win = asyncio.run(serve_window(cell, mcfg, arch, params, seed, seconds, trace, device))
    return types.SimpleNamespace(spec=spec, cell=cell, arch=arch, params=params, win=win,
                                 seed=seed, trace=trace, device=device)


def result(state: types.SimpleNamespace) -> dict:
    """The result document of a served window: its metrics, then the
    comparison with the reference (the sample and its gaps go to
    ``state.sample`` and ``state.gaps``)."""
    import torch

    cell, win, device = state.cell, state.win, state.device
    name = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    ctx = context(cell, win, state.arch, name)
    metrics = {}
    for m in (cell.per_layer if state.trace else cell.end_to_end):
        v = state.spec.metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    ch, state.sample, state.gaps = checks(cell, win, state.params, state.arch, state.seed,
                                          device)
    attempted = sum(1 for r in win.records if r.get("rid") != "pool")
    result = {"correct": is_correct(ch), "attempted": attempted,
              "failed": ch["failed_requests"]["value"], "metrics": metrics,
              "device": {"platform": "gpu" if device != "cpu" else "cpu", "kind": name,
                         "count": 1, "memory_peak_bytes": win.memory_peak_bytes}}
    if state.trace and win.trace is not None:
        result["device"]["busy_s"] = win.trace["busy_s"]
        result["device"]["window_s"] = win.trace["window_s"]
        result["breakdown"] = breakdown(win.trace)
        result["profiler_cost_s"] = win.trace["profiler_cost_s"]
    result["checks"] = ch
    return result


def run_cell(spec, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run of one cell; returns the result document."""
    return result(serve(spec, cell_name, seed, seconds, trace, device))


def emit(result: dict) -> None:
    """The result's line and, last on standard error, every number
    compared beside its limit."""
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from h100_bench.spec import Spec

    spec = Spec()
    chips = next(w["chips"] for w in spec.bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: cell {args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"run.py: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
