"""The end-to-end arithmetic: percentiles, rates, and a stall in the
window that has to show in the tail and the rate."""

import types

import pytest

from h100_bench import stats
from h100_bench.spec import Spec


def _records(stall_at=None, stall_s=0.0):
    """100 requests due every 0.1 s from t=100, first token 50 ms after its
    due time, 10 tokens 20 ms apart; a stall holds every event after
    ``stall_at`` back by ``stall_s``."""
    def at(t):
        return t + stall_s if stall_at is not None and t >= stall_at else t
    out = []
    for i in range(100):
        due = 100.0 + 0.1 * i
        times = [at(due + 0.05 + 0.02 * k) for k in range(10)]
        out.append({"rid": f"s0-{i}", "due": due, "sent": due, "prompt_tokens": 64,
                    "max_tokens": 10, "pieces": [[t, 1] for t in times],
                    "done": times[-1], "completion_tokens": 10, "error": None})
    return out


def _ctx(records):
    return types.SimpleNamespace(records=records, start=100.0, end=110.0, seconds=10.0,
                                 wait_s=60.0, counted_until=110.0)


def _read(name, ctx):
    return Spec().metric_reader(name)(ctx)


def test_percentile_interpolates():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile([0, 10], 95) == pytest.approx(9.5)
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95)


def test_steady_window():
    ctx = _ctx(_records())
    assert _read("ttft_p95_ms.chat", ctx) == pytest.approx(50.0)
    assert _read("tpot_p95_ms.chat", ctx) == pytest.approx(20.0)
    # The last requests' tokens land after the window closes.
    assert _read("output_tok_s", ctx) == pytest.approx(sum(
        1 for r in ctx.records for t, _ in r["pieces"] if t < 110.0) / 10.0)
    assert _read("prompt_tok_s", ctx) == pytest.approx(64 * 100 / 10.0)


def test_a_stall_moves_the_tail_and_the_rate():
    calm, stalled = _ctx(_records()), _ctx(_records(stall_at=105.0, stall_s=2.0))
    assert _read("ttft_p95_ms.chat", stalled) > _read("ttft_p95_ms.chat", calm) + 1500
    assert _read("output_tok_s", stalled) < _read("output_tok_s", calm) - 15
    assert _read("prompt_tok_s", stalled) < _read("prompt_tok_s", calm)


def test_a_failed_request_misses_every_limit():
    recs = _records()
    for r in recs[:6]:
        r["error"] = "HTTP 500"
    ctx = _ctx(recs)
    assert _read("ttft_p95_ms.chat", ctx) > 60_000
    assert _read("tpot_p95_ms.chat", ctx) > 60_000
