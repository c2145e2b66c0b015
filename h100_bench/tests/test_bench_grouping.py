"""Qwen3-32B's grouping, 8 query heads a KV head behind QK-norm, through
the harness on the CPU at toy widths (``tiny-qwen-g8``: 16/2 heads at head
dim 32; ``tiny-qwen`` has 2 a KV head): the reference tests of
``test_bench_reference.py`` on its configuration, and a cell whose prompts
prefill in 32-token windows over the prior ones."""

import json
from pathlib import Path

import pytest

import test_bench_reference as reference_tests
from h100_bench import run
from h100_bench.spec import Spec

DATA = Path(__file__).resolve().parent / "data"
CELL = "tiny-qwen-g8.tinylong"


@pytest.fixture
def g8_spec(tmp_path):
    """The tests' data with the grouped configuration and its cell added,
    as a benchmark adds them: new entries beside the tiny-qwen cell's."""
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-qwen-g8", "source": "test", "reduced": [],
                             "file": str(DATA / "configs" / "tiny-qwen-g8.json"),
                             "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-qwen-g8",
                               "traffic": "tinylong", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-qwen.tinylong" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return Spec(tmp_path, DATA)


def test_reference_matches_the_port_forward_at_eight_heads_a_kv_head():
    reference_tests.test_reference_matches_the_port_forward("tiny-qwen-g8")


def test_served_tokens_match_the_reference_through_prior_windows(g8_spec):
    cell = g8_spec.cell(CELL)
    assert cell.config["num_attention_heads"] // cell.config["num_key_value_heads"] == 8
    reference_tests.test_served_tokens_match_the_reference(g8_spec, CELL)
    # Every prompt (60-120 tokens) takes two or more 32-token windows.
    state = run.serve(g8_spec, CELL, 2**31 + 7, 1.5, False, device="cpu")
    served = len(state.win.served)
    assert served and state.win.counters["prefill_count"] >= 2 * served


def test_the_qwen3_cell_serves_the_whole_model_at_its_widths():
    """The benchmark's own cell: Qwen3-32B whole (nothing in ``reduced``),
    64/8 heads whose q is 8192 wide beside a 5120 hidden size, QK-norm,
    32.76 B parameters (65.5 GB in bf16), the dense FFN (no grouped
    switch), and one compared token a request."""
    from math import prod

    from h100_bench import spec as spec_mod
    from h100_bench import weights

    cell = Spec().cell("qwen3-32b.longprompt")
    mcfg = spec_mod.model_config(cell.config)
    assert cell.config["reduced"] == {} and mcfg.n_layers == 64
    assert (mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim, mcfg.d_model) == (64, 8, 128, 5120)
    assert mcfg.qk_norm and not mcfg.n_experts and "grouped_moe" not in cell.engine
    n = sum(prod(shape) for shape, _ in weights.shapes(mcfg).values())
    assert round(n / 1e9, 2) == 32.76
    assert cell.traffic["output_len"] == {"dist": "fixed", "value": 1}
    assert cell.correct["tokens"] == cell.correct["max_requests"] >= cell.correct["min_tokens"] >= 32
