"""A cell, a configuration, a traffic mix and a per-layer metric that exist
only as files in the tests' data directory run through the harness, which
no file of the benchmark had to change for."""

from h100_bench import run


def test_a_cell_of_new_files_runs(spec):
    cell = spec.cell("tiny-moe.tinychat")
    assert cell.config["name"] == "tiny-moe" and cell.traffic["rate_per_s"] == 12
    assert cell.engine["grouped_moe"] is True
    assert [m["name"] for m in cell.per_layer] == [
        "server_ms.chat", "queue_ms.chat", "decode_chunk_ms.chat", "tokens_per_request.chat"]
    res = run.run_cell(spec, "tiny-moe.tinychat", 4242, 1.5, True, device="cpu")
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(got) == {"server_ms.chat", "queue_ms.chat", "decode_chunk_ms.chat",
                        "tokens_per_request.chat"}
    assert got["server_ms.chat"]["value"] > 0
    assert 2 <= got["tokens_per_request.chat"]["value"] <= 24
    assert list(res)[-1] == "checks"


def test_end_to_end_metrics_of_a_new_cell(spec):
    res = run.run_cell(spec, "tiny-qwen.tinylong", 77, 1.5, False, device="cpu")
    assert set(res["metrics"]) == {"prompt_tok_s", "setup_s"}
    assert res["metrics"]["prompt_tok_s"]["value"] > 0
