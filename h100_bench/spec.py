"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A ``Spec`` reads everything by name from two directories: ``root`` holds
``BENCHMARK.json`` (whose configuration ``file`` paths are relative to it)
and ``bench_dir`` holds ``traffic/``, ``cells/`` and ``metrics/``. The
benchmark's own run takes the checkout's root and ``h100_bench/``; a test
can point both at a data directory of its own, so that a new cell,
configuration, traffic mix or metric is only a set of new files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    config: dict[str, Any]         # configs/<config>.json
    traffic: dict[str, Any]        # traffic/<traffic>.json, cell overrides applied
    engine: dict[str, Any]         # cells/<cell>.json "engine"
    correct: dict[str, Any]        # cells/<cell>.json "correct"
    end_to_end: list[dict[str, Any]]
    per_layer: list[dict[str, Any]]


class Spec:
    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.bench_dir = Path(root), Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{[w['name'] for w in self.bench['workloads']]}")
        cfg_entry = next(c for c in self.bench["configs"] if c["name"] == entry["config"])
        config = _read_json(self.root / cfg_entry["file"])
        traffic = _read_json(self.bench_dir / "traffic" / f"{entry['traffic']}.json")
        cell_doc = _read_json(self.bench_dir / "cells" / f"{name}.json")
        traffic = {**traffic, **cell_doc.get("traffic", {})}
        return Cell(
            name=name, config=config, traffic=traffic,
            engine=dict(cell_doc.get("engine", {})),
            correct=dict(cell_doc.get("correct", {})),
            end_to_end=[m for m in self.bench["end_to_end"] if _covers(m, name)],
            per_layer=[m for m in self.bench["per_layer"] if _covers(m, name)])

    def metric_reader(self, name: str) -> Callable[[Any], float | None]:
        """``read(ctx)`` of ``metrics/<name>.py``: the metric's value, or
        None where the run gave it nothing to read."""
        path = self.bench_dir / "metrics" / f"{name}.py"
        if not path.exists():  # a data directory of its own shares ours
            path = BENCH_DIR / "metrics" / f"{name}.py"
        mod_spec = importlib.util.spec_from_file_location(
            f"h100_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read


def _read_json(path: Path) -> dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _covers(metric: dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def model_config(config: dict[str, Any]):
    """The port's ``ModelConfig`` of a configuration file, whose keys are
    those of the model's published ``config.json`` (Llama-family, Mixtral
    and Qwen3 names)."""
    from llm_d_inference_scheduler_tpu_torch.models.configs import ModelConfig

    experts = int(config.get("num_local_experts") or 0)
    return ModelConfig(
        name=config["name"],
        vocab_size=int(config["vocab_size"]),
        d_model=int(config["hidden_size"]),
        n_layers=int(config["num_hidden_layers"]),
        n_heads=int(config["num_attention_heads"]),
        n_kv_heads=int(config["num_key_value_heads"]),
        d_ff=int(config["intermediate_size"]),
        rope_theta=float(config["rope_theta"]),
        max_seq_len=int(config["max_position_embeddings"]),
        norm_eps=float(config["rms_norm_eps"]),
        dtype=str(config["torch_dtype"]),
        n_experts=experts,
        experts_per_token=int(config.get("num_experts_per_tok") or 2),
        head_dim_override=int(config.get("head_dim") or 0),
        qk_norm=config.get("model_type") == "qwen3")
