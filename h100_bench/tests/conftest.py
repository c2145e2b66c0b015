"""Tests of the benchmark harness. They run on the CPU at toy sizes from
the data directory beside them; the ``cuda`` tests run the same cells on
the card and skip without one. No JAX: run them with
``python -m pytest h100_bench/tests -q``."""

from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped where torch sees none)")


@pytest.fixture
def spec():
    from h100_bench.spec import Spec

    return Spec(DATA, DATA)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: torch sees none")
    return "cuda"
