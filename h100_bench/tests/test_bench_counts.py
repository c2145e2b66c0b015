"""The yardstick's counts against hand counts at toy shapes."""

import pytest

from h100_bench import counts
from h100_bench.reference.model import Arch


def _arch(**kw):
    base = dict(vocab=10, d_model=8, n_layers=3, n_heads=2, n_kv_heads=1, head_dim=4,
                d_ff=16, rope_theta=1e4, eps=1e-5, n_experts=0, top_k=0, qk_norm=False)
    return Arch(**{**base, **kw})


def test_k1_counts_the_cached_rows_it_needs():
    # Lanes of lengths 1 (nothing cached) and 18 (17 cached rows, 2 pages).
    nbytes, flops = counts.k1_call([1, 18], n_heads=4, n_kv_heads=2, head_dim=16,
                                   block=16, isz=2)
    assert nbytes == 2 * 17 * 2 * 16 * 2 + 2 * 2 * 4 * 16 * 2 + 2 * 2 * 2 * 16 * 2 + 4 * 2 + 4 * 2
    assert flops == 4 * 4 * 16 * (17 + 2)


def test_k2_counts_the_experts_it_hits():
    nbytes, flops = counts.k2_call([3, 0, 1, 0], d_model=128, d_ff=256, isz=2)
    assert nbytes == 2 * 3 * 128 * 256 * 2 + 2 * 4 * 128 * 2
    assert flops == 6 * 128 * 256 * 4


def test_least_time_is_the_larger_bound():
    assert counts.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert counts.least_seconds(1.0, 989e12) == pytest.approx(1.0)


def test_model_step_dense_and_moe():
    dense = _arch()
    per_layer = 8 * 2 * 4 * 2 + 8 * 1 * 4 * 2 + 3 * 8 * 16
    assert counts.layer_matmul_params(dense) == per_layer
    # Three tokens at contexts 1, 2, 3 (a prefill of three), the head once.
    assert counts.tokens_flops(dense, [1, 2, 3], 1) == (
        2 * per_layer * 3 * 3 + 4 * 2 * 4 * 3 * (1 + 2 + 3) + 2 * 8 * 10)
    moe = _arch(n_experts=4, top_k=2)
    assert counts.layer_matmul_params(moe) == 8 * 2 * 4 * 2 + 8 * 1 * 4 * 2 + 2 * 3 * 8 * 16 + 8 * 4


def test_gap_numbers():
    from h100_bench.run import gap_numbers

    g = [0.0] * 18 + [0.5, 3.0]
    got = gap_numbers(g)
    assert got["max_logit_gap"] == 3.0
    assert got["mean_logit_gap"] == pytest.approx(3.5 / 20)
    # The smallest 18 of 20: the two routing-flip outliers fall outside.
    assert got["mean_gap_low90"] == 0.0
    assert gap_numbers([0.2])["mean_gap_low90"] == pytest.approx(0.2)
