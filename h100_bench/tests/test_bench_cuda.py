"""The harness's whole run on the card at toy size: the port's kernels (K1,
and K2 on its f32 path), the profiled window and the per-layer readers."""

import pytest

from h100_bench import run


@pytest.mark.cuda
def test_a_traced_run_on_the_card(spec, cuda_device):
    res = run.run_cell(spec, "tiny-moe.tinychat", 2**31 + 1, 2.0, True, device=cuda_device)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert res["breakdown"]["device_ops"]
