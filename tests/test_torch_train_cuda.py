"""PyTorch port, the train step on the card: one ``tiny`` step in f32 on the
GPU against the same step on the CPU (the CPU step is held against JAX in
``tests/test_torch_train.py``). Marked ``cuda``; skipped where torch sees no
GPU. Imports no JAX, so it runs on a machine without it (``pytest
--noconftest``).

Tolerance: the loss at rtol 1e-5, the gradients at rtol 1e-4 + atol 1e-6
and the parameters after the step at atol 1e-5 (f32, TF32 off: only the
summation order differs); AdamW's first update follows the sign of a
gradient, so where a gradient lies within 1e-6 of zero the parameter is
held within 2 * lr.
"""

import dataclasses

import numpy as np
import pytest
import torch

from llm_d_inference_scheduler_tpu_torch.models import configs, llama
from llm_d_inference_scheduler_tpu_torch.parallel import mesh, train

pytestmark = pytest.mark.cuda

LR = 1e-4


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _step(cfg, params, toks, devices, **axes):
    layout = mesh.make_train_layout(devices, **axes)
    state = train.make_train_state(cfg, layout, lr=LR, params=params)
    loss = float(train.make_train_step(cfg, layout)(state, toks))
    return (loss, {k: v.cpu() for k, v in train.full_grads(cfg, state).items()},
            {k: v.cpu() for k, v in train.full_params(cfg, state).items()})


@pytest.mark.parametrize("n,tp,sp", [(1, 1, 1), (4, 2, 2)])
def test_train_step_on_the_card_matches_the_cpu(gpu, n, tp, sp):
    cfg = dataclasses.replace(configs.TINY, dtype="float32")
    params = llama.init_params(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 16)).astype(np.int32))
    want = _step(cfg, params, toks, ["cpu"], tp=1, sp=1)
    on_card = llama.nested_params({k: v.to(gpu) for k, v in llama.flat_params(params).items()})
    got = _step(cfg, on_card, toks.to(gpu), ["cuda"] * n, tp=tp, sp=sp)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, g in want[1].items():
        torch.testing.assert_close(got[1][name], g, rtol=1e-4, atol=1e-6)
        diff = (got[2][name] - want[2][name]).abs()
        assert float(torch.where(g.abs() > 1e-6, diff, 0).max()) <= 1e-5, name
        assert float(diff.max()) <= 2 * LR, name
