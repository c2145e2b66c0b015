"""PyTorch port, the GPipe training forward on the CPU, held against the
JAX single-device ``forward`` on the same weights (the JAX pipeline test,
``tests/test_serve_sharded.py``, needs a ``shard_map`` mesh that does not
run on this image).

- logits of ``make_pp_forward`` for dense and MoE ``tiny`` (f32, JAX
  weights carried over) at pp=2 with M=2 microbatches, and ``tiny`` cut to
  4 layers at pp=4 with M=4, within the JAX ``dryrun_pipeline`` bound
  (atol = rtol = 2e-3); the schedule runs each stage once per microbatch;
- ``dryrun_pipeline`` passes on its own seeded weights;
- the refusals: a layer count the stages do not divide (the case of
  ``tests/test_serve_sharded.py:134``, with the JAX text) and a batch the
  microbatches do not divide.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu_torch.models import configs, llama
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy
from llm_d_inference_scheduler_tpu_torch.parallel import pipeline

ATOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and the
    suite's workers share the machine's cores with timing-bound tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,n_layers,pp,M", [
    ("tiny", 2, 2, 2), ("tiny-moe", 2, 2, 2), ("tiny", 4, 4, 4)])
def test_gpipe_logits_match_jax_forward(name, n_layers, pp, M, monkeypatch):
    jcfg = dataclasses.replace(jax_configs.get_config(name), dtype="float32",
                               n_layers=n_layers)
    tcfg = dataclasses.replace(configs.get_config(name), dtype="float32",
                               n_layers=n_layers)
    jparams = jax_llama.init_params(jcfg, jax.random.key(7))
    toks = np.random.default_rng(7).integers(1, jcfg.vocab_size, (2 * M, 16)).astype(np.int32)
    want, _ = jax_llama.forward(jparams, jcfg, jnp.asarray(toks))

    layout = pipeline.make_pp_layout(["cpu"] * pp)
    assert layout.pp == pp
    params = pipeline.shard_params_pp(
        params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"), tcfg, layout)
    runs = []
    run_stage = llama.run_stage
    monkeypatch.setattr(llama, "run_stage", lambda cfg, st, x, *a, **kw: (
        runs.append(x.shape[0]), run_stage(cfg, st, x, *a, **kw))[1])
    got = pipeline.make_pp_forward(tcfg, layout, M)(params, torch.from_numpy(toks))
    assert runs == [2] * (pp * M)  # every stage once per microbatch of 2 rows
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_dryrun_pipeline():
    pipeline.dryrun_pipeline(dataclasses.replace(configs.TINY, n_layers=4), ["cpu"] * 2,
                             pp=2, n_microbatches=4)


def test_refusals():
    tcfg = dataclasses.replace(configs.TINY, dtype="float32")
    params = llama.init_params(tcfg, "cpu", generator=torch.Generator().manual_seed(0))
    # TINY has 2 layers: a 4-stage pipeline cannot split them evenly.
    with pytest.raises(ValueError, match="pp=4 does not divide n_layers=2"):
        pipeline.shard_params_pp(params, tcfg, pipeline.make_pp_layout(["cpu"] * 4))
    layout = pipeline.make_pp_layout(["cpu"] * 2)
    fwd = pipeline.make_pp_forward(tcfg, layout, 2)
    with pytest.raises(ValueError, match="does not divide into 2 microbatches"):
        fwd(pipeline.shard_params_pp(params, tcfg, layout),
            torch.ones((3, 8), dtype=torch.int32))


def test_pp_layout_takes_the_first_pp_devices():
    layout = pipeline.make_pp_layout(["cpu"] * 4, pp=2)
    assert (layout.pp, len(layout.devices)) == (2, 2)
    assert pipeline.make_pp_layout(["cpu"] * 3).pp == 3
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs a CUDA device, found 0"):
            pipeline.make_pp_layout()
        with pytest.raises(ValueError, match="needs 2 CUDA devices"):
            pipeline.make_pp_layout(pp=2)
