"""PyTorch port, sequence parallelism on the CPU: ring attention and
Ulysses against causal attention, the port's and the JAX package's.

The shapes are those of ``tests/test_ring_attention.py`` (B=2, S=8·sp,
D=16; ring GQA 4/2, Ulysses 8/4), the inputs numpy-seeded f32. The JAX
reference is its single-device ``causal_attention`` (the JAX ring and
Ulysses tests need an 8-device mesh of ``shard_map``s, which does not run
on this image). Tolerance: rtol = atol = 1e-5 (f32; the online softmax
only sums in another order):

- ``ring_attention`` and ``ulysses_attention`` for sp 2 and 4, directly
  and through their ``attention_fn`` adapters on a train layout;
- ring attention's input gradients against ``causal_attention``'s;
- the model's forward through each hook (ring under tp=2) against the
  plain forward;
- the refusals: Ulysses' head counts (``ValueError``,
  ``NotImplementedError``), padding masks on both paths, and a sequence
  that sp does not divide.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_inference_scheduler_tpu.ops import causal_attention as jax_causal_attention
from llm_d_inference_scheduler_tpu_torch.models import configs, llama
from llm_d_inference_scheduler_tpu_torch.ops.attention import causal_attention
from llm_d_inference_scheduler_tpu_torch.parallel import mesh
from llm_d_inference_scheduler_tpu_torch.parallel import serve as par
from llm_d_inference_scheduler_tpu_torch.parallel.ring_attention import (
    make_ring_attention_fn,
    ring_attention,
)
from llm_d_inference_scheduler_tpu_torch.parallel.ulysses import (
    make_ulysses_attention_fn,
    ulysses_attention,
)

TOL = dict(rtol=1e-5, atol=1e-5)
# (H, Hkv) of each path's case in tests/test_ring_attention.py.
HEADS = {"ring": (4, 2), "ulysses": (8, 4)}
PATHS = {"ring": (ring_attention, make_ring_attention_fn),
         "ulysses": (ulysses_attention, make_ulysses_attention_fn)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and the
    suite's workers share the machine's cores with timing-bound tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def qkv(sp: int, H: int, Hkv: int, seed: int = 0, B: int = 2, D: int = 16):
    rng = np.random.default_rng(seed)
    S = 8 * sp
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("path", list(PATHS))
def test_matches_causal_attention(path, sp):
    fn, make_fn = PATHS[path]
    arrays = qkv(sp, *HEADS[path], seed=sp)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    refs = (causal_attention(q, k, v).numpy(),
            np.asarray(jax_causal_attention(*(jnp.asarray(a) for a in arrays))))
    direct = fn(q, k, v, n_shards=sp)
    layout = mesh.make_train_layout(["cpu"] * (2 * sp), tp=1, sp=sp)  # dp=2
    hooked = make_fn(layout, replica=1)(q, k, v, q_positions=None, kv_positions=None)
    for out in (direct, hooked):
        assert out.shape == q.shape and out.dtype == q.dtype
        for ref in refs:
            np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_input_gradients_match_causal_attention(sp):
    arrays = qkv(sp, *HEADS["ring"], seed=10 + sp)
    upstream = torch.from_numpy(np.random.default_rng(20 + sp).standard_normal(
        arrays[0].shape).astype(np.float32))
    grads = []
    for fn in (lambda q, k, v: ring_attention(q, k, v, n_shards=sp), causal_attention):
        q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
        (fn(q, k, v) * upstream).sum().backward()
        grads.append([t.grad.numpy() for t in (q, k, v)])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("path,tp", [("ring", 2), ("ulysses", 1)])
def test_model_forward_through_the_hook(path, tp):
    """sp=2 (under tp=2 each tp rank's heads go round its own ring; tiny's
    one kv head per tp=2 rank is too few for Ulysses at sp=2)."""
    cfg = dataclasses.replace(configs.TINY, dtype="float32")
    params = llama.init_params(cfg, "cpu", generator=torch.Generator().manual_seed(5))
    layout = mesh.make_train_layout(["cpu"] * 2 * tp, tp=tp, sp=2)
    sharded = par.shard_params(params, cfg, layout.replica(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (2, 16)).astype(np.int32))
    ref, _ = llama.forward(params, cfg, toks)
    got, _ = llama.forward(sharded, cfg, toks, attention_fn=PATHS[path][1](layout))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_refusals():
    q, k, v = (torch.from_numpy(a) for a in qkv(2, 6, 2))
    with pytest.raises(ValueError, match="n_heads 6 must divide by sp 4"):
        ulysses_attention(q, k, v, n_shards=4)
    with pytest.raises(NotImplementedError, match=r"n_kv_heads \(2\) divisible by sp \(3\)"):
        ulysses_attention(q, k, v, n_shards=3)
    for fn in (ring_attention, ulysses_attention):
        with pytest.raises(ValueError, match="does not divide over sp=2"):
            fn(q[:, :15], k[:, :15], v[:, :15], n_shards=2)
    layout = mesh.make_train_layout(["cpu"] * 2, tp=1, sp=2)
    valid = torch.ones(q.shape[:2], dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="ring attention path does not take padding"):
        make_ring_attention_fn(layout)(q, k, v, kv_valid=valid)
    with pytest.raises(NotImplementedError, match="ulysses path does not take padding"):
        make_ulysses_attention_fn(layout)(q, k, v, kv_valid=valid)
