"""PyTorch port, the E/P/D vision tower and the prefill splice against JAX.

The tower (``models/vision.py``) and the multimodal splice of the port's
``llama.forward`` and ``llama.prefill`` run in f32 on the CPU on the JAX
package's weights (carried over by ``params_from_numpy``) and seeded numpy
inputs; the tower within 1e-5 abs + 1e-5 rel of JAX ``encode_image``, the
spliced logits and K/V within 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu.models import vision as jax_vision
from llm_d_inference_scheduler_tpu_torch.models import configs, llama, vision
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)


def _pixels(seed, B, vcfg):
    return np.random.default_rng(seed).standard_normal(
        (B, vcfg.image_size, vcfg.image_size, vcfg.channels)).astype(np.float32)


def test_patchify_is_exact():
    vcfg = vision.VIT_TINY
    px = _pixels(0, 3, vcfg)
    want = np.asarray(jax_vision._patchify(jax_vision.VIT_TINY, px))
    got = vision._patchify(vcfg, torch.from_numpy(px)).numpy()
    assert got.shape == (3, vcfg.n_patches, vcfg.patch_dim)
    np.testing.assert_array_equal(got, want)


def test_config_and_param_layout_match_jax():
    assert dataclasses.asdict(vision.VIT_TINY) == dataclasses.asdict(jax_vision.VIT_TINY)
    vcfg = dataclasses.replace(vision.VIT_TINY, out_dim=96)
    jp = jax_vision.init_vision_params(
        dataclasses.replace(jax_vision.VIT_TINY, out_dim=96), jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    tp = vision.init_vision_params(vcfg, "cpu", gen)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), tp)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(tp))
    # Seeded: the same seed draws the same tower.
    again = vision.init_vision_params(vcfg, "cpu", torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(tp),
                                                 jax.tree.leaves(again)))


@pytest.mark.parametrize("out_dim", [jax_vision.VIT_TINY.out_dim,
                                     jax_configs.TINY.d_model],
                         ids=["vit-tiny", "tiny-d_model"])
def test_encode_image_matches_jax(out_dim):
    jcfg = dataclasses.replace(jax_vision.VIT_TINY, out_dim=out_dim)
    tcfg = dataclasses.replace(vision.VIT_TINY, out_dim=out_dim)
    jp = jax_vision.init_vision_params(jcfg, jax.random.key(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    px = _pixels(1, 2, tcfg)
    want = np.asarray(jax_vision.encode_image(jp, jcfg, px))
    got = vision.encode_image(tp, tcfg, torch.from_numpy(px))
    assert got.shape == (2, tcfg.n_patches, out_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # Deterministic, and two images give two embeddings.
    assert torch.equal(got, vision.encode_image(tp, tcfg, torch.from_numpy(px)))
    assert not torch.allclose(got[0], got[1])


def test_forward_splice_matches_jax():
    """Three encoder rows spliced at positions 0, 1 and 5, plus one padding
    entry at position S (dropped by both): forward's logits, and the K/V
    and last logits of prefill with the same splice."""
    jcfg = dataclasses.replace(jax_configs.TINY, dtype="float32")
    tcfg = dataclasses.replace(configs.TINY, dtype="float32")
    jp = jax_llama.init_params(jcfg, jax.random.key(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    B, S, M = 2, 12, 4
    tokens = rng.integers(3, 400, size=(B, S)).astype(np.int32)
    mm = rng.standard_normal((B, M, jcfg.d_model)).astype(np.float32)
    pos = np.array([[0, 1, 5, S], [2, 3, S, 7]], np.int32)
    want, (wk, _) = jax_llama.forward(jp, jcfg, tokens, want_kv=True,
                                      mm_embeds=mm, mm_positions=pos)
    splice = dict(mm_embeds=torch.from_numpy(mm), mm_positions=torch.from_numpy(pos))
    got, _ = llama.forward(tp, tcfg, torch.from_numpy(tokens), **splice)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # Row b's S tokens into block 1 + b.
    shape = (tcfg.n_layers, 1 + B, tcfg.kv_block_size, tcfg.n_kv_heads, tcfg.head_dim)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    last, _, _ = llama.prefill(tp, tcfg, torch.from_numpy(tokens),
                               torch.full((B,), S, dtype=torch.int32), kp, vp,
                               torch.arange(1, 1 + B, dtype=torch.int32)[:, None], **splice)
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1], **TOL)
    np.testing.assert_allclose(kp[:, 1:, :S].numpy(), np.asarray(wk), **TOL)
    plain, _ = llama.forward(tp, tcfg, torch.from_numpy(tokens))
    assert not torch.allclose(got, plain)  # the rows did land
    # Past the last spliced position of each row, a row only differs
    # through attention; the rows before the first splice do not differ.
    assert torch.equal(got[1, :2], plain[1, :2])
