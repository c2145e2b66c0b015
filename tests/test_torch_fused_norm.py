"""PyTorch port, the served layer's RMSNorm, QK-norm and RoPE (K4,
``ops/fused_norm.py``) on the CPU, where its wrapper computes the plain
version.

- The wrapper's CPU path is the eager chain bit for bit (``norms.rms_norm``,
  ``rope.apply_rope``, the residual add), and through it matches the JAX
  package's ``rms_norm`` and ``apply_rope`` (f32, numpy-seeded; 2e-5 and
  1e-4 as ``test_torch_ops.py`` holds the eager functions).
- The dispatch: a CUDA tensor takes the kernel, and raises where grad mode
  is on and an input requires grad (K4 has no backward); the train step
  passes the eager functions (``fused_norm.PLAIN``) as ``llama.forward``'s
  ``norms``, never reaches the wrappers, and its loss and gradients are
  bit-equal to the same step through the wrappers' CPU path.
- The kernel's limits (width, head dim, dtype, shapes) raise, checked on
  meta tensors.
- Who reaches K4: every serving caller of ``models/llama.py`` (forward,
  prefill of a whole prompt and over a cached prefix, decode, the sharded
  layer) calls
  ``rms_norm`` 2 x L + 1 times (the MLP norm with the residual) and
  ``qk_norm_rope`` L times, and the vision tower its norms.
- The bytes ``chip_smoke.py`` phase 6c sets beside K4's timings.
The kernel itself is held to the eager chain on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_inference_scheduler_tpu.ops.norms import rms_norm as jax_rms_norm
from llm_d_inference_scheduler_tpu.ops.rope import apply_rope as jax_apply_rope
from llm_d_inference_scheduler_tpu.ops.rope import rope_table as jax_rope_table
from llm_d_inference_scheduler_tpu_torch.models import configs, llama, vision
from llm_d_inference_scheduler_tpu_torch.ops import fused_norm
from llm_d_inference_scheduler_tpu_torch.ops.norms import rms_norm
from llm_d_inference_scheduler_tpu_torch.ops.rope import apply_rope, rope_table
from llm_d_inference_scheduler_tpu_torch.parallel import mesh, train
from llm_d_inference_scheduler_tpu_torch.parallel import serve as par


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and the
    suite's workers share the machine's cores with timing-bound tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---- the CPU path -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_cpu_path_is_the_eager_chain(dtype, residual):
    g = torch.Generator().manual_seed(0)
    x = (3 * torch.randn(2, 5, 64, generator=g)).to(dtype)
    w = torch.randn(64, generator=g).to(dtype)
    r = torch.randn(2, 5, 64, generator=g).to(dtype) if residual else None
    before = fused_norm.launches
    got = fused_norm.rms_norm(x, w, 1e-6, residual=r)
    assert fused_norm.launches == before
    if residual:
        assert torch.equal(got[0], r + x)
        assert torch.equal(got[1], rms_norm(r + x, w, 1e-6))
    else:
        assert torch.equal(got, rms_norm(x, w, 1e-6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_qk_norm_rope_cpu_path_is_the_eager_chain(dtype, qk_norm):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 7, 4, 48, generator=g).to(dtype)
    k = torch.randn(2, 7, 2, 48, generator=g).to(dtype)
    cos, sin = rope_table(torch.randint(0, 5000, (2, 7), generator=g), 48, 1e6)
    qn = torch.randn(48, generator=g).to(dtype) if qk_norm else None
    kn = torch.randn(48, generator=g).to(dtype) if qk_norm else None
    got_q, got_k = fused_norm.qk_norm_rope(q, k, cos, sin, qn, kn, 1e-6)
    if qk_norm:
        q, k = rms_norm(q, qn, 1e-6), rms_norm(k, kn, 1e-6)
    assert torch.equal(got_q, apply_rope(q, cos, sin))
    assert torch.equal(got_k, apply_rope(k, cos, sin))


@pytest.mark.parametrize("shape,eps", [((3, 5, 64), 1e-5), ((2, 4, 48), 1e-6),
                                       ((4, 5120), 1e-6)])
def test_rms_norm_wrapper_matches_jax(shape, eps):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    np.testing.assert_allclose(fused_norm.rms_norm(_t(x), _t(w), eps).numpy(),
                               np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), eps)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("head_dim,theta,qk_norm", [(32, 10_000.0, False),
                                                    (128, 1_000_000.0, True),
                                                    (48, 1_000_000.0, True)])
def test_qk_norm_rope_wrapper_matches_jax(head_dim, theta, qk_norm):
    """q and k through the wrapper against the JAX norm (where the layer
    holds QK-norm weights) and RoPE, positions up to 8192."""
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 8192, size=(2, 7)).astype(np.int32)
    q = rng.normal(size=(2, 7, 4, head_dim)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, head_dim)).astype(np.float32)
    qn, kn = (rng.normal(size=(head_dim,)).astype(np.float32) for _ in range(2))
    cos, sin = rope_table(_t(pos), head_dim, theta)
    got = fused_norm.qk_norm_rope(_t(q), _t(k), cos, sin, _t(qn) if qk_norm else None,
                                  _t(kn) if qk_norm else None, 1e-6)
    jcos, jsin = jax_rope_table(jnp.asarray(pos), head_dim, theta)
    for g, x, w in zip(got, (q, k), (qn, kn)):
        x = jnp.asarray(x)
        if qk_norm:
            x = jax_rms_norm(x, jnp.asarray(w), 1e-6)
        # Angles up to 8192 rad: f32 cos/sin of large arguments differ by a
        # few ulps of the argument between libms -> 1e-4 absolute.
        np.testing.assert_allclose(g.numpy(), np.asarray(jax_apply_rope(x, jcos, jsin)),
                                   rtol=1e-4, atol=1e-4)


# ---- the dispatch -------------------------------------------------------------


def _like(device: str, requires_grad: bool):
    return types.SimpleNamespace(device=torch.device(device), requires_grad=requires_grad)


def test_dispatch_rests_on_device_and_autograd():
    """A CUDA tensor takes K4, and raises where grad mode is on and an
    input requires grad; any other device takes the eager chain, which
    autograd differentiates."""
    cuda, cuda_grad = _like("cuda", False), _like("cuda", True)
    assert fused_norm._takes_kernel(cuda, None, _like("cuda", False))
    for tensors in ((cuda_grad, _like("cuda", False)),
                    (cuda, None, _like("cuda", True))):  # a weight in training
        with pytest.raises(ValueError, match="no backward"):
            fused_norm._takes_kernel(*tensors)
    assert not fused_norm._takes_kernel(_like("cpu", True))
    assert not fused_norm._takes_kernel(_like("meta", False))
    with torch.no_grad():
        assert fused_norm._takes_kernel(cuda_grad, _like("cuda", True))
    x = torch.randn(3, 16, requires_grad=True)
    out = fused_norm.rms_norm(x, torch.ones(16))
    assert out.grad_fn is not None


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen"])
def test_train_step_bit_equal_through_the_wrappers(name, monkeypatch):
    """Training needs every norm's backward, which K4 lacks: the train step
    passes ``fused_norm.PLAIN`` and never reaches K4's wrappers, and its
    loss and gradients equal bit for bit those of the same step through the
    wrappers' CPU path, the eager chain the layer called before K4
    (QK-norm on tiny-qwen, RoPE alone on tiny)."""
    cfg = dataclasses.replace(configs.get_config(name), dtype="float32", n_layers=2)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (2, 16)).astype(np.int32))

    def refuse(*args, **kwargs):
        raise AssertionError("the train step reached a K4 wrapper")

    runs = []
    for through_wrappers in (False, True):
        if through_wrappers:
            monkeypatch.undo()
            monkeypatch.setattr(fused_norm, "PLAIN", fused_norm)
        else:
            monkeypatch.setattr(fused_norm, "rms_norm", refuse)
            monkeypatch.setattr(fused_norm, "qk_norm_rope", refuse)
        layout = mesh.make_train_layout(["cpu"])
        state = train.make_train_state(cfg, layout, seed=6)
        loss = train.make_train_step(cfg, layout)(state, toks)
        runs.append((float(loss), train.full_grads(cfg, state)))
    (loss_a, grads_a), (loss_b, grads_b) = runs
    assert loss_a == loss_b
    assert grads_a.keys() == grads_b.keys()
    for k in grads_a:
        assert torch.equal(grads_a[k], grads_b[k]), k


# ---- the kernel's limits ------------------------------------------------------


@pytest.mark.parametrize("width,ok", [(8, True), (64, True), (128, True), (4096, True),
                                      (5120, True), (8192, True), (32768, True), (0, False),
                                      (100, False), (4, False), (32776, False)])
def test_rms_norm_widths(width, ok):
    if ok:
        fused_norm.check_width(width)
    else:
        with pytest.raises(ValueError, match=f"width {width} unsupported"):
            fused_norm.check_width(width)


@pytest.mark.parametrize("head_dim,ok", [(16, True), (32, True), (48, True), (128, True),
                                         (256, True), (8, False), (24, False), (100, False),
                                         (272, False)])
def test_qk_norm_rope_head_dims(head_dim, ok):
    if ok:
        fused_norm.check_head_dim(head_dim)
    else:
        with pytest.raises(ValueError, match=f"head_dim {head_dim} unsupported"):
            fused_norm.check_head_dim(head_dim)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,match", [
    ("width", "width 100"), ("dtype", "dtype torch.float16"), ("weight", "weight"),
    ("residual", "residual"), ("head_dim", "head_dim 24"), ("k", "does not match"),
    ("cos", "cos/sin"), ("one norm", "come together"), ("norm dtype", "norm weight"),
    ("token bytes", "shared memory"),
])
def test_kernel_checks_refuse(case, match):
    """What the CUDA path checks before it launches, on meta tensors (no
    card needed); the sound inputs pass."""
    x, w = _meta(4, 5120), _meta(5120)
    q, k, cos = _meta(4, 64, 128), _meta(4, 8, 128), _meta(4, 64, dtype=torch.float32)
    fused_norm.check_rms_norm(x, w, residual=_meta(4, 5120))
    fused_norm.check_qk_norm_rope(q, k, cos, _meta(128), _meta(128))
    rms = {"width": (_meta(4, 100), _meta(100)),
           "dtype": (_meta(4, 64, dtype=torch.float16), _meta(64, dtype=torch.float16)),
           "weight": (x, _meta(5120, dtype=torch.float32)),
           "residual": (x, w, _meta(4, 4096))}
    qk = {"head_dim": (_meta(4, 2, 24), _meta(4, 2, 24), _meta(4, 12, dtype=torch.float32)),
          "k": (q, _meta(4, 8, 64), cos),
          "cos": (q, k, _meta(4, 128, dtype=torch.float32)),
          "one norm": (q, k, cos, _meta(128)),
          "token bytes": (_meta(4, 96, 128, dtype=torch.float32),
                          _meta(4, 8, 128, dtype=torch.float32), cos),
          "norm dtype": (q, k, cos, _meta(128, dtype=torch.float32),
                         _meta(128, dtype=torch.float32))}
    with pytest.raises(ValueError, match=match):
        if case in rms:
            fused_norm.check_rms_norm(*rms[case])
        else:
            fused_norm.check_qk_norm_rope(*qk[case])


# ---- who reaches K4 -----------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """Counts of the wrappers' calls (rms_norm with and without the
    residual, qk_norm_rope with and without norm weights)."""
    calls = {"rms_norm": 0, "residual": 0, "qk_norm_rope": 0, "qk_normed": 0}
    rms, qk = fused_norm.rms_norm, fused_norm.qk_norm_rope

    def rms_counted(x, weight, eps=1e-5, residual=None):
        calls["rms_norm"] += 1
        calls["residual"] += residual is not None
        return rms(x, weight, eps, residual=residual)

    def qk_counted(q, k, cos, sin, q_norm=None, k_norm=None, eps=1e-5):
        calls["qk_norm_rope"] += 1
        calls["qk_normed"] += q_norm is not None
        return qk(q, k, cos, sin, q_norm, k_norm, eps)

    monkeypatch.setattr(fused_norm, "rms_norm", rms_counted)
    monkeypatch.setattr(fused_norm, "qk_norm_rope", qk_counted)
    return calls


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen", "tiny-moe"])
@pytest.mark.parametrize("path", ["forward", "prefill", "prefix", "decode", "tp2"])
def test_serving_callers_reach_k4(counted, name, path):
    """Each serving form calls rms_norm 2 x L + 1 times (L with the
    residual) and qk_norm_rope L times (with norm weights on tiny-qwen)."""
    cfg = dataclasses.replace(configs.get_config(name), dtype="float32")
    params = llama.init_params(cfg, "cpu", generator=torch.Generator().manual_seed(2))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (1, 24)).astype(np.int32))
    block = cfg.kv_block_size
    shape = (cfg.n_layers, 1 + 64 // block, block, cfg.n_kv_heads, cfg.head_dim)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    row = torch.arange(1, 1 + 64 // block, dtype=torch.int32)[None]
    i32 = lambda n: torch.tensor([n], dtype=torch.int32)
    if path == "forward":
        llama.forward(params, cfg, tokens)
    elif path == "prefill":
        llama.prefill(params, cfg, tokens, i32(24), kp, vp, row)
    elif path == "prefix":
        llama.prefill(params, cfg, tokens[:, 16:], i32(8), kp, vp, row, i32(16),
                      row[:, :16 // block])
    elif path == "decode":
        llama.decode_step(params, cfg, tokens[0, :1], i32(16), kp, vp, row)
    else:
        sharded = par.shard_params(params, cfg, par.make_serve_layout(["cpu"] * 2, tp=2))
        llama.forward(sharded, cfg, tokens)
    L = cfg.n_layers
    tp = 2 if path == "tp2" else 1
    assert counted == {"rms_norm": (1 + tp) * L + 1, "residual": L,
                       "qk_norm_rope": tp * L, "qk_normed": tp * L * cfg.qk_norm}, counted


def test_vision_tower_reaches_k4(counted):
    vcfg = dataclasses.replace(vision.VIT_TINY, dtype="float32")
    params = vision.init_vision_params(vcfg, "cpu", torch.Generator().manual_seed(3))
    pixels = torch.rand(1, vcfg.image_size, vcfg.image_size, vcfg.channels)
    vision.encode_image(params, vcfg, pixels)
    assert counted["rms_norm"] == 2 * vcfg.n_layers + 1


# ---- phase 6c's bytes bound ---------------------------------------------------


# The longprompt cells' 1024-token windows and a decode batch of 4, bf16:
# bytes each entry must move (rows in and out once; cos/sin f32; the norm
# weights), and the least time at 3.35 TB/s.
@pytest.mark.parametrize("shape,want", [
    ((1024, 5120, 64, 8, 128, True),
     {"rms_norm": 20_981_760, "rms_norm+residual": 41_953_280, "qk_norm_rope": 38_273_536}),
    ((1024, 4096, 32, 8, 128, False),
     {"rms_norm": 16_785_408, "rms_norm+residual": 33_562_624, "qk_norm_rope": 21_495_808}),
    ((4, 5120, 64, 8, 128, True),
     {"rms_norm": 92_160, "rms_norm+residual": 174_080, "qk_norm_rope": 150_016}),
])
def test_phase_6c_bytes_at_the_cell_windows(shape, want):
    import chip_smoke

    assert shape in [tuple(s[1:]) for s in chip_smoke.K4_SHAPES]
    assert chip_smoke.norm_bytes(*shape, 2) == want


def test_phase_6c_least_time_of_a_qwen3_layer():
    """Qwen3-32B's window: 6.26 us for a norm, 12.52 with the residual,
    11.43 for QK-norm and RoPE; 30.2 us a layer, 1.93 ms over 64 layers."""
    import chip_smoke

    us = {k: b / chip_smoke.HBM_BYTES_PER_S * 1e6
          for k, b in chip_smoke.norm_bytes(1024, 5120, 64, 8, 128, True, 2).items()}
    assert us == pytest.approx({"rms_norm": 6.2632, "rms_norm+residual": 12.5234,
                                "qk_norm_rope": 11.4249}, abs=1e-4)
    assert 64 * sum(us.values()) / 1e3 == pytest.approx(1.933, abs=1e-3)
