"""PyTorch port, the serving prefill attention (K3, ``ops/prefill_attention.py``)
on the CPU, where its wrapper computes the plain version.

- Both serving forms against the port's and the JAX package's
  ``causal_attention`` (f32, numpy-seeded; rtol = atol = 1e-5, the order of
  sums only): the whole prompt of a batched prefill with trailing padding,
  which causality alone hides (each row equals the row run alone), and a
  window over a partly valid prior part (the masks the JAX
  ``prefill_with_prefix`` builds, and each row over its visible columns
  only).
- The refusals: an input that requires grad (K3 has no backward), a head
  dim the kernel does not take.
- Who attends through K3: the engine's serving prefill (``llama.prefill``,
  every window of chunked prefill, with or without a prior part) and its
  forwards (embeddings, the logits diagnostic) do; training, ring attention, Ulysses and the GPipe
  forward keep ``causal_attention`` and never reach K3.
- The least times ``chip_smoke.py`` phase 6b sets beside K3's timings at
  the longprompt cells' windows (32/8, 16/4 and 64/8 heads).
The kernel itself is held to the plain version on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import asyncio
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_inference_scheduler_tpu.ops import causal_attention as jax_causal_attention
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest
from llm_d_inference_scheduler_tpu_torch.models import configs, llama
from llm_d_inference_scheduler_tpu_torch.ops import attention, prefill_attention
from llm_d_inference_scheduler_tpu_torch.parallel import (
    mesh,
    pipeline,
    ring_attention,
    train,
    ulysses,
)

TOL = dict(rtol=1e-5, atol=1e-5)
H, HKV, D = 4, 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and the
    suite's workers share the machine's cores with timing-bound tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, B, S, P=0):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, D), (B, S, HKV, D), (B, S, HKV, D)]
    shapes += [(B, P, HKV, D), (B, P, HKV, D)] if P else []
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(q, k, v, **kw):
    return np.asarray(jax_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           **{n: jnp.asarray(a) for n, a in kw.items()}))


def _whole_prompt_batched():
    """Three prompts of 24, 17 and 5 tokens padded to 24 at the end, as the
    engine's batched prefill lays them out (no padding mask)."""
    lens = [24, 17, 5]
    q, k, v = _arrays(0, 3, 24)
    t = (torch.from_numpy(a) for a in (q, k, v))
    got = prefill_attention.causal(*t)
    np.testing.assert_array_equal(
        got.numpy(), attention.causal_attention(*(torch.from_numpy(a) for a in (q, k, v))))
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v), **TOL)
    for b, n in enumerate(lens):  # padding after a row's end changes none of its rows
        alone = _jax(q[b:b + 1, :n], k[b:b + 1, :n], v[b:b + 1, :n])
        np.testing.assert_allclose(got.numpy()[b:b + 1, :n], alone, **TOL)
    # With the lengths as new_len, the JAX function's padding mask.
    new_len = torch.tensor(lens, dtype=torch.int32)
    masked = prefill_attention.prefill_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), new_len=new_len)
    valid = np.arange(24)[None, :] < np.asarray(lens)[:, None]
    np.testing.assert_allclose(masked.numpy(), _jax(q, k, v, kv_valid=valid), **TOL)


def _prior_and_window():
    """Two windows of 12 rows (7 valid in the second) over 32 prior columns,
    all of them cached for the first row and 20 for the second."""
    P, S, plen, nlen = 32, 12, np.array([32, 20]), np.array([12, 7])
    q, k, v, kp, vp = _arrays(1, 2, S, P)
    got = prefill_attention.prefill_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), k_prior=torch.from_numpy(kp),
        v_prior=torch.from_numpy(vp), prior_len=torch.from_numpy(plen.astype(np.int32)),
        new_len=torch.from_numpy(nlen.astype(np.int32))).numpy()
    t = np.arange(S)[None, :]
    positions = plen[:, None] + t
    prior_pos = np.broadcast_to(np.arange(P)[None, :], (2, P))
    want = _jax(q, np.concatenate([kp, k], 1), np.concatenate([vp, v], 1),
                q_positions=positions, kv_positions=np.concatenate([prior_pos, positions], 1),
                kv_valid=np.concatenate([prior_pos < plen[:, None], t < nlen[:, None]], 1))
    np.testing.assert_allclose(got, want, **TOL)
    for b in range(2):  # each row over its visible columns alone
        p, n = int(plen[b]), int(nlen[b])
        alone = _jax(q[b:b + 1], np.concatenate([kp[b:b + 1, :p], k[b:b + 1, :n]], 1),
                     np.concatenate([vp[b:b + 1, :p], v[b:b + 1, :n]], 1),
                     q_positions=positions[b:b + 1],
                     kv_positions=np.concatenate([np.arange(p), p + np.arange(n)])[None])
        np.testing.assert_allclose(got[b:b + 1], alone, **TOL)


@pytest.mark.parametrize("form", [_whole_prompt_batched, _prior_and_window],
                         ids=["whole_prompt_batched", "prior_and_window"])
def test_cpu_path_matches_causal_attention_and_jax(form):
    form()


def _qkv_torch(D_=D, grad=None):
    q, k, v = (torch.from_numpy(a) for a in _arrays(2, 1, 8))
    if D_ != D:
        q, k, v = (torch.randn(*t.shape[:-1], D_) for t in (q, k, v))
    if grad is not None:
        (q, k, v)[grad].requires_grad_(True)
    return q, k, v


@pytest.mark.parametrize("case", ["grad_q", "grad_k_causal", "head_dim_20", "head_dim_256"])
def test_refusals(case):
    if case == "grad_q":
        q, k, v = _qkv_torch(grad=0)
        with pytest.raises(ValueError, match="no backward"):
            prefill_attention.prefill_attention(q, k, v)
        with torch.no_grad():  # inference on weights that train elsewhere is fine
            prefill_attention.prefill_attention(q, k, v)
    elif case == "grad_k_causal":
        with pytest.raises(ValueError, match="no backward"):
            prefill_attention.causal(*_qkv_torch(grad=1))
    else:
        q, k, v = _qkv_torch(D_=int(case.rsplit("_", 1)[1]))
        for fn in (prefill_attention.prefill_attention, prefill_attention.causal):
            with pytest.raises(ValueError, match="head_dim"):
                fn(q, k, v)


def test_engine_serving_forwards_attend_through_k3(monkeypatch):
    """Every window of a chunked prefill attends through K3 (the first with
    no prior part), and embeddings and the logits diagnostic hand K3 to
    ``forward``."""
    cfg = dataclasses.replace(configs.get_config("tiny"), dtype="float32")
    params = llama.init_params(cfg, "cpu", generator=torch.Generator().manual_seed(3))
    fns, windows = [], []
    forward, k3 = llama.forward, llama.prefill_attention

    def recording_forward(*a, **kw):
        fns.append(kw.get("attention_fn"))
        return forward(*a, **kw)

    def recording_k3(q, k, v, **kw):
        windows.append(0 if kw.get("k_prior") is None else kw["k_prior"].shape[1])
        return k3(q, k, v, **kw)

    monkeypatch.setattr(llama, "forward", recording_forward)
    monkeypatch.setattr(llama, "prefill_attention", recording_k3)
    engine = TorchEngine(EngineConfig(model="tiny", device="cpu", max_batch=2,
                                      max_model_len=128, decode_chunk=2, prefill_chunk=32,
                                      kv_events_port=0), params=params)

    async def body():
        await engine.start()
        try:
            out = engine.submit(EngineRequest(request_id="r", prompt_token_ids=list(range(1, 80)),
                                              max_tokens=2, temperature=0.0, ignore_eos=True))
            while (await asyncio.wait_for(out.get(), timeout=120)).finish_reason is None:
                pass
            await asyncio.to_thread(engine.embed, [5, 6, 7])
            await asyncio.to_thread(engine.last_logits, [5, 6, 7])
        finally:
            await engine.stop()

    asyncio.run(body())
    # Embed and logits (no warm-up here).
    assert len(fns) == 2 and all(f is prefill_attention.causal for f in fns), fns
    # The 79-token prompt's three windows: the first over no prior columns,
    # the others over the 32 and 64 tokens before them; one call per layer
    # each.
    L = cfg.n_layers
    assert windows == [0] * L + [32] * L + [64] * L, windows


def _never(*a, **kw):
    raise AssertionError("a training path reached the prefill kernel")


@pytest.mark.parametrize("path", ["train", "ring", "ulysses", "gpipe"])
def test_training_paths_keep_causal_attention(path, monkeypatch):
    """Training and its sequence- and pipeline-parallel forwards need
    autograd: they attend through ``causal_attention`` (forward's and
    run_stage's default, train.py's hook, Ulysses' per-group call) or ring
    attention, and never through K3."""
    for owner in (prefill_attention, llama):
        monkeypatch.setattr(owner, "prefill_attention", _never)
    monkeypatch.setattr(prefill_attention, "causal", _never)
    for fn in (llama.forward, llama.run_stage):
        assert inspect.signature(fn).parameters["attention_fn"].default \
            is attention.causal_attention
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return attention.causal_attention(*a, **kw)

    cfg = dataclasses.replace(configs.get_config("tiny"), dtype="float32", n_layers=2)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 16)).astype(np.int32))
    if path == "train":
        monkeypatch.setattr(train, "causal_attention", counted)
        layout = mesh.make_train_layout(["cpu"])
        state = train.make_train_state(cfg, layout, seed=4)
        assert np.isfinite(float(train.make_train_step(cfg, layout)(state, toks)))
        assert len(calls) == cfg.n_layers
        return
    if path == "gpipe":
        layout = pipeline.make_pp_layout(["cpu"] * 2)
        params = pipeline.shard_params_pp(
            llama.init_params(cfg, "cpu", generator=torch.Generator().manual_seed(4)),
            cfg, layout)
        assert torch.isfinite(pipeline.make_pp_forward(cfg, layout, 2)(params, toks)).all()
        return
    layout = mesh.make_train_layout(["cpu"] * 2, tp=1, sp=2)
    q, k, v = (torch.from_numpy(a) for a in _arrays(5, 2, 16))
    if path == "ulysses":
        monkeypatch.setattr(ulysses, "causal_attention", counted)
        out = ulysses.make_ulysses_attention_fn(layout)(q, k, v)
        assert calls
    else:
        out = ring_attention.make_ring_attention_fn(layout)(q, k, v)
    np.testing.assert_allclose(out.numpy(), attention.causal_attention(q, k, v).numpy(), **TOL)


# 1024-row windows over P prior columns, D 128, bf16: ms by the operations
# bound (4 * D per visible pair and q head at 989 TFLOP/s); 64/8 does twice
# 32/8's work, 16/4 half.
@pytest.mark.parametrize("H,Hkv,P,ms", [
    (32, 8, 0, 0.0087), (32, 8, 1024, 0.0261), (32, 8, 2048, 0.0434), (32, 8, 2976, 0.0592),
    (16, 4, 0, 0.0043), (16, 4, 1024, 0.0130), (16, 4, 2048, 0.0217), (16, 4, 2976, 0.0296),
    (64, 8, 0, 0.0174), (64, 8, 1024, 0.0521), (64, 8, 2048, 0.0869), (64, 8, 2976, 0.1184),
])
def test_phase_6b_bounds_at_the_cell_windows(H, Hkv, P, ms):
    import chip_smoke

    m = lambda *sh: torch.empty(*sh, dtype=torch.bfloat16, device="meta")
    case = dict(q=m(1, 1024, H, 128), k=m(1, 1024, Hkv, 128), v=m(1, 1024, Hkv, 128),
                k_prior=m(1, P, Hkv, 128) if P else None)
    bound_ms, bound_by, flops = chip_smoke.prefill_bound_ms(case)
    assert flops == 4 * 128 * H * (1024 * P + 1024 * 1025 // 2)
    assert bound_by == "operations"
    assert bound_ms == pytest.approx(ms, abs=5e-5)
