"""PyTorch port, HF checkpoints: ``models/convert_hf.py``, ``engine/checkpoint.py``
and the engine's directory discovery, against the JAX converter and
``transformers`` on the CPU (port analogues of ``tests/test_hf_convert.py``).

Tiny HF models are built in the test process and saved to ``tmp_path``;
nothing is downloaded.

- ``convert_state_dict`` equals the JAX converter's output array for array
  (Llama, tied embeddings, Mixtral, Qwen3; f32 and bf16);
- the port's forward on the converted weights matches ``transformers``
  logits after log-softmax within 2e-4;
- ``config_from_hf`` on a raw ``config.json`` with the class-default keys
  removed equals it on the ``AutoConfig``;
- the CLI's ``model_config.json`` gives the JAX CLI's ``ModelConfig``, and
  an engine on the CLI's directory gives HF ``generate``'s greedy tokens
  (Llama and Qwen3);
- an Orbax directory (the JAX CLI's), a directory without weights and
  weights of the wrong shape are refused;
- the package imports, converts and serves with ``jax``, the JAX package,
  ``safetensors``, ``transformers`` and ``tokenizers`` blocked.
"""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from llm_d_inference_scheduler_tpu.models import convert_hf as jax_convert
from llm_d_inference_scheduler_tpu.models.configs import ModelConfig as JaxModelConfig
from llm_d_inference_scheduler_tpu_torch.engine import checkpoint
from llm_d_inference_scheduler_tpu_torch.engine import server as server_mod
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest
from llm_d_inference_scheduler_tpu_torch.models import convert_hf, llama
from llm_d_inference_scheduler_tpu_torch.models.configs import ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _llama(seed=0, **kw):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    cfg = LlamaConfig(**{**dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5,
        rope_theta=10_000.0, max_position_embeddings=128, tie_word_embeddings=False,
        attention_bias=False, mlp_bias=False), **kw})
    return LlamaForCausalLM(cfg).eval().float(), cfg


def _tied(seed=1):
    return _llama(seed, vocab_size=128, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=1, num_attention_heads=2, rms_norm_eps=1e-6,
                  tie_word_embeddings=True)


def _mixtral(seed=2):
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(seed)
    cfg = MixtralConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        num_local_experts=4, num_experts_per_tok=2, rms_norm_eps=1e-5,
                        rope_theta=10_000.0, tie_word_embeddings=False)
    return MixtralForCausalLM(cfg).eval().float(), cfg


def _qwen3(seed=5, **kw):
    from transformers import Qwen3Config, Qwen3ForCausalLM

    torch.manual_seed(seed)
    cfg = Qwen3Config(**{**dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=24, rms_norm_eps=1e-6,
        rope_theta=10_000.0, max_position_embeddings=128, tie_word_embeddings=False,
        attention_bias=False), **kw})
    return Qwen3ForCausalLM(cfg).eval().float(), cfg


MODELS = {"llama": _llama, "tied": _tied, "mixtral": _mixtral, "qwen3": _qwen3}


def _state_dict(name, model):
    sd = model.state_dict()
    if name == "tied":  # a tied checkpoint carries no lm_head
        sd = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    return sd


def _as_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if str(a.dtype) == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_convert_state_dict_equals_jax(name, dtype):
    model, hf_cfg = MODELS[name]()
    sd = _state_dict(name, model)
    cfg = convert_hf.config_from_hf(hf_cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_convert.config_from_hf(hf_cfg))
    ours = llama.flat_params(convert_hf.convert_state_dict(sd, cfg, dtype, device="cpu"))
    ref = jax_convert.convert_state_dict(sd, jax_convert.config_from_hf(hf_cfg), dtype)
    ref = {"embed": ref["embed"], "final_norm": ref["final_norm"], "lm_head": ref["lm_head"],
           **{f"layers.{k}": v for k, v in ref["layers"].items()}}
    assert set(ours) == set(ref)
    for k in ref:
        assert str(ours[k].dtype).endswith(dtype), k
        np.testing.assert_array_equal(ours[k].float().numpy(), _as_np(ref[k]), err_msg=k)


def _lsm(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_transformers_logits(name):
    model, hf_cfg = MODELS[name]()
    cfg = convert_hf.config_from_hf(hf_cfg)
    params = convert_hf.convert_state_dict(_state_dict(name, model), cfg, "float32",
                                           device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 9))
    with torch.no_grad():
        ref = model(torch.tensor(tokens)).logits.float().numpy()
        ours, _ = llama.forward(params, cfg, torch.tensor(tokens))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(_lsm(ours.numpy()), _lsm(ref), atol=2e-4, rtol=0)


# Keys that each family's save_pretrained writes only when they differ from
# the class's defaults; dropping them must not change the config.
DROP = ["rope_theta", "max_position_embeddings", "rms_norm_eps", "num_key_value_heads",
        "head_dim", "num_local_experts", "num_experts_per_tok", "vocab_size",
        "intermediate_size", "num_hidden_layers", "num_attention_heads", "hidden_size"]


@pytest.mark.parametrize("family", ["llama", "mixtral", "qwen3"])
def test_config_json_without_default_keys_matches_autoconfig(tmp_path, family):
    from transformers import AutoConfig, LlamaConfig, MixtralConfig, Qwen3Config

    cls = {"llama": LlamaConfig, "mixtral": MixtralConfig, "qwen3": Qwen3Config}[family]
    cls().save_pretrained(tmp_path)  # the class's defaults: a full-size config
    doc = json.loads((tmp_path / "config.json").read_text())
    for k in DROP:
        doc.pop(k, None)
    (tmp_path / "config.json").write_text(json.dumps(doc))
    auto = AutoConfig.from_pretrained(tmp_path, local_files_only=True)
    assert convert_hf.config_from_hf(doc) == convert_hf.config_from_hf(auto)
    assert dataclasses.asdict(convert_hf.config_from_hf(auto)) == dataclasses.asdict(
        jax_convert.config_from_hf(auto))
    # The saved files of the tiny models of this module lack such keys too.
    model, hf_cfg = MODELS[family]()
    model.save_pretrained(tmp_path / "m", safe_serialization=True)
    saved = json.loads((tmp_path / "m" / "config.json").read_text())
    assert convert_hf.config_from_hf(saved) == convert_hf.config_from_hf(hf_cfg)


def _convert_both(tmp_path, model, name):
    """The HF directory, the port CLI's output and the JAX CLI's output."""
    src = tmp_path / f"{name}-hf"
    model.save_pretrained(src, safe_serialization=True)
    out = tmp_path / f"{name}-port"
    convert_hf.main([str(src), str(out), "--dtype", "float32", "--device", "cpu"])
    jax_out = tmp_path / f"{name}-orbax"
    jax_convert.main([str(src), str(jax_out), "--dtype", "float32"])
    return src, out, jax_out


def test_cli_writes_the_jax_clis_model_config_and_loads(tmp_path):
    model, hf_cfg = _llama(3, vocab_size=64, hidden_size=16, intermediate_size=32,
                           num_hidden_layers=1, num_attention_heads=2,
                           num_key_value_heads=1)
    src, out, jax_out = _convert_both(tmp_path, model, "llama")
    port_doc = json.loads((out / "model_config.json").read_text())
    jax_doc = json.loads((jax_out / "model_config.json").read_text())
    assert port_doc == jax_doc
    cfg = ModelConfig(**port_doc)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxModelConfig(**jax_doc))
    params = checkpoint.load_params(str(out), cfg, "cpu")
    ref = convert_hf.convert_state_dict(model.state_dict(), cfg, device="cpu")
    flat, want = llama.flat_params(params), llama.flat_params(ref)
    assert all(torch.equal(flat[k], want[k]) for k in want)
    assert params["embed"].shape == (64, 16)
    # A bf16 load casts on the way in.
    assert checkpoint.load_params(str(out), cfg, "cpu", "bfloat16")["lm_head"].dtype \
        == torch.bfloat16


def test_pytorch_bin_checkpoints_load(tmp_path):
    model, hf_cfg = _llama(4, num_hidden_layers=1)
    model.save_pretrained(tmp_path, safe_serialization=False)
    assert list(tmp_path.glob("pytorch_model*.bin"))
    sd = convert_hf.load_hf_state_dict(str(tmp_path))
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())


async def _greedy(engine, prompt, n):
    await engine.start()
    try:
        out = engine.submit(EngineRequest(request_id="hf", prompt_token_ids=prompt,
                                          max_tokens=n, temperature=0.0, ignore_eos=True))
        toks = []
        while True:
            ev = await asyncio.wait_for(out.get(), 120)
            if ev.token_id is not None:
                toks.append(ev.token_id)
            if ev.finish_reason is not None:
                return toks
    finally:
        await engine.stop()


@pytest.mark.parametrize("family", ["llama", "qwen3"])
def test_engine_on_the_converted_directory_matches_hf_generate(tmp_path, family):
    if family == "llama":
        model, _ = _llama(4, vocab_size=300, hidden_size=32, intermediate_size=64)
    else:
        model, _ = _qwen3(6, vocab_size=300, hidden_size=32, intermediate_size=64,
                          head_dim=16, tie_word_embeddings=True)
    src = tmp_path / "hf"
    model.save_pretrained(src, safe_serialization=True)
    out = tmp_path / "port"
    convert_hf.main([str(src), str(out), "--dtype", "float32", "--device", "cpu"])
    prompt, n = [5, 17, 42, 99, 7, 211], 6
    with torch.no_grad():
        ref = model.generate(torch.tensor([prompt]), max_new_tokens=n, do_sample=False,
                             pad_token_id=0)[0, len(prompt):].tolist()
    cfg = EngineConfig(model=str(out), device="cpu", max_batch=2, max_model_len=64,
                       decode_chunk=4, kv_events_port=0)
    assert cfg.checkpoint_path == ""  # found by the engine, not preset
    engine = TorchEngine(cfg)
    assert engine.cfg.checkpoint_path == str(out) and engine.dtype == torch.float32
    assert asyncio.run(_greedy(engine, prompt, n)) == ref


def test_checkpoint_flag_and_prefill_batch_parse(tmp_path):
    cfg, _ = server_mod.parse_config(["--model", "tiny", "--checkpoint", str(tmp_path),
                                      "--prefill-batch", "4", "--device", "cpu"])
    assert (cfg.checkpoint_path, cfg.prefill_batch, cfg.tokenizer) == (str(tmp_path), 4,
                                                                       "byte")
    for refused in ("--backend=tpu", "--platform=tpu", "--tokenizer=byte"):
        with pytest.raises(SystemExit):
            server_mod.parse_config([refused])
    # Tensor, expert and pipeline parallelism, the simulator, --platform and
    # multi-process serving are served since; the flags parse.
    cfg, _ = server_mod.parse_config(["--dist-coordinator=h:1", "--dist-num-processes=2",
                                      "--dist-process-id=1"])
    assert (cfg.dist_coordinator, cfg.dist_num_processes, cfg.dist_process_id) == ("h:1", 2, 1)
    cfg, _ = server_mod.parse_config(["--tp-size=2", "--ep-size=2"])
    assert (cfg.tp_size, cfg.ep_size) == (2, 2)
    cfg, _ = server_mod.parse_config(["--backend=sim", "--platform=cpu", "--pp-size=2"])
    assert (cfg.backend, cfg.device, cfg.pp_size) == ("sim", "cpu", 2)


def test_unreadable_directories_are_refused(tmp_path):
    model, _ = _llama(3, vocab_size=300, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1)
    _, out, jax_out = _convert_both(tmp_path, model, "llama")
    # The JAX CLI's Orbax directory (it has a model_config.json too).
    with pytest.raises(ValueError, match="Orbax.*convert_hf"):
        TorchEngine(EngineConfig(model=str(jax_out), device="cpu"))
    # A model_config.json and no weights.
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "model_config.json").write_text((out / "model_config.json").read_text())
    with pytest.raises(ValueError, match="no model.safetensors.*convert_hf"):
        TorchEngine(EngineConfig(model=str(bare), device="cpu"))
    # --checkpoint naming weights of another model's shapes.
    with pytest.raises(ValueError, match="embed is"):
        TorchEngine(EngineConfig(model="tiny", checkpoint_path=str(out), device="cpu",
                                 dtype="float32"))
    # The port's own directory serves.
    TorchEngine(EngineConfig(model=str(out), device="cpu", kv_events_port=0))


def test_package_runs_with_jax_and_the_hf_packages_blocked(tmp_path):
    """Import every module of the port (and chip_smoke) with jax, the JAX
    package, safetensors, transformers and tokenizers made unimportable,
    then convert an HF directory with the CLI and serve it on the CPU; an
    HF tokenizer asked for there raises ImportError."""
    model, _ = _llama(7, vocab_size=300, num_hidden_layers=1)
    src = tmp_path / "hf"
    model.save_pretrained(src, safe_serialization=True)
    code = r"""
import asyncio, importlib, pkgutil, sys
for name in ("jax", "llm_d_inference_scheduler_tpu", "safetensors", "transformers",
             "tokenizers"):
    sys.modules[name] = None   # import -> ImportError
import llm_d_inference_scheduler_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
from llm_d_inference_scheduler_tpu_torch.models import convert_hf
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
src, out = sys.argv[1], sys.argv[2]
convert_hf.main([src, out, "--dtype", "float32", "--device", "cpu"])
eng = TorchEngine(EngineConfig(model=out, device="cpu", kv_events_port=0))
assert eng.params["embed"].shape == (300, 64)
try:
    TorchEngine(EngineConfig(model=out, device="cpu", tokenizer="hf:" + src))
except ImportError as e:
    assert "tokenizers" in str(e), e
else:
    raise AssertionError("an HF tokenizer loaded without the tokenizers package")
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code, str(src), str(tmp_path / "out")],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
