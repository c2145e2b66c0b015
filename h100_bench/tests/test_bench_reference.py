"""The plain reference against the port on the CPU at toy sizes: the
port's full forward, and a tiny engine served end to end."""

import json
from pathlib import Path

import pytest
import torch

from h100_bench import spec as spec_mod
from h100_bench import weights
from h100_bench.reference.model import Arch, logits_at

DATA = Path(__file__).resolve().parent / "data"


@pytest.mark.parametrize("name", ["tiny-qwen", "tiny-moe"])
def test_reference_matches_the_port_forward(name):
    from llm_d_inference_scheduler_tpu_torch.models import llama

    config = json.loads((DATA / "configs" / f"{name}.json").read_text())
    mcfg = spec_mod.model_config(config)
    params = weights.draw(mcfg, 2**32 + 17, "cpu", torch.float32)
    tokens = torch.randint(3, mcfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    port, _ = llama.forward(params, mcfg, tokens)
    ref = logits_at(params, Arch.from_config(config), tokens.tolist(),
                    [list(range(40))] * 2, device="cpu")
    for b in range(2):
        assert torch.allclose(ref[b], port[b], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fault", ["q_norm<->k_norm", "ln_attn<->ln_mlp", "final_norm=1"])
def test_the_norm_weights_show_in_the_logits(fault):
    """Each norm weight is drawn from the seed, so a norm whose multiply is
    left out, or one read in another's place, moves the logits."""
    from llm_d_inference_scheduler_tpu_torch.models import llama

    config = json.loads((DATA / "configs" / "tiny-qwen.json").read_text())
    mcfg = spec_mod.model_config(config)
    params = weights.draw(mcfg, 2**33 + 5, "cpu", torch.float32)
    tokens = torch.randint(3, mcfg.vocab_size, (1, 24), generator=torch.Generator().manual_seed(2))
    port, _ = llama.forward(params, mcfg, tokens)
    bad = {**params, "layers": dict(params["layers"])}
    if fault == "final_norm=1":
        bad["final_norm"] = torch.ones_like(params["final_norm"])
    else:
        a, b = fault.split("<->")
        bad["layers"][a], bad["layers"][b] = params["layers"][b], params["layers"][a]
    ref = logits_at(bad, Arch.from_config(config), tokens.tolist(), [list(range(24))],
                    device="cpu")
    assert (ref[0] - port[0]).abs().max() > 1e-2


@pytest.mark.parametrize("cell", ["tiny-moe.tinychat", "tiny-qwen.tinylong"])
def test_served_tokens_match_the_reference(spec, cell):
    from h100_bench import run

    res = run.run_cell(spec, cell, 2**31 + 99, 1.5, False, device="cpu")
    ch = res["checks"]
    assert res["correct"], ch
    assert ch["max_logit_gap"]["value"] <= 1e-4
    assert ch["tokens_compared"]["value"] >= ch["tokens_compared"]["limit"]
