"""Faults planted in the timed path, underneath a run whose look for a card
is skipped: each has to turn ``correct`` false. The served model has three
of the faults a cell can have (one card: no exchange between chips)."""

import pytest

from h100_bench import run


def _state_unchanged(monkeypatch):
    """Every decode step leaves the KV pages as it found them."""
    from llm_d_inference_scheduler_tpu_torch.models import llama

    orig = llama.decode_step

    def step(params, cfg, tokens, positions, k_pages, v_pages, *a, **kw):
        k0, v0 = k_pages.clone(), v_pages.clone()
        out = orig(params, cfg, tokens, positions, k_pages, v_pages, *a, **kw)
        k_pages.copy_(k0)
        v_pages.copy_(v0)
        return out

    monkeypatch.setattr(llama, "decode_step", step)


def _half_batch(monkeypatch):
    """The upper half of every decode step's lanes is never computed."""
    from llm_d_inference_scheduler_tpu_torch.models import llama

    orig = llama.decode_step

    def step(*a, **kw):
        logits, k, v = orig(*a, **kw)
        logits = logits.clone()
        logits[(logits.shape[0] + 1) // 2:] = 0
        return logits, k, v

    monkeypatch.setattr(llama, "decode_step", step)


def _token_altered(monkeypatch):
    """The sampler's token of the first lane is off by one."""
    from llm_d_inference_scheduler_tpu_torch.engine import core

    orig = core.sample_tokens

    def sample(logits, gen, knobs):
        tok = orig(logits, gen, knobs).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok

    monkeypatch.setattr(core, "sample_tokens", sample)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered])
def test_a_planted_fault_is_not_correct(spec, monkeypatch, fault):
    fault(monkeypatch)
    res = run.run_cell(spec, "tiny-moe.tinychat", 2**31 + 5, 1.5, False, device="cpu")
    assert not res["correct"]
    assert res["checks"]["max_logit_gap"]["value"] > res["checks"]["max_logit_gap"]["limit"]
