"""PyTorch port, ``engine/tokenizer.py``: the HF tokenizer (read through
``tokenizers``, not ``transformers``) against the JAX package's
``HFTokenizer`` (``AutoTokenizer``) on tiny byte-level BPEs trained in the
test process, as ``tests/test_hf_convert.py`` builds them: ids with and
without BOS, the BOS/EOS/PAD ids, ``vocab_size`` with added tokens, decode
token by token and whole (special tokens skipped, the clean-up of
tokenization spaces where the config asks for it), the ``hf:``, directory
and ``tokenizer.json`` forms, the vocab check, and an engine serving with
it."""

import asyncio
import json
import threading
import urllib.request

import pytest

from llm_d_inference_scheduler_tpu.engine.tokenizer import HFTokenizer as JaxHFTokenizer
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.server import EngineServer
from llm_d_inference_scheduler_tpu_torch.engine.tokenizer import HFTokenizer, get_tokenizer

CORPUS = ["hello world", "hello there", "the quick brown fox", "don't stop , now !",
          "it's a test . isn't it ?", "unicode: café 日本"]
TEXTS = ["hello world", "the quick brown fox jumps", "don't stop , now !",
         "it's here . we're done ?", "café 日本 \U0001f600", ""]

# Special-token layouts of the saved tokenizer.
SPECIALS = {
    "bos_eos": dict(bos_token="<s>", eos_token="</s>"),
    "pad": dict(bos_token="<s>", eos_token="</s>", pad_token="<pad>"),
    "no_bos_cleanup": dict(eos_token="</s>", clean_up_tokenization_spaces=True),
    "extra_special": dict(bos_token="<s>", eos_token="</s>",
                          additional_special_tokens=["<img>"]),
}


def _save(tmp_path, case: str) -> str:
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers.trainers import BpeTrainer
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    specials = ["<s>", "</s>"] + (["<pad>"] if case == "pad" else [])
    trainer = BpeTrainer(vocab_size=300, special_tokens=specials,
                         initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS, trainer)
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, **SPECIALS[case])
    d = tmp_path / case
    fast.save_pretrained(d)
    return str(d)


@pytest.mark.parametrize("case", sorted(SPECIALS))
def test_hf_tokenizer_equals_jax(tmp_path, case):
    d = _save(tmp_path, case)
    ours, ref = HFTokenizer(d), JaxHFTokenizer(d)
    assert (ours.bos_id, ours.eos_id, ours.pad_id, ours.vocab_size) == \
        (ref.bos_id, ref.eos_id, ref.pad_id, ref.vocab_size)
    for text in TEXTS:
        for add_bos in (True, False):
            ids = ours.encode(text, add_bos=add_bos)
            assert ids == ref.encode(text, add_bos=add_bos), (text, add_bos)
        assert ours.decode(ids) == ref.decode(ids)
        assert [ours.decode([i]) for i in ids] == [ref.decode([i]) for i in ids]
    # Specials among the ids are skipped, as AutoTokenizer skips them.
    specials = [i for i in (ours.bos_id, ours.eos_id, ours.pad_id) if i is not None]
    mixed = specials + ours.encode("hello there", add_bos=False) + specials
    assert ours.decode(mixed) == ref.decode(mixed)
    if case == "extra_special":
        img = ours._tok.token_to_id("<img>")
        assert ours.decode([img, *mixed]) == ref.decode([img, *mixed])


def test_get_tokenizer_forms_and_vocab_check(tmp_path):
    d = _save(tmp_path, "bos_eos")
    for name in (f"hf:{d}", d, f"{d}/tokenizer.json"):
        t = get_tokenizer(name, vocab_size=1024)
        assert isinstance(t, HFTokenizer) and t.decode(t.encode("hello world")) == "hello world"
    with pytest.raises(ValueError, match="exceeds model vocab"):
        get_tokenizer(f"hf:{d}", vocab_size=10)
    with pytest.raises(ValueError, match="unknown tokenizer"):
        get_tokenizer("sentencepiece", vocab_size=1024)
    assert get_tokenizer("byte", 512).decode(get_tokenizer("byte", 512).encode("hi")) == "hi"


def test_engine_serves_with_the_hf_tokenizer(tmp_path):
    """The server's render is the JAX tokenizer's encoding, and a completion
    decodes its tokens with the HF vocab (EOS ends it)."""
    d = _save(tmp_path, "bos_eos")
    ref = JaxHFTokenizer(d)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    srv = EngineServer(EngineConfig(model="tiny", device="cpu", port=0, kv_events_port=0,
                                    max_model_len=128, tokenizer=f"hf:{d}"))
    asyncio.run_coroutine_threadsafe(srv.start(), loop).result(60)
    try:
        def post(path, body):
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                         data=json.dumps(body).encode(),
                                         headers={"content-type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        doc = post("/v1/completions/render", {"prompt": "the quick brown fox"})
        assert doc["token_ids"] == ref.encode("the quick brown fox")
        out = post("/v1/completions", {"prompt": "hello", "max_tokens": 8, "temperature": 0})
        assert out["usage"]["prompt_tokens"] == len(ref.encode("hello"))
        assert srv.engine.tokenizer.eos_id == ref.eos_id
    finally:
        asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
