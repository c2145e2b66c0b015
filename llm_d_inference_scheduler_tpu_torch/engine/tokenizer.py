"""Tokenizers of the engine (port of
``llm_d_inference_scheduler_tpu/engine/tokenizer.py``).

``ByteTokenizer`` (the default) maps raw UTF-8 bytes past three specials, so
it round-trips any text and needs no vocab files. ``HFTokenizer`` serves a
real checkpoint's HuggingFace fast tokenizer (``tokenizer.json`` and its
configs) through the ``tokenizers`` package, not ``transformers``, with what
``AutoTokenizer`` gives: BOS, EOS and PAD from ``tokenizer_config.json`` and
``special_tokens_map.json``, a vocab size that counts added tokens, decode
that skips special tokens (and cleans up tokenization spaces where the
config asks). Select it with ``EngineConfig.tokenizer = "hf:<dir>"``. A
machine without ``tokenizers`` raises ``ImportError`` when one is asked
for; it never falls back to bytes.
"""

from __future__ import annotations

import json
import os


class ByteTokenizer:
    PAD = 0
    BOS = 1
    EOS = 2
    _OFFSET = 3

    def __init__(self, vocab_size: int = 512):
        assert vocab_size >= self._OFFSET + 256, "vocab must fit all bytes"
        self.vocab_size = vocab_size
        self.eos_id = self.EOS
        self.pad_id = self.PAD
        self.bos_id = self.BOS

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [self._OFFSET + b for b in text.encode("utf-8")]
        return [self.BOS] + ids if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        # Ids past the byte range (possible under random-weight sampling) wrap
        # modulo 256 so decode is total; true text ids round-trip unchanged.
        data = bytes((i - self._OFFSET) % 256 for i in ids if i >= self._OFFSET)
        return data.decode("utf-8", errors="replace")


# transformers' clean_up_tokenization: spaces before punctuation and
# English contractions.
_CLEANUPS = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
             (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
             (" 're", "'re"))


def _read_json(path: str) -> dict:
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        doc = json.load(f)
    return doc if isinstance(doc, dict) else {}


class HFTokenizer:
    """An HF fast tokenizer directory (``tokenizer.json`` +
    ``tokenizer_config.json``), read locally. Per-token ``decode([id])``
    streams byte-level pieces; a token ending mid UTF-8 sequence decodes
    with replacement characters, a whole-sequence decode round-trips."""

    def __init__(self, path: str):
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise ImportError(
                f"tokenizer {path!r} is an HF tokenizer, which needs the "
                "`tokenizers` package; it is not installed here (serve with "
                "the byte tokenizer, or install it)") from e
        self._tok = Tokenizer.from_file(os.path.join(path, "tokenizer.json"))
        # transformers encodes without the file's truncation or padding.
        self._tok.no_truncation()
        self._tok.no_padding()
        tcfg = _read_json(os.path.join(path, "tokenizer_config.json"))
        smap = _read_json(os.path.join(path, "special_tokens_map.json"))
        self.vocab_size = self._tok.get_vocab_size(with_added_tokens=True)
        self.bos_id, self.eos_id, self.pad_id = (
            self._special_id(tcfg.get(k, smap.get(k)))
            for k in ("bos_token", "eos_token", "pad_token"))
        if self.eos_id is None:
            raise ValueError(f"tokenizer at {path} defines no EOS token")
        if self.pad_id is None:
            self.pad_id = self.eos_id
        self._cleanup = bool(tcfg.get("clean_up_tokenization_spaces", False))

    def _special_id(self, token) -> int | None:
        if isinstance(token, dict):  # an AddedToken's serialised form
            token = token.get("content")
        return self._tok.token_to_id(token) if isinstance(token, str) else None

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_bos and self.bos_id is not None:
            return [self.bos_id] + ids
        return ids

    def decode(self, ids: list[int]) -> str:
        text = self._tok.decode(list(ids), skip_special_tokens=True)
        if self._cleanup:
            for a, b in _CLEANUPS:
                text = text.replace(a, b)
        return text


def get_tokenizer(name: str, vocab_size: int):
    """``"byte"``, or an HF tokenizer as ``hf:<dir>``, a directory or a
    ``tokenizer.json`` path; its vocab must fit the model's."""
    if name == "byte":
        return ByteTokenizer(vocab_size)
    if name.startswith("hf:"):
        name = name[3:]
    if os.path.isdir(name) or name.endswith("tokenizer.json"):
        if name.endswith("tokenizer.json"):
            name = os.path.dirname(name) or "."
        tok = HFTokenizer(name)
        if tok.vocab_size > vocab_size:
            raise ValueError(
                f"tokenizer vocab ({tok.vocab_size}) exceeds model vocab "
                f"({vocab_size})")
        return tok
    raise ValueError(f"unknown tokenizer {name!r}")
