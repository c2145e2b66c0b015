"""PyTorch port, ``models/safetensors_io.py`` against the ``safetensors``
package on the CPU: the port's reader reads what ``save_file`` and
``save_pretrained`` write, the package reads what the port's writer writes,
bitwise, for F32, BF16, F16 and I64 (and the format's other types), and a
truncated or overlapping header is refused."""

import json
import struct

import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as ref_save

from llm_d_inference_scheduler_tpu_torch.models import safetensors_io as st


def _tensors(seed: int = 0) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(7, 2, generator=g).bfloat16(),
        "f16": torch.randn(4, 4, 3, generator=g).half(),
        "i64": torch.randint(-2**40, 2**40, (6,), generator=g),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 3),
        "i32": torch.arange(5, dtype=torch.int32),
        "u8": torch.arange(9, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "f64": torch.randn(2, generator=g).double(),
    }


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and _bits(a) == _bits(b)


def test_reader_reads_the_packages_files(tmp_path):
    t = _tensors()
    ref_save(t, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got = st.load_file(str(tmp_path / "a.safetensors"))
    assert set(got) == set(t) and all(_same(got[k], t[k]) for k in t)
    _, meta, _ = st.read_header(str(tmp_path / "a.safetensors"))
    assert meta == {"format": "pt"}


def test_reader_reads_save_pretrained(tmp_path):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, tie_word_embeddings=False))
    model = model.to(torch.bfloat16)
    model.save_pretrained(tmp_path, safe_serialization=True)
    got = st.load_file(str(tmp_path / "model.safetensors"))
    sd = model.state_dict()
    assert set(got) == set(sd)
    assert all(_same(got[k], sd[k]) for k in sd)
    assert got["model.embed_tokens.weight"].dtype == torch.bfloat16


def test_package_reads_the_writers_files(tmp_path):
    t = _tensors(1)
    path = str(tmp_path / "b.safetensors")
    n = st.save_file(t, path, metadata={"format": "pt", "source": "port"})
    assert n == (tmp_path / "b.safetensors").stat().st_size
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt", "source": "port"}
        assert set(f.keys()) == set(t)
        for k in t:
            assert _same(f.get_tensor(k), t[k]), k
    # And the port's reader round-trips its own writer.
    got = st.load_file(path)
    assert all(_same(got[k], t[k]) for k in t)


def test_writer_takes_views_and_pairs(tmp_path):
    """Non-contiguous tensors are written as their values; an iterable of
    (name, tensor) pairs keeps its order."""
    base = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    path = str(tmp_path / "c.safetensors")
    st.save_file([("t", base.t()), ("a", base[:, 1])], path)
    entries, _, _ = st.read_header(path)
    assert list(entries) == ["t", "a"]
    got = st.load_file(path)
    assert torch.equal(got["t"], base.t()) and torch.equal(got["a"], base[:, 1])


def test_mapped_tensors_are_copy_on_write(tmp_path):
    path = str(tmp_path / "d.safetensors")
    st.save_file({"x": torch.ones(4)}, path)
    got = st.load_file(path)
    got["x"].mul_(3)
    assert torch.equal(st.load_file(path)["x"], torch.ones(4))


def _write_raw(path, header: dict, data: bytes, n_override: int | None = None):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n_override if n_override is not None else len(raw)))
        f.write(raw)
        f.write(data)


@pytest.mark.parametrize("case", ["truncated_header", "truncated_data", "overlap",
                                  "gap", "wrong_size", "trailing", "tiny_file"])
def test_bad_files_are_refused(tmp_path, case):
    path = str(tmp_path / "bad.safetensors")
    f32 = {"dtype": "F32", "shape": [2]}
    if case == "tiny_file":
        (tmp_path / "bad.safetensors").write_bytes(b"\x01\x02")
    elif case == "truncated_header":
        _write_raw(path, {"a": {**f32, "data_offsets": [0, 8]}}, b"\0" * 8,
                   n_override=10_000)
    elif case == "truncated_data":
        _write_raw(path, {"a": {**f32, "data_offsets": [0, 8]}}, b"\0" * 5)
    elif case == "overlap":
        _write_raw(path, {"a": {**f32, "data_offsets": [0, 8]},
                          "b": {**f32, "data_offsets": [4, 12]}}, b"\0" * 12)
    elif case == "gap":
        _write_raw(path, {"a": {**f32, "data_offsets": [0, 8]},
                          "b": {**f32, "data_offsets": [12, 20]}}, b"\0" * 20)
    elif case == "wrong_size":
        _write_raw(path, {"a": {**f32, "data_offsets": [0, 12]}}, b"\0" * 12)
    elif case == "trailing":
        _write_raw(path, {"a": {**f32, "data_offsets": [0, 8]}}, b"\0" * 16)
    with pytest.raises(ValueError):
        st.load_file(path)
    # The package refuses the same files.
    with pytest.raises(Exception):
        with safe_open(path, framework="pt") as f:
            for k in f.keys():
                f.get_tensor(k)
