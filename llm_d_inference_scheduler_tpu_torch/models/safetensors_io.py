"""Reader and writer of the safetensors file format, on ``mmap`` and torch.

The format (public, https://github.com/huggingface/safetensors): an 8-byte
little-endian header length N, N bytes of JSON mapping each tensor name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the data
that follows the header) plus an optional ``"__metadata__"`` of strings,
then the tensors' raw little-endian bytes, back to back.

The port keeps its own copy because the card's machine has neither the
``safetensors`` package nor ``transformers``, and the checkpoint loader
must run there. Reading maps the file copy-on-write: every tensor is a
``torch.frombuffer`` view of the mapping (BF16 and F16 included), so
loading a checkpoint copies nothing until a tensor is moved or cast, and
the pages stay file-backed. Writing streams one tensor at a time to the
host, so a model on the card is saved with one tensor's worth of host
memory. The reader refuses what the reference implementation refuses: a
header longer than the file, offsets that overlap, leave gaps or run past
the end, and byte counts that do not match the shape.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import sys
from typing import Iterable

import torch

__all__ = ["DTYPES", "read_header", "load_file", "save_file"]

# safetensors dtype names <-> torch dtypes.
DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}
MAX_HEADER = 100 << 20  # the reference implementation's bound

if sys.byteorder != "little":  # the format's bytes are little-endian
    raise ImportError("safetensors_io reads and writes on little-endian hosts only")


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def read_header(path: str) -> tuple[dict, dict[str, str], int]:
    """(tensor entries, ``__metadata__``, byte offset of the data) of a
    safetensors file, validated against the file's size."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER or 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the "
                             f"file's {size} bytes (truncated)")
        try:
            doc = json.loads(f.read(n))
        except ValueError as e:
            raise ValueError(f"{path}: header is not JSON: {e}") from None
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    meta = doc.pop("__metadata__", None) or {}
    data_size = size - 8 - n
    spans = []
    for name, ent in doc.items():
        try:
            dtype = DTYPES[ent["dtype"]]
            shape = [int(d) for d in ent["shape"]]
            begin, end = (int(o) for o in ent["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"{path}: bad header entry for {name!r}: {ent!r}") from None
        numel = 1
        for d in shape:
            if d < 0:
                raise ValueError(f"{path}: {name!r} has a negative dimension")
            numel *= d
        if not 0 <= begin <= end or end - begin != numel * _itemsize(dtype):
            raise ValueError(f"{path}: {name!r} spans [{begin}, {end}) for "
                             f"{numel} x {ent['dtype']}")
        spans.append((begin, end, name))
    pos = 0
    for begin, end, name in sorted(spans):
        if begin != pos:
            raise ValueError(f"{path}: {name!r} starts at {begin}, expected {pos} "
                             "(overlapping or gapped offsets)")
        pos = end
    if pos != data_size:
        raise ValueError(f"{path}: tensors cover {pos} of {data_size} data bytes "
                         "(truncated or trailing bytes)")
    return doc, meta, 8 + n


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file as a CPU view of a copy-on-write
    mapping of the file (writing to a tensor never touches the file)."""
    entries, _, start = read_header(path)
    if not entries:
        return {}
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, ent in entries.items():
        dtype = DTYPES[ent["dtype"]]
        begin, end = ent["data_offsets"]
        shape = [int(d) for d in ent["shape"]]
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        offset = start + begin
        buf = mm
        if offset % _itemsize(dtype):  # a view must be aligned to its items
            buf, offset = bytearray(mm[offset:start + end]), 0
        out[name] = torch.frombuffer(buf, dtype=dtype, count=(end - begin) // _itemsize(dtype),
                                     offset=offset).reshape(shape)
    return out


def save_file(tensors: dict[str, torch.Tensor] | Iterable[tuple[str, torch.Tensor]],
              path: str, metadata: dict[str, str] | None = None) -> int:
    """Write ``tensors`` (on any device) as a safetensors file, in the given
    order, each copied to the host on its own; returns the bytes written.
    The header is padded with spaces to a multiple of 8 bytes, as the
    reference writer pads it, so every tensor starts 8-byte aligned when
    the tensors are ordered by falling item size."""
    items = list(tensors.items() if isinstance(tensors, dict) else tensors)
    header: dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    pos = 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [pos, pos + n]}
        pos += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            host = t.detach().to("cpu").contiguous()
            if host.numel():
                f.write(memoryview(host.reshape(-1).view(torch.uint8).numpy()))
            del host
    return 8 + len(raw) + pos
