"""Paged decode attention: wrapper of the hand-written CUDA kernel K1.

Replaces the TPU kernel ``paged_decode_attention_pallas``
(``llm_d_inference_scheduler_tpu/ops/pallas_paged_attention.py:139``). The
kernel (``csrc/paged_decode_attention.cu``) is bound by the bytes of K and V
it must read — ``2 * sum(seq_len - 1) * Hkv * D * itemsize`` per call, 2.8 us
on an H100 at the serving phase's decode shape — and reads only the pages a
row's ``seq_len`` needs, walking the row's block table itself (the gather
version reads ``max_blocks * block`` rows whatever the length). One launch:
each row's positions are shared, on the device and by its length, among up
to ``S`` CTAs (flash-decoding), and the last CTA of a row to finish merges
the partials. bf16 runs its QK and PV products on the tensor cores
(``mma.sync``), f32 on CUDA cores. This wrapper picks ``S`` from shapes and
allocates the f32 workspace; a per-device ticket buffer, zeroed once and
left zero by every launch, tells a row's CTAs which one finishes last (so
calls are serialised on one stream, as the engine makes them; two tp ranks
laid on one device launch in turn on its current stream, so they share the
buffer safely). Design and
what is left are in the source's header.

On a CPU tensor the wrapper computes the plain version
(``ops/attention.py:paged_decode_attention``); on a CUDA tensor it launches
the kernel or raises — there is no fallback. ``launches`` counts kernel
launches only.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import paged_decode_attention

KERNEL = "paged_decode_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64            # split granularity, positions (kChunk in the source)
MIN_SPLIT = 64       # fewest positions worth a CTA of their own

launches = 0
_fn = None
_sm_count: dict[int, int] = {}
_tickets: dict[int, torch.Tensor] = {}


def splits(B: int, Hkv: int, cap: int, n_sm: int) -> tuple[int, int]:
    """(S, split_len): at most S CTAs per (row, KV head), each taking at most
    split_len positions (a multiple of TILE), so that the Hkv * B * S CTAs
    cover the SMs about four times and S * split_len covers ``cap`` =
    max_blocks * block. Decided from shapes alone: no device sync. The
    kernel shares each row's cached positions among its S CTAs by the row's
    length, in whole tiles of at least MIN_SPLIT positions, so a short row
    keeps most of its CTAs idle."""
    want = max(1, -(-4 * n_sm // max(Hkv * B, 1)))
    S = max(1, min(want, -(-cap // MIN_SPLIT)))
    split_len = -(-(-(-cap // S)) // TILE) * TILE
    return -(-cap // split_len), split_len


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(KERNEL).paged_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k_pages, v_pages, block_tables, seq_lens, cur_k, cur_v) -> None:
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "seq_lens": seq_lens,
               "cur_k": cur_k, "cur_v": cur_v}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the kernel takes "
                             "row-major layouts; pages are never copied)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q dtype {q.dtype} unsupported; have float32, bfloat16")
    for name in ("k_pages", "v_pages", "cur_k", "cur_v"):
        if tensors[name].dtype != q.dtype:
            raise ValueError(f"{name} dtype {tensors[name].dtype} != q dtype {q.dtype}")
    for name in ("block_tables", "seq_lens"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be [B, H, D] and pages [N, block, Hkv, D]")
    B, H, D = q.shape
    _, block, Hkv, Dp = k_pages.shape
    if v_pages.shape != k_pages.shape or Dp != D:
        raise ValueError(f"page shapes {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if H % Hkv or H // Hkv > 32:
        raise ValueError(f"H={H} must be a multiple of Hkv={Hkv}, at most 32 per KV head")
    if D % 16 or D > 256:
        raise ValueError(f"head_dim {D} must be a multiple of 16 up to 256")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be [B={B}, max_blocks]")
    if seq_lens.shape != (B,):
        raise ValueError(f"seq_lens must be [B={B}]")
    if cur_k.shape != (B, Hkv, D) or cur_v.shape != (B, Hkv, D):
        raise ValueError(f"cur_k/cur_v must be [B, Hkv, D] = {(B, Hkv, D)}")


def paged_decode_attention_cuda(
    q: torch.Tensor,             # [B, H, D]
    k_pages: torch.Tensor,       # [N, block, Hkv, D] one layer's pages
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    seq_lens: torch.Tensor,      # [B] int32 (incl. current token)
    cur_k: torch.Tensor,         # [B, Hkv, D]
    cur_v: torch.Tensor,
) -> torch.Tensor:
    """Decode attention over paged KV with the current token's column;
    returns [B, H, D] in q's dtype (the JAX kernel's signature, without
    ``interpret``)."""
    if q.device.type == "cpu":
        return paged_decode_attention(q, k_pages, v_pages, block_tables,
                                      seq_lens, cur_k=cur_k, cur_v=cur_v)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_cuda: unsupported device {q.device}")
    _check(q, k_pages, v_pages, block_tables, seq_lens, cur_k, cur_v)
    B, H, D = q.shape
    _, block, Hkv, _ = k_pages.shape
    max_blocks = block_tables.shape[1]
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    S, split_len = splits(B, Hkv, max_blocks * block, _sm_count[dev])
    out = torch.empty_like(q)
    part_acc = torch.empty((B, H, S, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, H, S, 2), dtype=torch.float32, device=q.device)
    tickets = _tickets.get(dev)
    if tickets is None or tickets.numel() < B * Hkv:
        tickets = _tickets[dev] = torch.zeros(max(B * Hkv, 256), dtype=torch.int32,
                                              device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), seq_lens.data_ptr(), cur_k.data_ptr(),
                cur_v.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                part_ml.data_ptr(), tickets.data_ptr(), B, H, Hkv, D, block,
                max_blocks, S, split_len, _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {rc}")
    global launches
    launches += 1
    return out
