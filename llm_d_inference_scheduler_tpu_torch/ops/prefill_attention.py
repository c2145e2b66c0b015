"""Serving prefill attention: wrapper of the hand-written CUDA kernel K3.

Replaces no TPU kernel: the JAX package computes prefill attention as plain
XLA einsums (``llm_d_inference_scheduler_tpu/ops/attention.py:
causal_attention``), whose eager port (``ops/attention.py``) ran f32 GEMMs
on CUDA cores, a mask pass and a softmax over f32 logits. The kernel
(``csrc/prefill_attention.cu``) computes the masked attention the serving
callers ask for in one launch: q [B, S, H, D] over an optional prior part
of the K/V columns [B, P, Hkv, D] (a cached prefix) followed by the new part
[B, S, Hkv, D]. Prior column j is visible to every row where
j < ``prior_len[b]``; new column t to row i where t <= i and
t < ``new_len[b]``; both lengths are device int32 [B] tensors, so a call
makes no host sync. It is bound by operations on an H100 (Q, K, V and O
are about 32 MB a layer at the serving shapes against about 43 GFLOP of
visible products). bf16 runs warp-specialised ``wgmma`` fed by TMA, f32
CUDA-core FMA; ``path_launches`` counts each launch under the path it took
(``wgmma`` or ``simt``). Design and what is left are in the source's header.

On a CPU tensor the wrapper computes the plain version
(``prefill_attention_reference``, the masks handed to
``attention.causal_attention``); on a CUDA tensor it launches the kernel or
raises: there is no fallback. It has no backward, so an input that requires
grad is refused on every device: training keeps ``causal_attention``.
``launches`` counts kernel launches only.

Its serving caller is ``llama.prefill`` (every prompt window, with or
without a prior part). ``causal`` is the kernel behind
``causal_attention``'s signature, the ``attention_fn`` the engine hands
``llama.forward`` for its embeddings and logits (no prior part).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import causal_attention

KERNEL = "prefill_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128

launches = 0
path_launches = {"wgmma": 0, "simt": 0}
_fn = None


def kernel_path(dtype: torch.dtype) -> str:
    """The kernel path a call takes: f32 on CUDA cores, bf16 on wgmma."""
    return "simt" if dtype == torch.float32 else "wgmma"


def reset_launches() -> None:
    global launches
    launches = 0
    for k in path_launches:
        path_launches[k] = 0


def check_head_dim(D: int) -> None:
    """The kernel takes head dims that are multiples of 8 up to 128 (TMA
    rows are 16-byte multiples; the kernel pads D to 64 or 128)."""
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"prefill_attention: head_dim {D} unsupported; the kernel "
                         f"takes multiples of 8 up to {MAX_HEAD_DIM}")


def _refuse_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise ValueError("prefill_attention has no backward: an input requires grad "
                         "(training attends through causal_attention)")


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(KERNEL).prefill_attention
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def prefill_attention_reference(q, k, v, k_prior=None, v_prior=None,
                                prior_len=None, new_len=None) -> torch.Tensor:
    """The plain version: the prior and new columns concatenated, with the
    positions and validity mask that give ``causal_attention`` the same
    visibility (rows at prior_len + i, prior columns at j, new ones at
    prior_len + t)."""
    B, S = q.shape[:2]
    dev = q.device
    t = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    if k_prior is None:
        if new_len is None:
            return causal_attention(q, k, v)
        return causal_attention(q, k, v, kv_valid=(t < new_len.to(dev)[:, None]).expand(B, S))
    P = k_prior.shape[1]
    base = (torch.full((B,), P, dtype=torch.int32, device=dev) if prior_len is None
            else prior_len.to(dev, torch.int32))
    positions = base[:, None] + t
    prior_pos = torch.arange(P, dtype=torch.int32, device=dev)[None, :].expand(B, P)
    new_valid = (t < (S if new_len is None else new_len.to(dev)[:, None])).expand(B, S)
    return causal_attention(q, torch.cat([k_prior, k], dim=1), torch.cat([v_prior, v], dim=1),
                            q_positions=positions,
                            kv_positions=torch.cat([prior_pos, positions], dim=1),
                            kv_valid=torch.cat([prior_pos < base[:, None], new_valid], dim=1))


def _check(q, k, v, k_prior, v_prior, prior_len, new_len) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q dtype {q.dtype} unsupported; have float32, bfloat16")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be [B, S, H, D] and k, v [B, S, Hkv, D]")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"H={H} must be a multiple of Hkv={Hkv}")
    if (k_prior is None) != (v_prior is None):
        raise ValueError("k_prior and v_prior come together")
    if k_prior is not None:
        P = k_prior.shape[1]
        if k_prior.shape != (B, P, Hkv, D) or v_prior.shape != k_prior.shape:
            raise ValueError(f"k_prior {tuple(k_prior.shape)} and v_prior "
                             f"{tuple(v_prior.shape)} must be [B, P, Hkv, D]")
    tensors = {"q": q, "k": k, "v": v, "k_prior": k_prior, "v_prior": v_prior}
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("prior_len", prior_len), ("new_len", new_len)):
        if t is None:
            continue
        if t.device != q.device or t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(f"{name} must be int32 [B={B}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      k_prior: torch.Tensor | None = None,
                      v_prior: torch.Tensor | None = None,
                      prior_len: torch.Tensor | None = None,
                      new_len: torch.Tensor | None = None) -> torch.Tensor:
    """Attention of a window's rows q [B, S, H, D] over the prior columns
    ``k_prior``/``v_prior`` [B, P, Hkv, D] (those before ``prior_len``, all
    without it) and the window's own k/v [B, S, Hkv, D] (causal, those
    before ``new_len``, all without it); returns [B, S, H, D] in q's
    dtype."""
    _refuse_grad(q, k, v, k_prior, v_prior)
    check_head_dim(q.shape[-1])
    if q.device.type == "cpu":
        return prefill_attention_reference(q, k, v, k_prior, v_prior, prior_len, new_len)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: unsupported device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if k_prior is not None:
        k_prior, v_prior = k_prior.contiguous(), v_prior.contiguous()
    _check(q, k, v, k_prior, v_prior, prior_len, new_len)
    B, S, H, D = q.shape
    P = 0 if k_prior is None else k_prior.shape[1]
    out = torch.empty_like(q)
    prior = ((k_prior.data_ptr(), v_prior.data_ptr(),
              None if prior_len is None else prior_len.data_ptr()) if P else (None,) * 3)
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), prior[0], prior[1], out.data_ptr(),
                prior[2], None if new_len is None else new_len.data_ptr(), B, S, P, H,
                k.shape[2], D, _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"prefill_attention kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    path_launches[kernel_path(q.dtype)] += 1
    return out


def causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_positions: torch.Tensor | None = None,
           kv_positions: torch.Tensor | None = None,
           kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """K3 behind ``causal_attention``'s signature (``llama.forward``'s
    ``attention_fn``): q, k, v of one sequence's rows, causal by index. The
    kernel takes rows and columns at the same positions (``run_stage``
    passes one tensor for both), which must increase along the sequence, as
    forward's default positions do; a padding mask is refused on CUDA
    (serving pads at the end, which causality hides). On a CPU tensor it is
    ``causal_attention`` itself."""
    _refuse_grad(q, k, v)
    check_head_dim(q.shape[-1])
    if q.device.type == "cpu":
        return causal_attention(q, k, v, q_positions=q_positions,
                                kv_positions=kv_positions, kv_valid=kv_valid)
    if kv_valid is not None or q_positions is not kv_positions:
        raise ValueError("prefill_attention.causal takes no padding mask and one set of "
                         "positions for rows and columns")
    return prefill_attention(q, k, v)
