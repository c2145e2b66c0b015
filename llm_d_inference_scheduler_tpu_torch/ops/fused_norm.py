"""RMSNorm, QK-norm and RoPE of the served layer: wrapper of the hand-written
CUDA kernel K4.

Replaces no TPU kernel: the JAX package computes its norms and rotary
embeddings as plain jnp (``llm_d_inference_scheduler_tpu/ops/norms.py``,
``ops/rope.py``), whose eager ports (``ops/norms.py:rms_norm``,
``ops/rope.py:apply_rope``) run each call as 9-10 launches of f32 passes.
The kernel (``csrc/fused_norm_rope.cu``) has two entry points, one launch
each:

- ``rms_norm``: RMSNorm of rows of any width that is a multiple of 8 up to
  32768, optionally after adding a residual (the layer's ``x = x + attn``
  followed by its MLP norm, in one pass that writes both);
- ``qk_norm_rope``: q [..., Hq, D] and k [..., Hk, D] together: each head
  row's RMSNorm with ``q_norm``/``k_norm`` where the layer holds them
  (Qwen3), rounded to the dtype, then the non-interleaved RoPE from
  ``rope_table``'s cos/sin; RoPE alone without the norm weights.

Both are bound by bytes on an H100 (about 0.5 FLOP a byte); the design is in
the source's header. The roundings are the eager chain's, so a norm differs
from it only by the order of its f32 sum, and RoPE alone not at all.

A CUDA tensor launches the kernel; a tensor on any other device computes
the plain version (``rms_norm_reference``, ``qk_norm_rope_reference``: the
eager functions, which the CPU tests hold to the JAX package). K4 has no
backward, so a CUDA input that requires grad under grad mode raises: a
caller that differentiates passes ``PLAIN`` as ``llama.forward``'s
``norms``, as it passes its own ``attention_fn`` in place of K3. On the
kernel's path an unsupported width, head dim or dtype raises too: there is
no fallback. ``launches`` counts kernel launches, ``path_launches`` each
entry point's.
"""

from __future__ import annotations

import ctypes
import types

import torch

from . import _build
from .norms import rms_norm as plain_rms_norm
from .rope import apply_rope

KERNEL = "fused_norm_rope"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 32768
MAX_HEAD_DIM = 256
MAX_TOKEN_BYTES = 48 * 1024  # a token's q and k rows, staged in one CTA's shared memory

launches = 0
path_launches = {"rms_norm": 0, "qk_norm_rope": 0}
_fns: dict[str, object] = {}


def reset_launches() -> None:
    global launches
    launches = 0
    for k in path_launches:
        path_launches[k] = 0


def check_width(width: int) -> None:
    """rms_norm takes rows of whole 16-byte vectors in either dtype:
    widths that are multiples of 8 up to MAX_WIDTH."""
    if width % 8 or not 8 <= width <= MAX_WIDTH:
        raise ValueError(f"fused_norm.rms_norm: width {width} unsupported; the kernel takes "
                         f"multiples of 8 up to {MAX_WIDTH}")


def check_head_dim(head_dim: int) -> None:
    """qk_norm_rope splits a head into two halves of whole 16-byte rows of
    cos/sin: head dims that are multiples of 16 up to MAX_HEAD_DIM."""
    if head_dim % 16 or not 16 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"fused_norm.qk_norm_rope: head_dim {head_dim} unsupported; the "
                         f"kernel takes multiples of 16 up to {MAX_HEAD_DIM}")


def _takes_kernel(*tensors) -> bool:
    """K4 serves the call: its first tensor lies on a CUDA device. Raises
    there where autograd would need a backward through it."""
    if tensors[0].device.type != "cuda":
        return False
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise ValueError("fused_norm has no backward: an input requires grad (a caller "
                         "that differentiates passes fused_norm.PLAIN as llama's norms)")
    return True


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
                       residual: torch.Tensor | None = None):
    """The plain version: ``norms.rms_norm``; with ``residual``, the sum
    ``residual + x`` in the dtype and its norm."""
    if residual is None:
        return plain_rms_norm(x, weight, eps)
    x = residual + x
    return x, plain_rms_norm(x, weight, eps)


def qk_norm_rope_reference(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor, q_norm: torch.Tensor | None = None,
                           k_norm: torch.Tensor | None = None, eps: float = 1e-5):
    """The plain version: the per-head ``rms_norm`` (where the norm weights
    are given), then ``apply_rope``, on q and k."""
    if q_norm is not None:
        q = plain_rms_norm(q, q_norm, eps)
        k = plain_rms_norm(k, k_norm, eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def check_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   residual: torch.Tensor | None = None) -> None:
    """What the kernel's rms_norm takes (any device: the CPU tests call
    it on meta tensors)."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_norm.rms_norm: dtype {x.dtype} unsupported; have float32, "
                         "bfloat16")
    check_width(x.shape[-1])
    if weight.shape != x.shape[-1:] or weight.dtype != x.dtype:
        raise ValueError(f"fused_norm.rms_norm: weight {weight.dtype} "
                         f"{tuple(weight.shape)} must be [{x.shape[-1]}] in {x.dtype}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(f"fused_norm.rms_norm: residual {residual.dtype} "
                         f"{tuple(residual.shape)} must match x {x.dtype} {tuple(x.shape)}")
    for t in (weight, residual):
        if t is not None and t.device != x.device:
            raise ValueError(f"fused_norm.rms_norm: a tensor is on {t.device}, x on {x.device}")


def check_qk_norm_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                       q_norm: torch.Tensor | None = None,
                       k_norm: torch.Tensor | None = None) -> None:
    """What the kernel's qk_norm_rope takes (any device)."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_norm.qk_norm_rope: dtype {q.dtype} unsupported; have "
                         "float32, bfloat16")
    D = q.shape[-1]
    check_head_dim(D)
    if k.dtype != q.dtype or k.shape[-1] != D or k.shape[:-2] != q.shape[:-2]:
        raise ValueError(f"fused_norm.qk_norm_rope: k {k.dtype} {tuple(k.shape)} does not "
                         f"match q {q.dtype} {tuple(q.shape)}")
    row_bytes = (q.shape[-2] + k.shape[-2]) * D * q.element_size()
    if row_bytes > MAX_TOKEN_BYTES:
        raise ValueError(f"fused_norm.qk_norm_rope: a token's q and k rows take {row_bytes} "
                         f"bytes; the kernel stages at most {MAX_TOKEN_BYTES} in shared memory")
    if cos.shape[-1] != D // 2:
        raise ValueError(f"fused_norm.qk_norm_rope: cos/sin end in {cos.shape[-1]}, want "
                         f"head_dim // 2 = {D // 2}")
    if (q_norm is None) != (k_norm is None):
        raise ValueError("fused_norm.qk_norm_rope: q_norm and k_norm come together")
    for w in (q_norm, k_norm):
        if w is not None and (w.shape != (D,) or w.dtype != q.dtype):
            raise ValueError(f"fused_norm.qk_norm_rope: norm weight {w.dtype} "
                             f"{tuple(w.shape)} must be [{D}] in {q.dtype}")
    for t in (k, cos, q_norm, k_norm):
        if t is not None and t.device != q.device:
            raise ValueError(f"fused_norm.qk_norm_rope: a tensor is on {t.device}, q on "
                             f"{q.device}")


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(KERNEL), name)
        if name == "rms_norm":
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data 16-byte aligned (a view that starts
    mid-allocation is copied; the kernel moves 16-byte vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _table(t: torch.Tensor, lead: torch.Size, T: int, half: int) -> torch.Tensor:
    """cos or sin as f32 [T, half] rows, one a token: the caller's tensor
    itself where it is already laid out so (rope_table's [B, S, half], or
    decode's [B, 1, half] view), else broadcast and copied."""
    if not (t.dtype == torch.float32 and t.numel() == T * half and t.is_contiguous()):
        t = torch.broadcast_to(t.float(), (*lead, half)).reshape(T, half)
    return _rows(t)


def _launch(name: str, dev: torch.device, *args) -> None:
    """One launch on the current stream of the tensors' device (made
    current for the call where it is not)."""
    global launches
    fn = _kernel(name)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch._C._cuda_getDevice():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"fused_norm.{name} kernel launch failed: CUDA error {rc}")
    launches += 1
    path_launches[name] += 1


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             residual: torch.Tensor | None = None):
    """RMSNorm of x [..., W] with ``weight`` [W], computed in f32 and
    returned in x's dtype. With ``residual`` (x's shape), returns
    ``(residual + x, its norm)``: the sum rounded to the dtype, then
    normed."""
    if not _takes_kernel(x, weight, residual):
        return rms_norm_reference(x, weight, eps, residual)
    check_rms_norm(x, weight, residual)
    if x.numel() == 0:  # no rows: nothing to launch
        out = torch.empty_like(x)
        return out if residual is None else (torch.empty_like(x), out)
    x, weight = _rows(x), _rows(weight)
    out = torch.empty_like(x)
    res_out = None
    if residual is not None:
        residual = _rows(residual)
        res_out = torch.empty_like(x)
    W = x.shape[-1]
    _launch("rms_norm", x.device, x.data_ptr(),
            None if residual is None else residual.data_ptr(), weight.data_ptr(),
            out.data_ptr(), None if res_out is None else res_out.data_ptr(),
            x.numel() // W, W, float(eps), _DTYPE_CODE[x.dtype])
    return out if residual is None else (res_out, out)


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 q_norm: torch.Tensor | None = None, k_norm: torch.Tensor | None = None,
                 eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """q [..., Hq, D] and k [..., Hk, D] (the same leading dims): each head
    row RMS-normed with ``q_norm``/``k_norm`` [D] where given, then rotated
    by cos/sin (f32, broadcastable to [..., D/2]); returns (q, k) in their
    dtype."""
    if not _takes_kernel(q, k, q_norm, k_norm):
        return qk_norm_rope_reference(q, k, cos, sin, q_norm, k_norm, eps)
    check_qk_norm_rope(q, k, cos, q_norm, k_norm)
    lead, D = q.shape[:-2], q.shape[-1]
    T = lead.numel()
    if T == 0:  # no tokens: nothing to launch
        return torch.empty_like(q), torch.empty_like(k)
    tables = [_table(t, lead, T, D // 2) for t in (cos, sin)]
    q, k = _rows(q), _rows(k)
    norms = (None, None)
    if q_norm is not None:  # the copies _rows may make live until the launch
        q_norm, k_norm = _rows(q_norm), _rows(k_norm)
        norms = (q_norm.data_ptr(), k_norm.data_ptr())
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    _launch("qk_norm_rope", q.device, q.data_ptr(), k.data_ptr(), *norms,
            tables[0].data_ptr(), tables[1].data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
            T, q.shape[-2], k.shape[-2], D, float(eps), _DTYPE_CODE[q.dtype])
    return q_out, k_out


# The eager functions under the wrappers' names: what a caller that
# differentiates passes as ``llama.forward``'s ``norms`` (the default is
# this module, whose wrappers launch K4 on CUDA).
PLAIN = types.SimpleNamespace(rms_norm=rms_norm_reference, qk_norm_rope=qk_norm_rope_reference)
