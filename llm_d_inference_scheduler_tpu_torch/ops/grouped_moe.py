"""Grouped-expert SwiGLU FFN: wrapper of the hand-written CUDA kernel K2.

Replaces the TPU kernel ``_grouped_ffn_call``
(``llm_d_inference_scheduler_tpu/ops/pallas_moe.py:76``). The kernel
(``csrc/grouped_moe_ffn.cu``) runs two launches, gate/up then down, through
an ``[Tp, F]`` workspace this wrapper allocates; one wrapper call counts as
one launch of K2. On an H100 it is bound by the bytes of the experts' weights
at decode sizes (0.42 ms for 8 routed rows at Mixtral width) and about evenly
by bytes and operations at prefill sizes (0.85 ms for 2200 rows). bf16 runs
warp-specialised ``wgmma`` fed by TMA at every size, f32 CUDA-core FMA;
``path_launches`` counts each wrapper call under the path it took (``wgmma``
or ``simt``). Design and what is left are in the source's header.

On a CPU tensor the wrapper computes the plain version
(``ops/moe.py:grouped_ffn_reference``); on a CUDA tensor it launches the
kernel or raises — there is no fallback. ``launches`` counts kernel
launches only.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .moe import TILE_ROWS, check_tileable, grouped_ffn_reference

KERNEL = "grouped_moe_ffn"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

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


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(KERNEL).grouped_moe_ffn
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x_pad, tile_expert, w1, w3, w2, tm, rows_used) -> None:
    tensors = {"x_pad": x_pad, "tile_expert": tile_expert, "w1": w1, "w3": w3,
               "w2": w2, "rows_used": rows_used}
    for name, t in tensors.items():
        if t.device != x_pad.device:
            raise ValueError(f"{name} is on {t.device}, x_pad on {x_pad.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the kernel takes "
                             "row-major layouts; weights are never copied)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x_pad.dtype not in _DTYPE_CODE:
        raise ValueError(f"x_pad dtype {x_pad.dtype} unsupported; have float32, bfloat16")
    for name in ("w1", "w3", "w2"):
        if tensors[name].dtype != x_pad.dtype:
            raise ValueError(f"{name} dtype {tensors[name].dtype} != x_pad dtype {x_pad.dtype}")
    for name in ("tile_expert", "rows_used"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    if x_pad.dim() != 2 or w1.dim() != 3:
        raise ValueError("x_pad must be [Tp, D] and w1/w3 [E, D, F], w2 [E, F, D]")
    Tp, D = x_pad.shape
    E, _, F = w1.shape
    if w1.shape != (E, D, F) or w3.shape != (E, D, F) or w2.shape != (E, F, D):
        raise ValueError(f"weight shapes {tuple(w1.shape)}, {tuple(w3.shape)}, "
                         f"{tuple(w2.shape)} do not match x_pad {tuple(x_pad.shape)}")
    check_tileable(D, F)
    if tm != TILE_ROWS or Tp % tm:
        raise ValueError(f"tm={tm} must be {TILE_ROWS} and divide Tp={Tp}")
    if tile_expert.shape != (Tp // tm,):
        raise ValueError(f"tile_expert must be [Tp // tm = {Tp // tm}]")
    if rows_used.shape != (1,):
        raise ValueError("rows_used must be [1]")


def grouped_ffn_cuda(x_pad: torch.Tensor, tile_expert: torch.Tensor,
                     w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                     tm: int, rows_used: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU FFN over row tiles of ``x_pad`` [Tp, D]; returns
    [Tp, D] in x_pad's dtype (the JAX kernel's signature, without ``tf``
    and ``interpret``, plus ``rows_used``). ``rows_used`` [1] int32 on the
    device, from ``moe.group_rows``: tiles at or past it are padding, hold
    zero rows and come out zero."""
    if x_pad.device.type == "cpu":
        return grouped_ffn_reference(x_pad, tile_expert, w1, w3, w2, tm)
    if x_pad.device.type != "cuda":
        raise ValueError(f"grouped_ffn_cuda: unsupported device {x_pad.device}")
    Tp, D = x_pad.shape
    _check(x_pad, tile_expert, w1, w3, w2, tm, rows_used)
    E, _, F = w1.shape
    ws = torch.empty((Tp, F), dtype=x_pad.dtype, device=x_pad.device)
    out = torch.empty_like(x_pad)
    fn = _kernel()
    with torch.cuda.device(x_pad.device):
        rc = fn(x_pad.data_ptr(), tile_expert.data_ptr(), rows_used.data_ptr(),
                w1.data_ptr(), w3.data_ptr(), w2.data_ptr(), ws.data_ptr(),
                out.data_ptr(), Tp // tm, tm, D, F, E, _DTYPE_CODE[x_pad.dtype],
                torch.cuda.current_stream(x_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped_moe_ffn kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    path_launches[kernel_path(x_pad.dtype)] += 1
    return out
