"""Ops of the PyTorch engine: plain PyTorch versions and hand-written kernels.

Every kernel wrapper keeps a plain integer count of its launches, so a run can
show that its main path went through the kernel (``kernel_launches``).
"""

from __future__ import annotations

from . import fused_norm, grouped_moe, paged_attention, prefill_attention


def kernel_launches() -> dict[str, int]:
    """Launches of each kernel, K3's by kernel path under
    ``prefill_attention.<path>`` and K4's by entry point under
    ``fused_norm_rope.<entry>``."""
    pa, fn = prefill_attention, fused_norm
    return {paged_attention.KERNEL: paged_attention.launches,
            grouped_moe.KERNEL: grouped_moe.launches,
            pa.KERNEL: pa.launches,
            **{f"{pa.KERNEL}.{p}": n for p, n in pa.path_launches.items()},
            fn.KERNEL: fn.launches,
            **{f"{fn.KERNEL}.{p}": n for p, n in fn.path_launches.items()}}


def reset_kernel_launches() -> None:
    paged_attention.launches = 0
    grouped_moe.reset_launches()
    prefill_attention.reset_launches()
    fused_norm.reset_launches()
