"""Ops of the PyTorch engine: plain PyTorch versions and hand-written kernels.

Every kernel wrapper keeps a plain integer count of its launches, so a run can
show that its main path went through the kernel (``kernel_launches``).
"""

from __future__ import annotations

from . import grouped_moe, paged_attention


def kernel_launches() -> dict[str, int]:
    return {paged_attention.KERNEL: paged_attention.launches,
            grouped_moe.KERNEL: grouped_moe.launches}


def reset_kernel_launches() -> None:
    paged_attention.launches = 0
    grouped_moe.reset_launches()
