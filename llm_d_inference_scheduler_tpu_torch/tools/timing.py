"""Device timing of CUDA work on one card, for ``chip_smoke.py``."""

from __future__ import annotations

import torch


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Wall ms per call between CUDA events around ``iters`` calls: the
    device time when the host keeps ahead, the host's enqueue time when not."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn, iters: int = 20, warmup: int = 3) -> dict[str, float]:
    """Device ms per call of each CUDA kernel ``fn`` launches, from a
    torch.profiler trace of ``iters`` calls (kernel events only)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def device_ms(fn, iters: int = 20) -> tuple[float, float, bool]:
    """(ms per call, event wall ms per call, from_profiler): the summed
    device time of the call's kernels where the profiler sees the card,
    else the CUDA-event time."""
    wall = cuda_ms(fn, iters)
    dev = sum(kernel_times(fn, iters).values())
    return (dev, wall, True) if dev > 0 else (wall, wall, False)
