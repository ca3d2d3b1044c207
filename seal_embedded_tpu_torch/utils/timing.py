"""Device timing with CUDA events."""

from __future__ import annotations

import statistics

import torch


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of one fn() call on the current CUDA stream,
    each call timed between two events after `warmup` untimed calls.
    Raises when no CUDA device is present: there is no CPU timing here."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
