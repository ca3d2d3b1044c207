"""Timers, device timing and profiling helpers.

Port of ``seal_embedded_tpu/utils/timing.py``: the reference's
microsecond timer layer (device/lib/timer.{h,c}), a benchmark helper that
reports curr/avg/min/max over N runs as the reference bench harness does
(bench/bench_common.h:102-121), a ``torch.profiler`` session for
kernel-level traces, and CUDA-event timing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import tempfile
import time
from typing import Callable

import torch

from ..convert import CUDA


@dataclasses.dataclass
class Timer:
    """start/stop/read accumulator (timer.h:42-77 semantics)."""
    elapsed: float = 0.0
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            raise RuntimeError("timer not started")
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None

    def reset(self):
        self.elapsed = 0.0
        self._t0 = None

    def read_us(self) -> float:
        return self.elapsed * 1e6


@dataclasses.dataclass
class BenchStats:
    """curr/avg/min/max over runs (bench_common.h:102-121)."""
    times_s: list[float]

    @property
    def curr(self):
        return self.times_s[-1]

    @property
    def avg(self):
        return sum(self.times_s) / len(self.times_s)

    @property
    def min(self):
        return min(self.times_s)

    @property
    def max(self):
        return max(self.times_s)

    def summary_us(self) -> dict:
        return {k: round(getattr(self, k) * 1e6, 1)
                for k in ("curr", "avg", "min", "max")}


def _cuda_devices(obj) -> set:
    """The CUDA devices of the tensors in obj (a tensor, or a dict, list
    or tuple of them, nested)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.is_cuda else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return set().union(*map(_cuda_devices, obj)) if obj else set()
    return set()


def _run_synced(fn, args):
    """fn(*args), returned once every CUDA device its inputs and outputs
    lie on has finished."""
    out = fn(*args)
    for dev in _cuda_devices((args, out)):
        torch.cuda.synchronize(dev)
    return out


def bench_fn(fn: Callable, *args, iters: int = 10,
             warmup: int = 1) -> BenchStats:
    """Host-clock seconds of `iters` calls of fn(*args), each ending when
    the card holding its tensors has finished (torch.cuda.synchronize);
    CPU tensors are done when fn returns."""
    for _ in range(warmup):
        _run_synced(fn, args)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _run_synced(fn, args)
        times.append(time.perf_counter() - t0)
    return BenchStats(times)


@contextlib.contextmanager
def profile_trace(logdir: str | None = None):
    """A torch.profiler session around a region (the CPU, and the card
    where there is one); on exit it writes the Chrome trace
    ``trace.json`` into `logdir` (default: a directory under the
    temporary directory).  Yields logdir."""
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "seal_embedded_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def print_config(parms, extra: dict | None = None, device=CUDA) -> str:
    """Configuration banner (util_print.h:713 print_config equivalent),
    with the name and count of the devices of `device`'s type."""
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        count = torch.cuda.device_count()
    else:
        name, count = "cpu", 1
    lines = [
        "=== seal_embedded_tpu_torch configuration ===",
        f"degree (n):        {parms.degree}",
        f"logn:              {parms.logn}",
        f"nprimes:           {parms.nprimes}",
        f"moduli:            {list(parms.moduli)}",
        f"scale:             {parms.scale}",
        f"slot count:        {parms.slot_count}",
        f"device:            {name} (torch {torch.__version__})",
        f"devices:           {count}",
    ]
    for k, v in (extra or {}).items():
        lines.append(f"{k + ':':19s}{v}")
    banner = "\n".join(lines)
    print(banner)
    return banner


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
