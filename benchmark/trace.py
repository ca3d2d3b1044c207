"""Device traces of a few calls after the window, and their reduction.

A traced segment runs a decoy call, a marker kernel
(``torch.cuda._sleep``'s spin kernel) and then calls for a set time,
under ``torch.profiler``; only the device events after the marker count
(a trace can drop events near its start).  The segment's window runs
from the marker's end to the last device event's end; busy is the union
of the device intervals (kernels and copies) in it, idle = 1 - busy /
window.  The device segment traces the card alone, so the profiler
costs the host little; a shorter second segment also traces the host, to
name what the host was doing in each idle gap.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import time

import torch
from torch.autograd import DeviceType

MARKER = "spin_kernel"
MARK_CYCLES = 1000
TOP = 10


@dataclasses.dataclass
class Segment:
    """Device events (start us, end us, name) after the marker, the
    window (us), the calls run in it, and the host's events (start us,
    end us, name) where the host was traced."""
    events: list
    window_us: float
    calls: int
    host: list = dataclasses.field(default_factory=list)

    def busy_us(self) -> float:
        return union_us([(s, e) for s, e, _ in self.events])

    def time_us(self, keep) -> float:
        """Summed device time of the events whose name keep() accepts."""
        return sum(e - s for s, e, name in self.events if keep(name))


def union_us(intervals) -> float:
    total, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def kernel_name(name: str) -> str:
    """A device event's name without "void ", namespaces, template
    arguments or parameters: "void (anonymous namespace)::ntt_kernel<3>(
    long long const*, ...)" is "ntt_kernel"."""
    bare = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
    bare = re.split(r"[<(]", bare, maxsplit=1)[0].strip()
    return bare.rsplit("::", 1)[-1] or name[:64]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def segment(call, seconds: float, host: bool = False) -> Segment:
    """Trace call() repeated for `seconds` after a decoy call and the
    marker; with `host`, the host's activity too."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    calls = 0
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda._sleep(MARK_CYCLES)
        end = time.perf_counter() + seconds
        while calls < 2 or time.perf_counter() < end:
            call()
            calls += 1
        torch.cuda.synchronize()
    dev, cpu = [], []
    for e in prof.events():
        item = (e.time_range.start, e.time_range.end, e.name)
        (dev if e.device_type == DeviceType.CUDA else cpu).append(item)
    marks = [e for e in dev if MARKER in e[2]]
    if not marks:
        raise RuntimeError("the trace lost its marker kernel")
    start = max(e[1] for e in marks)
    dev = sorted(e for e in dev if e[0] >= start and MARKER not in e[2])
    if not dev:
        raise RuntimeError("the trace saw no device work after its marker")
    return Segment(dev, max(e[1] for e in dev) - start, calls,
                   sorted(e for e in cpu if e[1] > start))


def device_ops(seg: Segment) -> list:
    """[[kernel, seconds]] of the TOP device operations by time."""
    by = collections.Counter()
    for s, e, name in seg.events:
        by[kernel_name(name)] += (e - s) * 1e-6
    return [[k, v] for k, v in by.most_common(TOP)]


def idle_gaps(seg: Segment) -> list:
    """[[what the host did, seconds]]: the card's idle gaps, each named by
    the innermost host event at its middle, summed by name, the TOP
    longest."""
    merged = []
    for s, e, _ in seg.events:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    by = collections.Counter()
    active, nxt = [], 0     # host events begun by the gap's middle
    for (_, gap_start), (gap_end, _) in zip(merged, merged[1:]):
        mid = (gap_start + gap_end) / 2
        while nxt < len(seg.host) and seg.host[nxt][0] <= mid:
            active.append(seg.host[nxt])
            nxt += 1
        active = [h for h in active if h[1] > mid]
        label = max(active)[2] if active else "python"
        by[label] += (gap_end - gap_start) * 1e-6
    return [[k, v] for k, v in by.most_common(TOP)]
