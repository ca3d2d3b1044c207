"""Timers, device timing and profiling helpers.

Port of ``seal_embedded_tpu/utils/timing.py``: the reference's
microsecond timer layer (device/lib/timer.{h,c}), a benchmark helper that
reports curr/avg/min/max over N runs as the reference bench harness does
(bench/bench_common.h:102-121), a ``torch.profiler`` session for
kernel-level traces, and CUDA-event timing.

The span recorder (``span``, ``card_clock``) times the layers of a call
where they run.  It is off until ``record_spans(True)``; then each span
keeps its name, its start and end on ``time.perf_counter_ns()``, its
parent (the innermost span open on its thread) and the ``api.call`` it
belongs to, and inside an active ``torch.profiler`` it also opens
``record_function(name)``, so the profiler's host events carry the
spans' names.  A call's device intervals come from CUDA events with
timing that its card clock records outside every graph, read once they
have completed.  ``take_spans`` hands out what was recorded and clears
it; nothing is written anywhere.  Off, ``span`` returns one shared
context that does nothing: no allocation, no torch call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import statistics
import tempfile
import threading
import time
from typing import Callable

import torch

from ..config import CUDA


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


# ------------------------------------------------------------ span recorder

_recording = False
_spans: list = []                   # finished spans, host and device
_local = threading.local()          # .stack: open spans; .clock: CardClock
_clocks: list = []                  # ended runs' CardClocks with marks unread
_clocks_lock = threading.Lock()
_ids = itertools.count(1)
_calls = itertools.count(1)
_OFF = contextlib.nullcontext()


def record_spans(on: bool) -> None:
    """Turn the span recorder on or off (off at import)."""
    global _recording
    _recording = bool(on)


def take_spans() -> list:
    """The spans recorded so far, in the order they ended (a device span
    when it was read: the device intervals that have ended are read
    first), and none kept."""
    read_card_marks()
    out = _spans[:]
    del _spans[:len(out)]
    return out


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """A recorded interval: `name`, `start_ns` and `end_ns`, its `id`,
    its `parent`'s id (None at the thread's outermost span) and the id of
    the ``api.call`` it belongs to (`call`, None outside one).  A device
    span (`card` True) has the `limb` (the step's place in the walk) and
    times on the card's clock from its call's first event; it has no
    parent."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "call",
                 "limb", "card", "_keep", "_root", "_fn")

    def __init__(self, name, start_ns=0, end_ns=0, call=None, limb=None,
                 card=False):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.id = next(_ids)
        self.parent, self.call, self.limb, self.card = None, call, limb, card
        self._keep = self._root = False
        self._fn = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __enter__(self):
        if self._keep:
            stack = _stack()
            top = stack[-1] if stack else None
            self.parent = top.id if top else None
            self.call = (next(_calls) if self._root
                         else top.call if top else None)
            stack.append(self)
            if torch._C._autograd._profiler_enabled():
                self._fn = torch.profiler.record_function(self.name)
                self._fn.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._keep:
            if self._fn is not None:
                self._fn.__exit__(*exc)
                self._fn = None
            _stack().remove(self)
            _spans.append(self)
        return False


def span(name: str, root: bool = False, timed: bool = False):
    """A context around one layer's work, recorded as span `name` while
    the recorder is on; `root` starts a new call (``api.call``).  Off,
    the shared context that does nothing, unless `timed`: then a Span
    that only reads the clock (its `ms` for the caller), recording
    nothing."""
    if _recording or timed:
        s = Span(name)
        s._keep, s._root = _recording, root
        return s
    return _OFF


class CardClock:
    """One call's device intervals on a card: events with timing, taken
    from `spare` or made by make_event() (CUDA events with timing), and
    recorded on a stream outside every graph, `origin` first.  As a
    context it is its thread's current clock, for what queues work of the
    same call (the stream's copies) to mark (name, limb, begin, end); once
    the run has left it, read_card_marks reads each mark that has ended
    into a device span, and, every mark read, hands the events back to
    `spare` for a later run."""

    def __init__(self, stream, make_event, spare: list):
        self.make_event = make_event
        self.spare = spare
        self.used = []
        stack = _stack()
        self.call = stack[-1].call if stack else None   # its api.call's
        self.limb = None        # the step under way, for the marks made
        self.marks = []
        self.origin = self.event(stream)

    def event(self, stream):
        """A timing event recorded on `stream` now."""
        try:
            e = self.spare.pop()
        except IndexError:
            e = self.make_event()
        e.record(stream)
        self.used.append(e)
        return e

    def mark(self, name: str, begin, end) -> None:
        self.marks.append((name, self.limb, begin, end))

    def _read(self) -> bool:
        """Under _clocks_lock: record the marks whose end has completed,
        in the order made; True once none is left (the events go back)."""
        while self.marks and self.marks[0][3].query():
            name, limb, begin, end = self.marks.pop(0)
            _spans.append(Span(
                name, round(self.origin.elapsed_time(begin) * 1e6),
                round(self.origin.elapsed_time(end) * 1e6), self.call,
                limb, card=True))
        if self.marks:
            return False
        self.spare += self.used
        self.used = []
        return True

    def __enter__(self):
        _local.clock = self
        return self

    def __exit__(self, *exc):
        _local.clock = None
        with _clocks_lock:
            _clocks.append(self)
        return False


def read_card_marks() -> None:
    """Record as device spans the marks of the ended runs' card clocks
    whose end has completed: no wait, a query each.  The stream's fetch
    calls it while its host waits for a limb's copy, so the reading
    overlaps the card's work; take_spans reads what is left."""
    if _clocks:
        with _clocks_lock:
            _clocks[:] = [c for c in _clocks if not c._read()]


def card_clock(stream, make_event, spare: list):
    """A CardClock of the call under way on `stream`, its origin recorded
    now, its events from `spare` where it holds some (see CardClock), or
    the shared context that does nothing (yielding None) while the
    recorder is off or without a make_event."""
    if _recording and make_event is not None:
        return CardClock(stream, make_event, spare)
    return _OFF


def current_clock():
    """The CardClock open on this thread, or None."""
    return getattr(_local, "clock", None)
