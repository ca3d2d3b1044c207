"""Compiled entry points: the port's counterpart of ``jax.jit``.

Every factory of the JAX package returns a jitted function, traced once
per input signature and then run as one compiled program.  ``graphed``
gives the port's factories the same execution model on the card: the
first call of a signature captures the function as one CUDA graph, and
every later call of that signature replays it, with no Python between
its kernels.

* **Signature**: each tensor argument's shape, dtype and device, and every
  other argument by type and value (it must be hashable).  The entries of
  one function form an LRU of ``MAX_ENTRIES``; an evicted entry drops its
  graph, its static tensors and its private memory pool.
* **Capture**: the tensor arguments are copied into static buffers, the
  function is warmed up on a side stream (``WARMUP_CALLS`` calls: the
  kernel library loads, its functions are set up and loaded lazily, the
  allocator learns the sizes), then captured once into a
  ``torch.cuda.CUDAGraph`` with a private pool.  A capture that fails
  raises: there is no eager fallback.
* **Call**: the caller's tensors are copied into the static inputs on the
  current stream, the graph is replayed, and the outputs are cloned out of
  the pool, so they belong to the caller and a later call never
  overwrites them (as JAX arrays).  One lock per entry keeps two threads
  off one graph's static tensors.
* **Launch counters**: a replay runs no wrapper, so the entry keeps each
  kernel counter's change during the capture (which launched nothing)
  and adds it on every replay (``ops/kernels/counters.py``).

On the CPU the function runs as it is: every kernel wrapper then runs its
plain version.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from .ops.kernels import counters

MAX_ENTRIES = 8
WARMUP_CALLS = 2


def signature(args: tuple, kwargs: dict) -> tuple:
    """The key of a call: (shape, dtype, device) of each tensor, (type,
    value) of anything else, for the positional and the keyword
    arguments.  Raises TypeError for an unhashable argument."""
    def key(a):
        if isinstance(a, torch.Tensor):
            return ("tensor", tuple(a.shape), a.dtype, a.device)
        hash(a)
        return (type(a), a)
    return (tuple(key(a) for a in args),
            tuple(sorted((k, key(v)) for k, v in kwargs.items())))


def tensors_of(args: tuple, kwargs: dict) -> list:
    """The tensor arguments, positional first, then keyword by name."""
    return [a for a in (*args, *(kwargs[k] for k in sorted(kwargs)))
            if isinstance(a, torch.Tensor)]


def map_tensors(obj, fn):
    """obj with fn applied to every tensor in it (dicts, tuples, lists)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(v, fn) for v in obj)
    return obj


class Entry:
    """One captured signature: its static input tensors, its graph, the
    static outputs in the graph's pool, the kernel launches one replay
    makes, and the event that marks the end of its last use."""

    def __init__(self, inputs: list, graph, outputs, launches: dict,
                 done=None):
        self.inputs = inputs
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.done = done
        self.lock = threading.Lock()

    def replay(self, tensors: list, stream=None):
        """Copy `tensors` into the static inputs, replay, and return the
        outputs cloned (on `stream`, the caller's current stream)."""
        with self.lock:
            if self.done is not None:
                stream.wait_event(self.done)   # a replay on another stream
            for dst, src in zip(self.inputs, tensors):
                dst.copy_(src)
            self.graph.replay()
            out = map_tensors(self.outputs, torch.clone)
            if self.done is not None:
                self.done.record(stream)
            counters.add(self.launches)
        return out

    def scrub(self) -> None:
        """Zero the static inputs: no copy of a caller's key stays in
        them (the next call copies its own inputs in)."""
        with self.lock:
            for t in self.inputs:
                t.zero_()

    def release(self) -> None:
        """Wait until the last replay is done, so its pool can be freed."""
        with self.lock:
            if self.done is not None:
                self.done.synchronize()


class Graphed:
    """fn, compiled per input signature on `device` (see the module).
    Called as fn; `entries` maps each live signature to its Entry."""

    def __init__(self, fn, device, max_entries: int = MAX_ENTRIES):
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"graphed: no CUDA device for {device}")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.fn = fn
        self.device = device
        self.max_entries = max_entries
        self.entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        if self.device.type != "cuda":
            return self.fn(*args, **kwargs)
        tensors = tensors_of(args, kwargs)
        others = {t.device for t in tensors} - {self.device}
        if others:
            raise ValueError(f"graphed: inputs on {sorted(map(str, others))}, "
                             f"the function runs on {self.device}")
        entry = self.entry(signature(args, kwargs), args, kwargs)
        return entry.replay(tensors, torch.cuda.current_stream(self.device))

    def entry(self, sig: tuple, args: tuple, kwargs: dict) -> Entry:
        """The entry of `sig`, captured from args, kwargs on a miss; the
        least recently used entry beyond max_entries is evicted."""
        with self._lock:
            entry = self.entries.get(sig)
            if entry is None:
                entry = self.capture(args, kwargs)
                self.entries[sig] = entry
                while len(self.entries) > self.max_entries:
                    self.entries.popitem(last=False)[1].release()
            else:
                self.entries.move_to_end(sig)
        return entry

    def capture(self, args: tuple, kwargs: dict) -> Entry:
        """Warm fn up on static copies of the tensor arguments, then
        capture one call of it."""
        def static(a):
            if isinstance(a, torch.Tensor):
                return torch.empty(a.shape, dtype=a.dtype,
                                   device=a.device).copy_(a)
            return a
        s_args = tuple(static(a) for a in args)
        s_kwargs = {k: static(v) for k, v in kwargs.items()}
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    self.fn(*s_args, **s_kwargs)
            current.wait_stream(side)
            # keep_graph: the captured graph stays beside its executable,
            # so that a run can count its nodes (raw_cuda_graph).
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = counters.read()
            with torch.cuda.graph(graph):
                outputs = self.fn(*s_args, **s_kwargs)
            launches = counters.since(before)
            counters.restore(before)   # the capture recorded, it ran nothing
            graph.instantiate()
        return Entry(tensors_of(s_args, s_kwargs), graph, outputs, launches,
                     torch.cuda.Event())

    def scrub(self) -> None:
        """Zero the static inputs of every entry (Entry.scrub)."""
        with self._lock:
            entries = list(self.entries.values())
        for entry in entries:
            entry.scrub()


def graphed(fn, device) -> Graphed:
    """fn compiled per input signature on `device`: the port's jax.jit."""
    return Graphed(fn, device)
