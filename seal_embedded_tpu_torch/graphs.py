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
  allocator learns the sizes, a process group makes its NCCL
  communicator, which no capture may make), then captured once into a
  ``torch.cuda.CUDAGraph`` with a private pool.  A capture that fails
  raises: there is no eager fallback.
* **Call**: the caller's tensors are copied into the static inputs on the
  current stream, the graph is replayed, and the outputs are cloned out of
  the pool, so they belong to the caller and a later call never
  overwrites them (as JAX arrays).  One lock per entry keeps two threads
  off one graph's static tensors.
* **Tallies**: a replay runs no wrapper and no collective of
  ``parallel/comm.py``, so the entry keeps the change that the capture
  (which launched nothing) made to the kernel counters and the maps
  registered with them (``ops/kernels/counters.py``: ``comm.counts``),
  restores them, and adds that change on every replay.

``Chain`` compiles a generator the same way: the per-prime streams'
prologue and one step per limb (``ckks/stream.py``), the counterpart of
the JAX package's jitted per-limb step.

* **One graph per signature**: the prologue and every step, in walk
  order, captured as one graph in one private pool, an entry of an LRU
  of ``MAX_ENTRIES`` as Graphed's: a chain of 13 limbs is one entry.
  Within the capture a step's scratch is freed before the next step
  allocates, so the pool holds the hand-offs, every step's outputs and
  about one step's scratch.
* **An event per step**: the graph records an external event at the end
  of each step, so that what reads a step's outputs (the stream's copies
  to host memory) starts as soon as that step is done, while the card
  runs the next.
* **A run**: its first next() copies the inputs in, replays the graph
  and calls ``start`` on every step's outputs and event, all under the
  entry's lock; the next replay waits for the events ``start`` returned,
  the end of those reads.  So a run that another follows, abandoned or
  not, has its reads queued already, and every run sees its own inputs.

On the CPU the function runs as it is: every kernel wrapper then runs its
plain version, and a chain runs its steps eagerly.
"""

from __future__ import annotations

import copy
import threading
from collections import OrderedDict
from functools import partial

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
    """obj with fn applied to every tensor in it (dicts, tuples, lists).
    A dict keeps its type and attributes: a parallel.mesh.Shards keeps
    its index."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        out = copy.copy(obj)
        for k, v in obj.items():
            out[k] = map_tensors(v, fn)
        return out
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(v, fn) for v in obj)
    return obj


def _static(a):
    """A tensor argument's static copy (any other argument as it is)."""
    if isinstance(a, torch.Tensor):
        return torch.empty(a.shape, dtype=a.dtype, device=a.device).copy_(a)
    return a


class Capture:
    """The CUDA side of compiling on one device: the warm-up, the graph
    and the events.  Graphed and Chain reach torch.cuda's capture through
    these methods only (the tests put a recording fake in their place)."""

    def __init__(self, device: torch.device):
        self.device = device

    def warm_up(self, fn):
        """fn() WARMUP_CALLS times on a side stream; the last result."""
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    out = fn()
            current.wait_stream(side)
        return out

    def graph(self, fn):
        """(graph, fn's result): one call of fn captured into a private
        pool."""
        with torch.cuda.device(self.device):
            # keep_graph: the captured graph stays beside its executable,
            # so that a run can count its nodes (raw_cuda_graph).
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph):
                out = fn()
            graph.instantiate()
        return graph, out

    def event(self):
        return torch.cuda.Event()

    def step_event(self):
        """An event a capture records as a node of its graph, so that each
        replay records it there."""
        return torch.cuda.Event(external=True)

    def record(self, fn):
        """(graph, fn's result, tallies): tallies is the change the
        capture made to the counters and their registered maps, which are
        then restored: a capture records, it runs nothing."""
        before = counters.tallies()
        try:
            graph, out = self.graph(fn)
            tallies = counters.tallies_since(before)
        finally:
            counters.restore(before)
        return graph, out, tallies


class Entry:
    """One captured signature: its static input tensors, its graph, the
    static outputs in the graph's pool, what one replay adds to the
    counters (launches, and collectives in their map), and the event
    that marks the end of its last use."""

    def __init__(self, inputs: list, graph, outputs, launches: dict,
                 done=None):
        self.inputs = inputs
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.done = done
        self.waits = []      # events the next replay waits for
        self.lock = threading.Lock()

    def _replay(self, tensors: list, stream) -> None:
        """Under the lock: wait for the last use's end (on `stream`, the
        caller's current stream), copy `tensors` into the static inputs,
        replay and count."""
        for event in self.waits:
            stream.wait_event(event)
        for dst, src in zip(self.inputs, tensors):
            dst.copy_(src)
        self.graph.replay()
        counters.add(self.launches)

    def replay(self, tensors: list, stream=None):
        """Copy `tensors` into the static inputs, replay, and return the
        outputs cloned (on `stream`, the caller's current stream)."""
        with self.lock:
            self._replay(tensors, stream)
            out = map_tensors(self.outputs, torch.clone)
            if self.done is not None:
                self.done.record(stream)   # a replay on another stream
                self.waits = [self.done]
        return out

    def scrub(self) -> None:
        """Zero the static inputs: no copy of a caller's key stays in
        them (the next call copies its own inputs in)."""
        with self.lock:
            for t in self.inputs:
                t.zero_()

    def release(self) -> None:
        """Wait until the last use is done, so its pool can be freed."""
        with self.lock:
            for event in self.waits:
                event.synchronize()


class _Compiled:
    """What Graphed and Chain share: the device, the Capture, and the LRU
    of entries by signature."""

    def __init__(self, device, max_entries: int = MAX_ENTRIES):
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"graphed: no CUDA device for {device}")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.capturer = Capture(device)
        self.max_entries = max_entries
        self.entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def _check_devices(self, tensors: list) -> None:
        others = {t.device for t in tensors} - {self.device}
        if others:
            raise ValueError(f"graphed: inputs on {sorted(map(str, others))}, "
                             f"the function runs on {self.device}")

    def entry(self, sig: tuple, *capture_args):
        """The entry of `sig`, captured (self.capture(*capture_args)) on a
        miss; the least recently used entry beyond max_entries is
        evicted."""
        with self._lock:
            entry = self.entries.get(sig)
            if entry is None:
                entry = self.capture(*capture_args)
                self.entries[sig] = entry
                while len(self.entries) > self.max_entries:
                    self.entries.popitem(last=False)[1].release()
            else:
                self.entries.move_to_end(sig)
        return entry

    def scrub(self) -> None:
        """Zero the static tensors of every entry (its scrub)."""
        with self._lock:
            entries = list(self.entries.values())
        for entry in entries:
            entry.scrub()


class Graphed(_Compiled):
    """fn, compiled per input signature on `device` (see the module).
    Called as fn; `entries` maps each live signature to its Entry."""

    def __init__(self, fn, device, max_entries: int = MAX_ENTRIES):
        super().__init__(device, max_entries)
        self.fn = fn

    def __call__(self, *args, **kwargs):
        if self.device.type != "cuda":
            return self.fn(*args, **kwargs)
        tensors = tensors_of(args, kwargs)
        self._check_devices(tensors)
        entry = self.entry(signature(args, kwargs), args, kwargs)
        return entry.replay(tensors, torch.cuda.current_stream(self.device))

    def capture(self, args: tuple, kwargs: dict) -> Entry:
        """Warm fn up on static copies of the tensor arguments, then
        capture one call of it."""
        s_args = tuple(_static(a) for a in args)
        s_kwargs = {k: _static(v) for k, v in kwargs.items()}
        run = partial(self.fn, *s_args, **s_kwargs)
        self.capturer.warm_up(run)
        graph, outputs, launches = self.capturer.record(run)
        return Entry(tensors_of(s_args, s_kwargs), graph, outputs, launches,
                     self.capturer.event())


def graphed(fn, device) -> Graphed:
    """fn compiled per input signature on `device`: the port's jax.jit."""
    return Graphed(fn, device)


def eager_chain(prologue, step, nsteps: int, args: tuple):
    """The chain run as it is: carry = prologue(*args), then for each j
    carry, out = step(j, carry), yielding out.  Nothing runs before the
    first next()."""
    carry = prologue(*args)
    for j in range(nsteps):
        carry, out = step(j, carry)
        yield out


class ChainEntry(Entry):
    """One captured signature of a Chain: an Entry whose outputs are
    every step's, in the graph's pool, whose graph records events[j] at
    the end of step j, and which keeps the last hand-offs (`carry`, ntt(s)
    or the key among them) to zero them in scrub."""

    def __init__(self, inputs: list, graph, outputs: list, launches: dict,
                 events: list, carry):
        super().__init__(inputs, graph, outputs, launches)
        self.events = events
        self.carry = carry

    def run(self, tensors: list, start, stream=None) -> list:
        """Replay the chain on `tensors`, then start(j, outputs of step j,
        events[j]) for every step, under the lock: each returns (item,
        the event that ends its reads of the outputs, or None), and the
        next replay waits for those events.  Returns the items."""
        with self.lock:
            self._replay(tensors, stream)
            started = [start(j, out, event) for j, (out, event)
                       in enumerate(zip(self.outputs, self.events))]
            self.waits = [e for _, e in started if e is not None]
        return [item for item, _ in started]

    def scrub(self) -> None:
        """Zero the static inputs, the last hand-offs and the outputs,
        once the last run's reads of the outputs are done."""
        with self.lock:
            for event in self.waits:
                event.synchronize()
            map_tensors((self.inputs, self.carry, self.outputs),
                        torch.Tensor.zero_)


class Chain(_Compiled):
    """prologue and step (see eager_chain) compiled as one graph per input
    signature on `device` (see the module); every step's outputs are a
    tuple of tensors.  Called as chain(args, start), it returns a
    generator of start's items, one per step (see ChainEntry.run); on
    the CPU each step runs when it is reached, its event None.
    `entries` maps each live signature to its ChainEntry."""

    def __init__(self, prologue, step, nsteps: int, device):
        super().__init__(device)
        self.prologue = prologue
        self.step = step
        self.nsteps = nsteps

    def __call__(self, args: tuple, start):
        if self.device.type != "cuda":
            for j, out in enumerate(eager_chain(self.prologue, self.step,
                                                self.nsteps, args)):
                yield start(j, out, None)[0]
            return
        tensors = tensors_of(args, {})
        self._check_devices(tensors)
        entry = self.entry(signature(args, {}), args)
        yield from entry.run(tensors, start,
                             torch.cuda.current_stream(self.device))

    def _run(self, args: tuple, events: list):
        """The chain run as it is, events[j] (if not None) recorded at the
        end of step j: (every step's outputs, the last carry)."""
        carry = self.prologue(*args)
        outs = []
        for j, event in enumerate(events):
            carry, out = self.step(j, carry)
            outs.append(out)
            if event is not None:
                event.record()
        return outs, carry

    def capture(self, args: tuple) -> ChainEntry:
        """Warm the chain up on static copies of the tensor arguments,
        then capture it whole, an event after each step."""
        cap = self.capturer
        s_args = tuple(_static(a) for a in args)
        cap.warm_up(partial(self._run, s_args, [None] * self.nsteps))
        events = [cap.step_event() for _ in range(self.nsteps)]
        graph, (outs, carry), launches = cap.record(
            partial(self._run, s_args, events))
        return ChainEntry(tensors_of(s_args, {}), graph, outs, launches,
                          events, carry)
