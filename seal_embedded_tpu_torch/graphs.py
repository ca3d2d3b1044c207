"""Compiled entry points: the port's counterpart of ``jax.jit``.

Every factory of the JAX package returns a jitted function, traced once
per input signature and then run as one compiled program.  ``graphed``
gives the port's factories the same execution model on the card: the
first call of a signature captures the function as one CUDA graph, and
every later call of that signature replays it, with no Python between
its kernels.

* **Signature**: each tensor argument's shape, dtype and device, and every
  other argument by type and value (it must be hashable).  The entries of
  one function form an LRU of ``MAX_ENTRIES``.
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
* **Memory** (``Registry``): an entry keeps its pool (intermediates and
  static outputs) and its static inputs reserved while it lives, where a
  jitted function keeps nothing between calls.  So every entry on a card,
  of every compiled function, is registered in one registry per device,
  which orders them by last use and records the bytes each capture left
  reserved.  A capture first measures its warm-up's peak; if the warm-up
  runs out of memory, least recently used entries are evicted until what
  the function's last capture needed, per byte of its inputs, is free
  (or, without one, a single entry), and it runs again (it raises once
  nothing is left to evict); then entries are
  evicted, oldest first and of any function, until that peak fits in what
  the card has free, and once it is captured until its outputs fit, for
  the first replay's copies.  Idle entries never take the room of the
  caller's tensors either: an eager allocation on the card (a call's
  clones of its outputs, the port's uploads and casts: ``allocate``)
  that runs out of memory evicts least recently used entries, of any
  function but the one whose call is under way, until its bytes are
  free, and runs again; a call whose clones ran out runs again whole,
  its launches counted once.  So a sequence of calls runs to its end
  whenever each call's own working set, beside what the caller holds,
  fits the card, as under ``jax.jit``; with nothing left to evict, it
  raises torch.OutOfMemoryError.  One capture runs on a device at a
  time (it reads the device's memory), and so does an eviction; live
  entries of every function replay meanwhile.  The registry holds its
  functions weakly: a compiled function that its caller drops (or a
  factory's cache pushes out) has its entries released as at an
  eviction.
* **Tallies**: a replay runs no wrapper and no collective of
  ``parallel/comm.py``, so the entry keeps the change that the capture
  (which launched nothing) made to the kernel counters and the maps
  registered with them (``ops/kernels/counters.py``: ``comm.counts``),
  restores them, and adds that change on every replay.

``Chain`` compiles a generator the same way: the per-prime streams'
prologue and one step per limb (``ckks/stream.py``), the counterpart of
the JAX package's jitted per-limb step.

* **Graphs in one pool per signature**: the prologue's graph and one
  graph per step, captured in walk order into one memory pool and
  replayed in that order, one entry of an LRU of ``MAX_ENTRIES`` and of
  its device's registry as Graphed's (evicted and zeroed together): a
  chain of 13 limbs is one entry.  A graph's scratch is free for the
  next graph's capture, so the pool holds the hand-offs and about one
  step's scratch.
* **A ring of ``RING_SLOTS`` (K) output slots**: static tensors of the
  entry, made outside the pool like the warm-up's last outputs; step j
  writes its outputs into slot j mod K, so the card holds K steps'
  outputs whatever the chain's length, as the JAX stream keeps two
  limbs dispatched.
* **A run**: its first next() copies the inputs in (after the last
  run's end) and replays the graphs, and after step j records step j's
  event and calls ``start`` on its slot and event, all under the
  entry's lock; ``start`` queues the reads of the slot (the stream's
  copy to host memory) and returns the event that ends them, which the
  card waits for (``wait_event``, not the host) before a later step
  writes that slot again, in this run or the next.  So a run that
  another follows, abandoned or not, has its reads queued already, and
  every run sees its own inputs.

On the CPU the function runs as it is: every kernel wrapper then runs its
plain version, and a chain runs its steps eagerly.
"""

from __future__ import annotations

import copy
import sys
import threading
import weakref
from collections import OrderedDict, deque
from contextlib import contextmanager
from functools import partial

import torch

from .ops.kernels import counters
from .utils import timing

MAX_ENTRIES = 8
WARMUP_CALLS = 2
# A chain's output slots on the card: the JAX stream's two limbs in
# flight, one written while the other is read.
RING_SLOTS = 2


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


def nbytes(obj) -> int:
    """The bytes of the tensors in obj (see map_tensors)."""
    sizes = []
    map_tensors(obj, lambda t: sizes.append(t.nbytes))
    return sum(sizes)


class CardMemory:
    """A card's memory as the registry reads it, through torch.cuda (the
    tests put a fake card in its place)."""

    def __init__(self, device: torch.device):
        self.device = device

    def free(self) -> int:
        """The bytes free on the card once the allocator has handed back
        its cache and the pools of evicted entries (empty_cache)."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return torch.cuda.mem_get_info(self.device)[0]

    def reserved(self) -> int:
        """The bytes the allocator holds once its cache is handed back."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(self.device)

    def peak(self, fn):
        """(fn(), the most that fn held above what was held when it
        started: allocated or reserved, the larger; a private pool cannot
        use the free room of the segments reserved before)."""
        dev = self.device
        reserved = self.reserved()
        allocated = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        return out, max(torch.cuda.max_memory_reserved(dev) - reserved,
                        torch.cuda.max_memory_allocated(dev) - allocated)


class Registry:
    """The live entries of every compiled function on one device, least
    recently used first, each with the bytes its capture left reserved
    (``Entry.resident``), and the captures that make room for themselves
    by evicting them (see the module).  With no memory to hold to (a
    function on the CPU, which captures nothing on its own) it keeps the
    order only.

    `order` maps (a function's weak reference, signature) to the entry,
    so the registry keeps no function alive; the entries of one that is
    dropped are released (zeroed, then dropped) at once, or when the
    capture under way ends.  `lock` guards the bookkeeping only (`order`,
    each function's `entries`, the counts) and is never held while a
    card works or is waited for.  `capturing` lets one capture, with the
    evictions and releases it makes, run on the device at a time: a
    capture reads the device's memory, and no other thread may
    synchronize while a graph is captured.  Live entries of any function
    replay meanwhile."""

    def __init__(self, memory=None):
        self.memory = memory
        self.lock = threading.Lock()
        self.capturing = threading.RLock()
        self.busy = 0            # captures under way (nested in a thread)
        self.order: OrderedDict = OrderedDict()   # (ref, sig) -> Entry
        self.dropped: list = []  # refs of dropped functions, to collect
        self.evictions = 0
        self.retries = 0         # warm-ups run again after running out

    def lookup(self, owner, sig):
        """owner's entry of sig, made the most recently used, or None."""
        with self.lock:
            entry = owner.entries.get(sig)
            if entry is not None:
                self.order.move_to_end((owner.ref, sig))
        if self.dropped:
            self.collect()
        return entry

    def miss(self, owner, sig, capture):
        """owner's entry of sig after a lookup missed it: capture() (a
        capture that makes its room through `captured`), registered as the
        most recently used, owner's oldest entries beyond its max_entries
        evicted."""
        with self.capturing:
            entry = self.lookup(owner, sig)   # another thread's capture
            if entry is None:
                self.busy += 1
                try:
                    entry = capture()
                    with self.lock:
                        self.order[owner.ref, sig] = entry
                        owner.entries[sig] = entry
                        mine = [k for k in self.order if k[0] is owner.ref]
                        victims = self._pop(
                            mine[:max(0, len(mine) - owner.max_entries)])
                    self._release(victims)
                finally:
                    self.busy -= 1
        self.collect()
        return entry

    def _pop(self, keys: list) -> list:
        """Under `lock`: the entries of `keys`, taken out of `order` and
        their functions' `entries`, counted as evictions."""
        victims = []
        for key in keys:
            victims.append(self.order.pop(key))
            owner = key[0]()
            if owner is not None:
                del owner.entries[key[1]]
        self.evictions += len(victims)
        return victims

    @staticmethod
    def _release(entries: list) -> None:
        """Under `capturing`: each evicted entry zeroed, then dropped (its
        release), a ``registry.evict`` span each."""
        for entry in entries:
            with timing.span("registry.evict"):
                entry.release()

    def evict(self, owner) -> None:
        """Evict every entry of owner."""
        with self.capturing:
            with self.lock:
                victims = self._pop([(owner.ref, sig)
                                     for sig in list(owner.entries)])
            self._release(victims)

    def clear(self) -> None:
        """Evict every entry."""
        with self.capturing:
            with self.lock:
                victims = self._pop(list(self.order))
            self._release(victims)

    def dropped_function(self, ref, finalizing=sys.is_finalizing) -> None:
        """A function's weak reference died: its entries go (collect),
        unless the interpreter is shutting down (torch may be gone, and
        the process's memory goes back with it)."""
        if finalizing():
            return
        self.dropped.append(ref)
        self.collect()

    def collect(self) -> None:
        """Release the entries of dropped functions, unless a capture is
        under way or the bookkeeping is held (this runs where the
        collector runs, inside either): then the capture's end or the
        next lookup does it."""
        if not self.capturing.acquire(blocking=False):
            return
        try:
            if self.busy or not self.lock.acquire(blocking=False):
                return
            try:
                refs, self.dropped = self.dropped, []
                victims = [self.order.pop(k) for k in list(self.order)
                           if any(k[0] is r for r in refs)]
            finally:
                self.lock.release()
            for entry in victims:       # released, not evicted
                entry.release()
        finally:
            self.capturing.release()

    def resident(self) -> int:
        """The bytes the live entries' captures left reserved."""
        return sum(e.resident for e in list(self.order.values()))

    def _make_room(self, need: int, keep=None) -> int:
        """Evict least recently used entries, never `keep` (a key of
        `order`), until `need` bytes are free: chosen by their resident
        bytes against one reading of what is free, then read again (a
        pool may hand back less than its entry's resident bytes).
        Returns how many went."""
        free, evicted = self.memory.free(), 0
        while free < need:
            with self.lock:
                keys, freed = [], 0
                for key, entry in self.order.items():
                    if free + freed >= need:
                        break
                    if key != keep:
                        keys.append(key)
                        freed += entry.resident
                victims = self._pop(keys)
            if not victims:
                break
            self._release(victims)
            evicted += len(victims)
            free = self.memory.free()
        return evicted

    def _evict_oldest(self, keep=None) -> int:
        """Evict the least recently used entry but `keep`; how many went
        (0 or 1)."""
        with self.lock:
            key = next((k for k in self.order if k != keep), None)
            victims = self._pop([] if key is None else [key])
        self._release(victims)
        return len(victims)

    def _evictable(self, keep=None) -> bool:
        with self.lock:
            return any(k != keep for k in self.order)

    def allocate(self, fn, need, keep=None):
        """fn(), an eager allocation on the device, outside any graph, of
        `need` bytes (or need(), read once fn has run out), held to the
        card's memory as under jax.jit, where idle compiled functions hold
        nothing.  If fn runs out of memory, least recently used entries of
        any function but `keep` (the key of the entry whose call is under
        way) are evicted until `need` bytes are free, or the oldest one
        where they are free already (the free bytes are split, or fn needs
        more than it said), and fn runs again; torch.OutOfMemoryError is
        raised once nothing is left to evict.  A call of fn that fits
        reads no memory and waits for nothing.  fn must hold no entry's
        lock when it raises: an eviction takes the lock of each victim."""
        evicted = True
        while True:
            try:
                return fn()
            except torch.OutOfMemoryError:
                if (self.memory is None or not evicted
                        or not self._evictable(keep)):
                    raise
            # Out of the except clause: what fn allocated before it ran
            # out is gone.
            evicted = self._evict_for(need() if callable(need) else need,
                                      keep)

    def _evict_for(self, need: int, keep) -> bool:
        """allocate's eviction, under `capturing`: whether any entry went.
        None goes while this thread captures (the capture's warm-up made
        the allocation, and a capture allows no release: the capture's
        own rules make its room)."""
        with self.capturing:
            if self.busy:
                return False
            return bool(self._make_room(need, keep)
                        or self._evict_oldest(keep))

    def captured(self, prepare, record, owner, size: int):
        """Under `capturing`: prepare() (the static copies and the
        warm-up), then record(its result) (the capture, which returns the
        Entry), with the entry's resident bytes set: what the capture left
        reserved and the static inputs.  With memory to hold to, a
        prepare() that runs out of memory runs again after evicting until
        what owner's last capture needed, per byte of its inputs, is free
        for this capture's `size` input bytes, or, where that is free
        already or owner has not captured yet, the least recently used
        entry (raising once nothing is left to evict).  Before record()
        entries are evicted until what prepare() held at its peak is free
        (at least one call's pool: a capture holds what the first warm-up
        call reserved), and after it until the outputs' bytes are, for the
        first replay's copies of them (on a full card the allocator
        recycles the warm-up's cache, so its peak can fall short of a
        capture and a replay)."""
        with timing.span("registry.capture"):
            if self.memory is None:
                return record(prepare())
            while True:
                try:
                    prepared, need = self.memory.peak(prepare)
                    break
                except torch.OutOfMemoryError:
                    if not self.order:
                        raise
                # Out of the except clause: the failed warm-up's tensors are
                # gone.
                self.retries += 1
                guess = int(owner.need_per_byte * size)
                if guess > self.memory.free():
                    self._make_room(guess)
                else:
                    self._evict_oldest()
            if size:
                owner.need_per_byte = need / size
            self._make_room(need)
            before = self.memory.reserved()
            entry = record(prepared)
            entry.resident = (self.memory.reserved() - before
                              + nbytes(entry.inputs))
            self._make_room(nbytes(entry.outputs))
            return entry


_registries: dict = {}
_registries_lock = threading.Lock()


def registry_for(device) -> Registry:
    """The registry of a device: one per device and process, as the
    device's memory is (``cuda`` is the current CUDA device, None the
    CPU, as torch.as_tensor takes it).  Another device's has no memory
    to hold to."""
    device = torch.device(device or "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _registries_lock:
        if device not in _registries:
            _registries[device] = Registry(
                CardMemory(device) if device.type == "cuda" else None)
        return _registries[device]


def allocate(fn, device, need: int):
    """fn(), an eager allocation of `need` bytes on `device` outside any
    graph, through the device's registry (Registry.allocate): on a card
    that idle compiled entries fill, they make room for it.  Elsewhere
    fn() as it is."""
    return registry_for(device).allocate(fn, need)


def to_device(data, device) -> torch.Tensor:
    """torch.as_tensor(data, device=device), data a numpy array or a
    tensor in the dtype it keeps, as an eager allocation of its bytes
    (allocate)."""
    return allocate(partial(torch.as_tensor, data, device=device), device,
                    data.nbytes)


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

    def pool(self):
        """A memory pool that several graphs' captures share."""
        return torch.cuda.graph_pool_handle()

    def graph(self, fn, pool=None):
        """(graph, fn's result): one call of fn captured into `pool`, or a
        private pool."""
        with torch.cuda.device(self.device):
            # keep_graph: the captured graph stays beside its executable,
            # so that a run can count its nodes (raw_cuda_graph).
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=pool):
                out = fn()
            graph.instantiate()
        return graph, out

    def event(self):
        return torch.cuda.Event()

    def step_event(self):
        """The event a chain records on its stream after a step's graph."""
        return torch.cuda.Event()

    def timing_event(self):
        """An event with timing, for a run's device intervals while the
        span recorder is on (timing.card_clock)."""
        return torch.cuda.Event(enable_timing=True)

    def record(self, fn):
        """(fn's result, tallies): fn captures graphs; tallies is the
        change those captures made to the counters and their registered
        maps, which are then restored: a capture records, it runs
        nothing."""
        before = counters.tallies()
        try:
            out = fn()
            tallies = counters.tallies_since(before)
        finally:
            counters.restore(before)
        return out, tallies


def clone_out(outputs):
    """The caller's copies of a replay's static outputs."""
    return map_tensors(outputs, torch.clone)


class Entry:
    """One captured signature: its static input tensors, its graph, the
    static outputs in the graph's pool, what one replay adds to the
    counters (launches, and collectives in their map), the event that
    marks the end of its last use, and the bytes its capture left
    reserved (set by its registry)."""

    def __init__(self, inputs: list, graph, outputs, launches: dict,
                 done=None):
        self.inputs = inputs
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.done = done
        self.waits = []      # events the next replay waits for
        self.resident = 0
        # Reentrant: a call holds it from the lookup through the replay.
        self.lock = threading.RLock()

    def _copy_in(self, tensors: list, stream) -> None:
        """Under the lock: wait for the last use's end (on `stream`, the
        caller's current stream), then copy `tensors` into the static
        inputs."""
        for event in self.waits:
            stream.wait_event(event)
        for dst, src in zip(self.inputs, tensors):
            dst.copy_(src)

    def replay(self, tensors: list, stream=None):
        """Copy `tensors` into the static inputs, replay, and return the
        outputs cloned (clone_out, on `stream`, the caller's current
        stream).  The replay's launches are counted once the clones are
        made: a call whose clones run out of memory runs again whole
        (Graphed.on_card) and counts once."""
        with self.lock:
            self._copy_in(tensors, stream)
            self.graph.replay()
            try:
                out = clone_out(self.outputs)
            finally:
                if self.done is not None:
                    self.done.record(stream)   # a replay on another stream
                    self.waits = [self.done]
            counters.add(self.launches)
        return out

    def scrub(self) -> None:
        """Zero the static inputs: no copy of a caller's key stays in
        them (the next call copies its own inputs in)."""
        with self.lock:
            for t in self.inputs:
                t.zero_()

    def release(self) -> None:
        """Evicted: under the lock (a replay on another thread ends
        first), wait until the last use is done, zero what scrub zeroes
        and let the card finish that, then drop the graph and the static
        tensors, so that the pool can be freed."""
        with self.lock:
            for event in self.waits:
                event.synchronize()
            self.waits = []
            self.scrub()
            for device in {t.device for t in self.inputs if t.is_cuda}:
                torch.cuda.synchronize(device)
            self.graph = self.outputs = None
            self.inputs = []


class _Compiled:
    """What Graphed and Chain share: the device, the Capture, the entries
    by signature (`entries`) and the device's registry, which orders them
    and holds them to the card's memory."""

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
        self.entries: dict = {}
        # Its last capture's warm-up peak per byte of its inputs.
        self.need_per_byte = 0.0
        self.registry = (registry_for(device) if device.type == "cuda"
                         else Registry())

    @property
    def registry(self) -> Registry:
        return self._registry

    @registry.setter
    def registry(self, registry: Registry) -> None:
        """Set before the first entry: `ref`, this function's key in the
        registry, tells it when the function is dropped."""
        self._registry = registry
        self.ref = weakref.ref(self, registry.dropped_function)

    def _check_devices(self, tensors: list) -> None:
        others = {t.device for t in tensors} - {self.device}
        if others:
            raise ValueError(f"graphed: inputs on {sorted(map(str, others))}, "
                             f"the function runs on {self.device}")

    def entry(self, sig: tuple, *capture_args):
        """The entry of `sig`, captured (self.capture(*capture_args)) and
        registered on a miss (see Registry.capture)."""
        entry = self.registry.lookup(self, sig)
        if entry is None:
            entry = self.registry.miss(
                self, sig, partial(self.capture, *capture_args))
        return entry

    def locked(self, sig: tuple, *capture_args):
        """The entry of `sig` (see entry) with its lock taken, for the
        caller to release; looked up again if it was evicted before its
        lock was taken."""
        while True:
            entry = self.entry(sig, *capture_args)
            entry.lock.acquire()
            if entry.graph is not None:
                return entry
            entry.lock.release()

    @contextmanager
    def use(self, sig: tuple, *capture_args):
        """The entry of `sig` with its lock held (see locked)."""
        entry = self.locked(sig, *capture_args)
        try:
            yield entry
        finally:
            entry.lock.release()

    def clear(self) -> None:
        """Evict every entry of this function (zeroed, then dropped)."""
        self.registry.evict(self)

    def scrub(self) -> None:
        """Zero the static tensors of every entry (its scrub)."""
        with self.registry.lock:
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
        return self.on_card(args, kwargs,
                            torch.cuda.current_stream(self.device))

    def on_card(self, args: tuple, kwargs: dict, stream=None):
        """The call on the card: the entry of its signature (captured on a
        miss) replayed on `stream`, its outputs cloned, as an eager
        allocation of their bytes (Registry.allocate): where the clones
        run out of memory, the registry evicts other entries, never this
        one, and the whole call runs again once the entry's lock is let
        go (a capture that evicts takes it)."""
        tensors = tensors_of(args, kwargs)
        self._check_devices(tensors)
        sig = signature(args, kwargs)
        used = []

        def call():
            entry = self.locked(sig, args, kwargs)
            try:
                used[:] = [entry]
                return entry.replay(tensors, stream)
            finally:
                entry.lock.release()
        return self.registry.allocate(
            call, lambda: nbytes(used[0].outputs) if used else 0,
            (self.ref, sig))

    def capture(self, args: tuple, kwargs: dict) -> Entry:
        """Warm fn up on static copies of the tensor arguments, then
        capture one call of it, the room made by the registry."""
        def prepare():
            s_args = tuple(_static(a) for a in args)
            s_kwargs = {k: _static(v) for k, v in kwargs.items()}
            self.capturer.warm_up(partial(self.fn, *s_args, **s_kwargs))
            return s_args, s_kwargs

        def record(static):
            s_args, s_kwargs = static
            (graph, outputs), launches = self.capturer.record(partial(
                self.capturer.graph, partial(self.fn, *s_args, **s_kwargs)))
            return Entry(tensors_of(s_args, s_kwargs), graph, outputs,
                         launches, self.capturer.event())
        return self.registry.captured(prepare, record, self,
                                      nbytes((args, kwargs)))


def graphed(fn, device) -> Graphed:
    """fn compiled per input signature on `device`: the port's jax.jit."""
    return Graphed(fn, device)


def eager_chain(prologue, step, nsteps: int, args: tuple):
    """The chain run as it is: carry = prologue(*args), then for each j
    carry, out = step(j, carry), yielding out.  Nothing runs before the
    first next().  A step is step(j, carry, out=None): given `out` (a
    ring slot, on the card) it writes its outputs into those tensors and
    returns them."""
    carry = prologue(*args)
    for j in range(nsteps):
        carry, out = step(j, carry)
        yield out


def last_output(prologue, step, nsteps: int, args: tuple):
    """The chain run as it is, each step's outputs dropped once the next
    step has made its own: the last step's outputs."""
    return deque(eager_chain(prologue, step, nsteps, args), maxlen=1)[0]


class ChainGraphs:
    """The graphs of one signature of a Chain, captured into one memory
    pool and replayed in this order: the prologue's, then one a step.
    They are dropped together."""

    def __init__(self, prologue, steps: list):
        self.prologue = prologue
        self.steps = steps


def capture_chain(cap, prologue, step, args: tuple, slots: list,
                  nsteps: int):
    """(ChainGraphs, the last carry): prologue(*args), then step j on the
    carry the step before handed on, writing into slots[j % len(slots)],
    each captured by `cap` as a graph of one shared pool.  A Chain
    captures it with its prologue and step only, so that nothing captured
    refers to the Chain."""
    pool = cap.pool()
    first, carry = cap.graph(partial(prologue, *args), pool)
    steps = []
    for j in range(nsteps):
        graph, (carry, _) = cap.graph(
            partial(step, j, carry, slots[j % len(slots)]), pool)
        steps.append(graph)
    return ChainGraphs(first, steps), carry


class ChainEntry(Entry):
    """One captured signature of a Chain: an Entry whose graph is a
    ChainGraphs and whose outputs are the ring's slots (a tuple of static
    tensors each), which records events[j] after step j and keeps the
    last hand-offs (`carry`, ntt(s) or the key among them) to zero them
    in scrub.  pending[k] ends the reads of slot k queued last (None: no
    read is queued); `waits` holds `done`, recorded after a run's last
    step, for the next run's stream."""

    def __init__(self, inputs: list, graph: ChainGraphs, outputs: list,
                 launches: dict, events: list, carry, done=None,
                 timing_event=None):
        super().__init__(inputs, graph, outputs, launches, done)
        self.events = events
        self.carry = carry
        self.pending = [None] * len(outputs)
        self.timing_event = timing_event
        self.spare_events = []   # timing events a finished run read

    def run(self, tensors: list, start, stream=None) -> list:
        """Copy `tensors` in and replay the chain on `stream`, under the
        lock.  Before step j the stream waits for the pending reads of its
        slot; after it, it records events[j], and start(j, the slot,
        events[j]) queues the slot's reads and returns (item, the event
        that ends them, or None).  Returns the items.  While the span
        recorder is on, the run's card clock (its thread's, for start)
        marks the prologue (``dev.prologue``) and each step once its slot's
        wait is over (``dev.step``), by timing events between the graphs."""
        with self.lock:
            self._copy_in(tensors, stream)
            with timing.card_clock(stream, self.timing_event,
                                   self.spare_events) as clock:
                self.graph.prologue.replay()
                if clock:
                    clock.mark("dev.prologue", clock.origin,
                               clock.event(stream))
                items = []
                for j, (graph, event) in enumerate(zip(self.graph.steps,
                                                       self.events)):
                    k = j % len(self.outputs)
                    if self.pending[k] is not None:
                        stream.wait_event(self.pending[k])
                    if clock:
                        clock.limb, begin = j, clock.event(stream)
                    graph.replay()
                    event.record(stream)
                    if clock:
                        clock.mark("dev.step", begin, clock.event(stream))
                    item, self.pending[k] = start(j, self.outputs[k], event)
                    items.append(item)
            counters.add(self.launches)
            if self.done is not None:
                self.done.record(stream)
                self.waits = [self.done]
        return items

    def scrub(self) -> None:
        """Zero the static inputs, the last hand-offs and the slots, once
        the last run and the reads of the slots are done."""
        with self.lock:
            for event in (*self.waits, *self.pending):
                if event is not None:
                    event.synchronize()
            map_tensors((self.inputs, self.carry, self.outputs),
                        torch.Tensor.zero_)

    def release(self) -> None:
        with self.lock:
            super().release()
            self.carry = None
            self.pending = []


class Chain(_Compiled):
    """prologue and step (see eager_chain) compiled per input signature
    on `device` as a ChainEntry (see the module); every step's outputs
    are a tuple of tensors, of the same shapes at every step.  Called as
    chain(args, start), it returns a generator of start's items, one per
    step (see ChainEntry.run); on the CPU each step runs when it is
    reached, its outputs its own, its event None.  `entries` maps each
    live signature to its ChainEntry."""

    def __init__(self, prologue, step, nsteps: int, device):
        super().__init__(device)
        self.prologue = prologue
        self.step = step
        self.nsteps = nsteps

    def __call__(self, args: tuple, start):
        if self.device.type != "cuda":
            steps = eager_chain(self.prologue, self.step, self.nsteps, args)
            for j in range(self.nsteps):
                with timing.span("chain.run"):    # the step, as it is reached
                    item = start(j, next(steps), None)[0]
                yield item
            return
        tensors = tensors_of(args, {})
        self._check_devices(tensors)
        with timing.span("chain.run"):
            with self.use(signature(args, {}), args) as entry:
                items = entry.run(tensors, start,
                                  torch.cuda.current_stream(self.device))
        yield from items

    def capture(self, args: tuple) -> ChainEntry:
        """Warm the chain up on static copies of the tensor arguments,
        then capture it graph by graph into one pool (capture_chain), its
        steps writing into RING_SLOTS slots made like the warm-up's last
        outputs, the room made by the registry."""
        cap = self.capturer

        def prepare():
            s_args = tuple(_static(a) for a in args)
            last = cap.warm_up(partial(last_output, self.prologue, self.step,
                                       self.nsteps, s_args))
            return s_args, [(t.shape, t.dtype) for t in last]

        def record(static):
            s_args, like = static
            slots = [tuple(torch.empty(shape, dtype=dtype, device=self.device)
                           for shape, dtype in like)
                     for _ in range(min(RING_SLOTS, self.nsteps))]
            (graph, carry), launches = cap.record(partial(
                capture_chain, cap, self.prologue, self.step, s_args, slots,
                self.nsteps))
            return ChainEntry(tensors_of(s_args, {}), graph, slots, launches,
                              [cap.step_event() for _ in range(self.nsteps)],
                              carry, cap.event(), cap.timing_event)
        return self.registry.captured(prepare, record, self, nbytes(args))
