"""The graph chain (graphs.Chain) and the compiled per-prime streams
(ckks/stream.py) on the CPU.

graphs.py's pure-Python parts run against a recording fake of its CUDA
side (FakeCapture): a fake graph's replay runs the captured function
again and writes its result into the tensors the capture returned, as a
graph writes the same addresses; a fake step event logs where the chain
records it, a fake stream the events it waits for, and a fake copy of a
ring slot (FakeCopy) reads the slot only when it is waited for, as late
as a card may run it, so a step that wrote the slot before that wait
shows in the copy.  The compiled streams run on the CPU as their entry
points do there (eagerly) and through the fake capture, limb by limb
against seal_embedded_tpu.ckks.stream's jitted streams, bit for bit.
The capture itself needs the card (chip_smoke.py phase 5b)."""

import os
import sys
import threading
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu import api as japi
from seal_embedded_tpu import config as jcfg
from seal_embedded_tpu.ckks import stream as jstream
from seal_embedded_tpu.io import network as jnet
from seal_embedded_tpu_torch import api as tapi
from seal_embedded_tpu_torch import graphs
from seal_embedded_tpu_torch.ckks import stream as tstream
from seal_embedded_tpu_torch.convert import (context_from_jax, parms_from_jax,
                                             pk_to_device, state_to_device)
from seal_embedded_tpu_torch.io import network as tnet
from seal_embedded_tpu_torch.ops import sampling as sp
from seal_embedded_tpu_torch.ops.kernels import counters
from seal_embedded_tpu_torch.parallel import comm
from seal_embedded_tpu_torch.parallel.mesh import Shards

from conftest import seed_bytes

torch.set_num_threads(2)

B = 4
CONFIGS = [(1024, 1), (4096, 3)]
CPU = torch.device("cpu")


# ------------------------------------------------------------- the fake

def _copy_into(dst, src):
    """Write src's tensors into dst's (the same structure)."""
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class FakeGraph:
    """Stands in for a captured CUDAGraph: replay runs the captured fn
    again with the tallies put back (a replay runs no wrapper and no
    collective; the entry adds what the capture recorded) and writes its
    result into the tensors the capture returned."""

    def __init__(self, fn, out, log):
        self.fn, self.out, self.log = fn, out, log

    def replay(self):
        self.log.append(("replay",))
        before = counters.tallies()
        result = self.fn()
        counters.restore(before)
        _copy_into(self.out, result)


class FakeEvent:
    """A step event: logs ("event", j) where the chain records it."""

    def __init__(self, log, j):
        self.log, self.j = log, j

    def record(self, stream=None):
        self.log.append(("event", self.j))


class FakeTimingEvent:
    """An event with timing: record reads a fake card clock that each
    record advances by TICK_MS (the time of one graph or copy), query is
    True once recorded, elapsed_time is the ms between two records."""

    TICK_MS = 0.5
    clock = 0.0

    def __init__(self):
        self.at = None

    def record(self, stream=None):
        FakeTimingEvent.clock += self.TICK_MS
        self.at = FakeTimingEvent.clock

    def query(self):
        return self.at is not None

    def elapsed_time(self, end):
        return end.at - self.at


class FakeCopy:
    """A read of a ring slot queued on a side stream, and the event that
    ends it: the slot is copied into `host` only when the read is waited
    for (a stream's wait_event, synchronize, fetch), the latest a card
    may run it.  `tag` names it in a FakeStream's log."""

    def __init__(self, parts, tag):
        self.parts, self.tag = parts, tag
        self.host = tuple(torch.empty_like(t) for t in parts)
        self.lock = threading.Lock()
        self.done = False

    def synchronize(self):
        with self.lock:
            if not self.done:
                for h, t in zip(self.host, self.parts):
                    h.copy_(t)
                self.done = True

    def fetch(self):
        self.synchronize()
        return self.host


class FakeStream:
    """Records the events a run waits for in `waited` and, given a log, as
    ("wait", the event's tag) there; a FakeCopy waited for runs."""

    def __init__(self, log=None):
        self.waited = []
        self.log = log

    def wait_event(self, event):
        self.waited.append(event)
        if self.log is not None:
            self.log.append(("wait", getattr(event, "tag", event)))
        if isinstance(event, FakeCopy):
            event.synchronize()


class FakePool:
    """A memory pool that a chain's graphs share."""


class FakeCapture(graphs.Capture):
    """graphs.Capture on the CPU: warm-ups run fn, a shared pool logs
    ("pool",), a capture runs fn once and logs ("capture",), a replay
    logs ("replay",), a step event ("event", j); its events with timing
    are FakeTimingEvents."""

    def __init__(self):
        super().__init__(CPU)
        self.log = []
        self.warm_ups = 0
        self.nevents = 0

    def warm_up(self, fn):
        for _ in range(graphs.WARMUP_CALLS):
            self.warm_ups += 1
            out = fn()
        return out

    def pool(self):
        self.log.append(("pool",))
        return FakePool()

    def graph(self, fn, pool=None):
        self.log.append(("capture",))
        out = fn()
        return FakeGraph(fn, out, self.log), out

    def event(self):
        return None

    def step_event(self):
        self.nevents += 1
        return FakeEvent(self.log, self.nevents - 1)

    def timing_event(self):
        return FakeTimingEvent()

    def kinds(self, kind):
        return [e[1:] for e in self.log if e[0] == kind]


def faked(compiled):
    """A Chain or Graphed with the fake capture in place; returns it."""
    compiled.capturer = FakeCapture()
    return compiled


def cloned(j, out, event):
    """A start that copies a step's outputs out at once; no event ends
    the reads."""
    return tuple(t.clone() for t in out), None


def copied(j, out, event):
    """A start that queues a FakeCopy of step j's slot, as the stream's
    copy to host memory; the copy ends the slot's reads."""
    read = FakeCopy(out, j)
    return read, read


def run_chain(chain, *args, start=copied, stream=None):
    """What Chain.__call__ does on the card: at the first next(), the
    entry of the signature (captured on a miss) and a run of it on
    `stream` (by default a FakeStream logging into the capture's log);
    a FakeCopy item is yielded as its host tensors, fetched."""
    if stream is None:
        stream = FakeStream(chain.capturer.log)
    entry = chain.entry(graphs.signature(args, {}), args)
    for item in entry.run(graphs.tensors_of(args, {}), start, stream):
        yield item.fetch() if isinstance(item, FakeCopy) else item


def into(out, parts):
    """A step's outputs: `parts`, or, given a ring slot `out`, parts
    written into it (graphs.eager_chain's step contract)."""
    if out is None:
        return parts
    for dst, src in zip(out, parts):
        dst.copy_(src)
    return out


def _toy_chain(nsteps=3, launches_per_step=0):
    """A chain whose prologue doubles x and whose step j adds j + 1 to a
    running sum it hands on, yielding (sum, x + sum); each step adds
    launches_per_step to the "ntt" counter and counts one all-gather of
    its output, as a wrapper and a collective would."""
    def prologue(x):
        return 2 * x, torch.zeros_like(x)

    def step(j, carry, out=None):
        x2, total = carry
        total = total + (j + 1)
        counters.add(dict(dict.fromkeys(counters.COUNTERS, 0),
                          ntt=launches_per_step))
        parts = (total.clone(), x2 + total)
        comm._count("all_gather", parts[1])
        return (x2, total), into(out, parts)
    return faked(graphs.Chain(prologue, step, nsteps, CPU))


def _eager_toy(x, nsteps=3):
    x2, total, outs = 2 * x, torch.zeros_like(x), []
    for j in range(nsteps):
        total = total + (j + 1)
        outs.append((total.clone(), x2 + total))
    return outs


def _equal_outs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


# ------------------------------------------------------------ the chain

def test_chain_is_one_graph_with_an_event_per_step_replayed_whole():
    """One signature's graphs, the prologue's and one a step, captured
    into one pool and replayed whole at a run, an event after each step;
    step j + 2 writes step j's ring slot only after the stream waited for
    step j's copy, and so does step 0 or 1 of the next run for the copies
    still pending."""
    chain = _toy_chain()
    x = torch.arange(6)
    outs = list(run_chain(chain, x))
    _equal_outs(outs, _eager_toy(x))
    cap = chain.capturer
    assert cap.warm_ups == graphs.WARMUP_CALLS
    assert graphs.RING_SLOTS == 2
    replay, event = ("replay",), [("event", j) for j in range(3)]
    run = [replay, replay, event[0], replay, event[1], ("wait", 0), replay,
           event[2]]
    assert cap.log == [("pool",), *[("capture",)] * 4, *run]
    _equal_outs(list(run_chain(chain, x + 1)), _eager_toy(x + 1))
    assert cap.log[-10:] == [replay, ("wait", 2), replay, event[0],
                             ("wait", 1), *run[3:]]
    assert len(cap.kinds("pool")) == 1 and len(chain.entries) == 1


def test_chain_of_13_limbs_is_one_entry():
    chain = _toy_chain(nsteps=13)
    for seed in range(3):
        x = torch.full((5,), seed)
        _equal_outs(list(run_chain(chain, x)), _eager_toy(x, 13))
    assert len(chain.entries) == 1
    entry, = chain.entries.values()
    assert len(entry.events) == len(entry.graph.steps) == 13
    assert len(entry.outputs) == graphs.RING_SLOTS
    assert len(chain.capturer.kinds("pool")) == 1
    # A second signature is a second entry, not 13 more.
    list(run_chain(chain, torch.zeros(7, dtype=torch.int64)))
    assert len(chain.entries) == 2
    assert len(chain.capturer.kinds("pool")) == 2


def test_chain_starts_every_step_at_the_first_next():
    """The replay and every step's start happen at the first next(), in
    step order, each with its step's event; later next() calls only hand
    the items on."""
    chain = _toy_chain()
    x = torch.arange(4)
    list(run_chain(chain, x))
    entry, = chain.entries.values()
    calls = []

    def start(j, out, event):
        calls.append((j, event))
        return cloned(j, out, event)
    run = run_chain(chain, x, start=start)
    assert not calls                                  # nothing before next()
    first = next(run)
    assert calls == list(enumerate(entry.events))
    _equal_outs([first, *run], _eager_toy(x))
    assert len(calls) == 3


def test_chain_outputs_own_their_memory():
    """An item a start copied out survives later runs, and the copies the
    stream makes in host memory are its own, not the ring's slots."""
    chain = _toy_chain()
    x = torch.arange(4)
    got = list(run_chain(chain, x))
    entry, = chain.entries.values()
    kept = [tuple(t.clone() for t in out) for out in got]
    list(run_chain(chain, x + 10))                    # overwrites the pool
    _equal_outs(got, kept)
    pool = {t.data_ptr() for out in entry.outputs for t in out}
    ptrs = [t.data_ptr() for out in got for t in out]
    assert len(set(ptrs)) == len(ptrs) and not pool & set(ptrs)


def test_next_replay_waits_for_the_reads_start_queued():
    """The stream waits for the reads start queued of a slot before a
    step writes it again: in the run (step 2 after read 0) and in the
    next (steps 0 and 1 after reads 2 and 1), and for no other."""
    chain = _toy_chain()
    x = torch.arange(3)
    list(run_chain(chain, x, start=cloned))
    reads = [object() for _ in range(3)]
    stream = FakeStream()
    list(run_chain(chain, x, stream=stream, start=lambda j, out, ev: (
        cloned(j, out, ev)[0], reads[j])))
    entry, = chain.entries.values()
    assert stream.waited == reads[:1]
    assert entry.pending == [reads[2], reads[1]]
    stream = FakeStream()
    list(run_chain(chain, x, start=cloned, stream=stream))
    assert stream.waited == [reads[2], reads[1]]
    assert entry.pending == [None, None]


def test_chain_adds_tallies_per_replay():
    chain = _toy_chain(launches_per_step=5)
    x = torch.arange(8)
    before = counters.tallies()
    try:
        entry = chain.entry(graphs.signature((x,), {}), (x,))
        warm = counters.since(before)["ntt"]
        assert warm == 5 * 3 * graphs.WARMUP_CALLS   # the warm-ups ran
        gathers = counters.tallies_since(before)["comm"]["all_gather"][0]
        assert gathers == 3 * graphs.WARMUP_CALLS
        for r in range(1, 3):
            entry.run([x], cloned)
            got = counters.tallies_since(before)
            assert got["ntt"] == warm + 5 * 3 * r
            assert got["comm"]["all_gather"][0] == gathers + 3 * r
    finally:
        counters.restore(before)


def test_abandoned_chain_leaves_the_next_run_its_own():
    """A run left after its first limb keeps its later limbs, read after
    another run wrapped the ring twice; the next run sees its own, and a
    run dropped after its first limb leaves the one after it its own."""
    chain = _toy_chain(nsteps=5)
    cap = chain.capturer
    x, y = torch.arange(5), torch.arange(5) * 7
    abandoned = run_chain(chain, y)
    _equal_outs([next(abandoned)], _eager_toy(y, 5)[:1])
    cap.log.clear()
    _equal_outs(list(run_chain(chain, x)), _eager_toy(x, 5))
    assert len(cap.kinds("replay")) == 1 + 5
    _equal_outs(list(abandoned), _eager_toy(y, 5)[1:])
    dropped = run_chain(chain, y)
    next(dropped)
    del dropped
    _equal_outs(list(run_chain(chain, x)), _eager_toy(x, 5))


def test_interleaved_chain_runs_keep_their_inputs():
    """Two runs of one entry in turn, limb by limb, over a chain that
    wraps the ring: each sees its own inputs (a run's reads are queued at
    its replay, and the other's steps wait for them)."""
    chain = _toy_chain(nsteps=5)
    x, y = torch.arange(5), torch.arange(5) * 7
    a, b = run_chain(chain, x), run_chain(chain, y)
    got_a, got_b = [], []
    for _ in range(5):
        got_a.append(next(a))
        got_b.append(next(b))
    _equal_outs(got_a, _eager_toy(x, 5))
    _equal_outs(got_b, _eager_toy(y, 5))
    assert len(chain.entries) == 1


def test_chain_runs_from_many_threads_keep_their_inputs():
    """More threads than cores and a short switch interval, all running
    one entry: every run's outputs are its own inputs' (the entry's lock
    keeps copy-in, replay and the starts together)."""
    chain = _toy_chain()
    list(run_chain(chain, torch.zeros(16, dtype=torch.int64)))   # capture
    failures = []

    def worker(tag):
        for i in range(50):
            x = torch.full((16,), tag * 1000 + i)
            got = list(run_chain(chain, x))
            want = _eager_toy(x)
            if not all(torch.equal(a, b) for g, w in zip(got, want)
                       for a, b in zip(g, w)):
                failures.append((tag, i))

    before = counters.tallies()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        counters.restore(before)
    assert not failures and len(chain.entries) == 1


def test_chain_scrub_zeroes_inputs_handoffs_and_outputs():
    """Scrub zeroes the static input, the two hand-offs and every ring
    slot, after the reads still pending of the slots (a run left after
    its first limb keeps its limbs)."""
    chain = _toy_chain()
    x = torch.arange(1, 6)
    list(run_chain(chain, x))
    left = run_chain(chain, x + 3)
    next(left)
    chain.scrub()
    entry, = chain.entries.values()
    leaves = []
    graphs.map_tensors((entry.inputs, entry.carry, entry.outputs),
                       leaves.append)
    assert len(leaves) == 1 + 2 + 2 * graphs.RING_SLOTS
    assert not any(bool(t.any()) for t in leaves)
    _equal_outs(list(left), _eager_toy(x + 3)[1:])
    _equal_outs(list(run_chain(chain, x)), _eager_toy(x))


def test_chain_carries_the_sampler_counter_across_2_32_and_2_64():
    """The counter a step hands on crosses 2^32 (a carry into hi) and
    2^64 (a wrap) as it does eagerly, over four steps that wrap the ring,
    captured and replayed."""
    n, q = 64, int(jcfg.default_parms(1024, 1).moduli[0])
    seeds = torch.as_tensor(np.random.default_rng(3).integers(
        0, 2 ** 32, (2, 16)))
    start = torch.tensor([[2 ** 32 - 2, 0], [2 ** 32 - 2, 2 ** 32 - 1]])

    def prologue(seed_words, counter):
        return seed_words, counter.clone()

    def step(j, carry, out=None):
        seed_words, counter = carry
        a, counter, ok = sp.sample_uniform(seed_words, counter, n, q)
        return (seed_words, counter), into(out, (a, counter.clone(), ok))
    chain = faked(graphs.Chain(prologue, step, 4, CPU))
    want = list(graphs.eager_chain(prologue, step, 4, (seeds, start)))
    for _ in range(2):                      # the capture, then a replay
        got = list(run_chain(chain, seeds, start))
        _equal_outs(got, want)
        assert int(got[-1][1][0, 1]) == 1       # carried into hi
        assert int(got[-1][1][1, 1]) == 0       # wrapped at 2^64


# ------------------------------------------- graphs.py for scale-out

def test_map_tensors_keeps_shards_and_index():
    sh = Shards({"c0": torch.arange(3), "ok": torch.ones(2, dtype=torch.bool)},
                {"c0": (slice(0, 1), slice(2, 5)), "ok": (slice(2, 4),)})
    out = graphs.map_tensors(sh, torch.clone)
    assert type(out) is Shards and out.index == sh.index
    assert out.keys() == sh.keys()
    assert all(torch.equal(out[k], sh[k]) and out[k] is not sh[k]
               for k in sh)
    plain = graphs.map_tensors({"a": (torch.zeros(1),)}, torch.clone)
    assert type(plain) is dict and type(plain["a"]) is tuple


def test_collective_counts_captured_once_added_per_replay():
    """A capture leaves comm.counts as the warm-ups left them; each replay
    adds one call's collectives, so a capture and three replays count as
    the warm-ups plus three eager calls."""
    def fn(x):
        comm._count("all_gather", torch.cat([x, x]))
        comm._count("all_reduce", x[:1])
        return x + 1

    x = torch.arange(4)
    saved = comm.counts
    try:
        comm.counts = {}
        for _ in range(3 + graphs.WARMUP_CALLS):
            fn(x)
        eager = {k: list(v) for k, v in comm.counts.items()}
        comm.counts = {}
        g = faked(graphs.Graphed(fn, CPU))
        entry = g.entry(graphs.signature((x,), {}), (x,), {})
        assert comm.counts == {"all_gather": [2, 128],
                               "all_reduce": [2, 16]}
        for _ in range(3):
            assert torch.equal(entry.replay([x]), x + 1)
        assert comm.counts == eager
    finally:
        comm.counts = saved


# ------------------------------------------------- the compiled streams

def _inputs(n, seed, b=B):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, n // 2)).astype(np.float32),
            (rng.integers(0, 3, n) - 1).astype(np.int32),
            rng.integers(0, 2 ** 32, (b, 16)).astype(np.uint32),
            rng.integers(0, 2 ** 32, (b, 16)).astype(np.uint32))


def _keys(P, seed):
    rng = np.random.default_rng(seed)
    return tuple(np.stack([rng.integers(0, q, P.degree) for q in P.moduli])
                 .astype(np.uint32) for _ in range(2))


@lru_cache(maxsize=None)
def _jax_limbs(kind, n, nprimes, order, b=B, seed=5, key_seed=6):
    """The JAX stream's limbs on _inputs(n, seed, b) (asym: under
    _keys(P, key_seed))."""
    P = jcfg.default_parms(n, nprimes)
    values, sk, share, err = _inputs(n, seed, b)
    if kind == "sym":
        gen = jstream.sym_encrypt_stream(
            *map(jnp.asarray, (values, sk, share, err)), P, "f64", order)
    else:
        pk0, pk1 = _keys(P, key_seed)
        gen = jstream.asym_encrypt_stream(
            *map(jnp.asarray, (values, pk0, pk1, err)), P, "f64", order)
    return [(l["prime_idx"], np.asarray(l["c0"]), np.asarray(l["c1"]))
            for l in gen]


def _port_args(kind, n, nprimes, b=B, seed=5, key_seed=6):
    P = jcfg.default_parms(n, nprimes)
    values, sk, share, err = state_to_device(*_inputs(n, seed, b),
                                             device=CPU)
    if kind == "sym":
        return values, sk, share, err
    return (values, *pk_to_device(*_keys(P, key_seed), device=CPU), err)


def _fetched(s):
    """A start that does what the stream's does on the card: one
    _HostFetch item a limb, its copy of the ring slot to host memory a
    FakeCopy, which _fetch waits for."""
    def start(j, parts, ready):
        read = FakeCopy(parts, j)
        return (*s.walk[j], read.host, read), read
    return start


def _require_limbs(limbs, want):
    assert [l["prime_idx"] for l in limbs] == [w[0] for w in want]
    for l, (_, c0, c1) in zip(limbs, want):
        assert l["ok"] and l["c0"].dtype == np.uint32
        assert np.array_equal(l["c0"], c0) and np.array_equal(l["c1"], c1)


STREAMS = [("sym", "forward"), ("sym", "reverse"), ("asym", "forward")]


@pytest.mark.parametrize("n,nprimes", CONFIGS)
@pytest.mark.parametrize("kind,order", STREAMS)
def test_compiled_stream_vs_jax(kind, order, n, nprimes):
    """The compiled stream of (parms, order) on the CPU, as its entry point
    runs it and through the fake capture (twice, the second a replay),
    limb by limb bit-equal to the JAX stream's."""
    P = parms_from_jax(jcfg.default_parms(n, nprimes))
    want = _jax_limbs(kind, n, nprimes, order)
    factory = tstream.sym_stream if kind == "sym" else tstream.asym_stream
    s = factory(P, order, "cpu")
    assert s is factory(P, order, CPU)              # cached
    args = _port_args(kind, n, nprimes)
    _require_limbs(list(s(*args)), want)
    chain = faked(graphs.Chain(s.chain.prologue, s.chain.step,
                               s.chain.nsteps, CPU))
    for _ in range(2):
        _require_limbs(list(map(tstream._fetch, run_chain(
            chain, *args, start=_fetched(s)))), want)
    assert len(chain.capturer.kinds("pool")) == 1


@pytest.mark.parametrize("nprimes", [3, 13])
def test_stream_ring_holds_two_limbs_whatever_the_chain(nprimes):
    """The compiled sym stream's limb outputs (through the fake capture)
    are RING_SLOTS slots of one limb's int32 c0, c1 and its ok, as many
    bytes at L = 3 as at L = 13 (n = 64, PRIMES_30BIT), and its limbs,
    captured and replayed, are the eager stream's."""
    b, n = 3, 64
    P = parms_from_jax(jcfg.Parms(degree=n, moduli=jcfg.PRIMES_30BIT[:nprimes],
                                  scale=2.0 ** 25))
    s = tstream.sym_stream(P, "forward", "cpu")
    args = state_to_device(*_inputs(n, 11, b), device=CPU)
    want = [(l["prime_idx"], l["c0"], l["c1"]) for l in s(*args)]
    chain = faked(graphs.Chain(s.chain.prologue, s.chain.step,
                               s.chain.nsteps, CPU))
    for _ in range(2):
        _require_limbs(list(map(tstream._fetch, run_chain(
            chain, *args, start=_fetched(s)))), want)
    entry, = chain.entries.values()
    assert len(entry.outputs) == graphs.RING_SLOTS == 2
    assert graphs.nbytes(entry.outputs) == 2 * (2 * b * n * 4 + b)
    assert len(entry.graph.steps) == len(entry.events) == nprimes


def test_interleaved_asym_streams_of_two_signatures_keep_their_keys():
    """Two asym streams of one compiled stream, different B and different
    keys, limb by limb in turn, eagerly and through the fake capture (two
    entries of one chain): each is the JAX stream under its own key."""
    P = parms_from_jax(jcfg.default_parms(4096, 3))
    s = tstream.asym_stream(P, "forward", "cpu")
    cases = [dict(b=B, seed=5, key_seed=6), dict(b=2, seed=9, key_seed=10)]
    wants = [_jax_limbs("asym", 4096, 3, "forward", **c) for c in cases]
    args = [_port_args("asym", 4096, 3, **c) for c in cases]
    chain = faked(graphs.Chain(s.chain.prologue, s.chain.step,
                               s.chain.nsteps, CPU))
    for runs in ([s(*a) for a in args],
                 [map(tstream._fetch, run_chain(chain, *a,
                                                start=_fetched(s)))
                  for a in args],
                 [map(tstream._fetch, run_chain(chain, *a,
                                                start=_fetched(s)))
                  for a in args]):
        got = [[], []]
        for _ in range(3):
            for k, run in enumerate(runs):
                got[k].append(next(run))
        for limbs, want in zip(got, wants):
            _require_limbs(limbs, want)
    assert len(chain.entries) == 2
    assert len(chain.capturer.kinds("pool")) == 2


@pytest.mark.parametrize("kind", ["sym", "asym"])
def test_cached_se_encrypt_streaming_vs_jax(kind):
    """Two calls of se_encrypt_streaming send the JAX function's bytes;
    both run the context's cached stream, which se_cleanup scrubs."""
    jp = jcfg.default_parms(1024, 1)
    values, sk, _, _ = _inputs(1024, 7)
    if kind == "asym":
        pk0, pk1 = _keys(jp, 8)
        jctx = japi.SEContext(parms=jp, encrypt_type=japi.ASYM, sk_signed=sk,
                              pk0=pk0, pk1=pk1)
    else:
        jctx = japi.SEContext(parms=jp, encrypt_type=japi.SYM, sk_signed=sk)
    share = [seed_bytes(30 + b) for b in range(B)]
    err = [seed_bytes(40 + b) for b in range(B)]
    jsend, jstore = jnet.collecting_sender()
    jstream.se_encrypt_streaming(jctx, values, share, err, jsend)
    ctx = context_from_jax(jctx, "cpu")
    for _ in range(2):
        tsend, tstore = tnet.collecting_sender()
        tstream.se_encrypt_streaming(ctx, values, share, err, tsend)
        assert tstore == jstore
    factory = tstream.sym_stream if kind == "sym" else tstream.asym_stream
    assert ctx._streams == {factory(ctx.parms, "forward", "cpu")}
    tapi.se_cleanup(ctx)
    assert not ctx._streams
    stream = factory(parms_from_jax(jp), "forward", "cpu")
    if kind == "asym":
        assert not stream.steps.enc.pk0.any()   # the stream sets no key
