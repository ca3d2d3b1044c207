"""The device registry of compiled entries (graphs.Registry) on the CPU.

graphs.py's capture and eviction run against a fake card: a fake capture
(CardCapture, the recording FakeCapture of test_torch_chain.py) holds
bytes of a FakeCard while it warms up and in its graph's pool, and the
card hands them back once the graph is dropped, as the allocator frees a
private pool once its graph and tensors are gone.  The registry reads the
fake card where it reads torch.cuda on the card.  The sequence case runs
the port's SymEncryptor (its plain path) through the registry, call by
call against seal_embedded_tpu.ckks.fast.make_fused_encryptor on the
same numpy inputs, bit for bit.  The caller's tensors are charged to the
fake card too where the card would hold them: a replay's clones of its
outputs (charge_clones) and the port's uploads and casts (ChargingRegistry),
so that held outputs and uploads on a card full of idle entries make
their room, as under jax.jit.  The card itself runs chip_smoke.py
phase 12."""

import gc
import threading
import time
import weakref
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu import api as japi
from seal_embedded_tpu import config as jcfg
from seal_embedded_tpu.ckks import fast as jfast
from seal_embedded_tpu.ckks import stream as jstream
from seal_embedded_tpu.io import network as jnet
from seal_embedded_tpu_torch import api as tapi
from seal_embedded_tpu_torch import graphs
from seal_embedded_tpu_torch.ckks import stream as tstream
from seal_embedded_tpu_torch.ckks.fast import SymEncryptor
from seal_embedded_tpu_torch.convert import parms_from_jax, state_to_device
from seal_embedded_tpu_torch.io import network as tnet
from seal_embedded_tpu_torch.ops.kernels import counters
from seal_embedded_tpu_torch.utils import timing

from conftest import seed_bytes
from test_torch_api import fake_pinned
from test_torch_chain import (FakeCapture, FakeStream, _eager_toy,
                              _toy_chain, cloned)

torch.set_num_threads(2)

CPU = torch.device("cpu")
UNIT = 1 << 20      # the toy functions' pool, in fake bytes


# ------------------------------------------------------------- the spans

_SPANS = []


@pytest.fixture(autouse=True)
def _recording():
    """The span recorder on through every test here, what it recorded
    before the test dropped."""
    timing.take_spans()
    _SPANS.clear()
    timing.record_spans(True)
    yield
    timing.record_spans(False)
    timing.take_spans()


def _count(name):
    """The spans `name` recorded since the test began: one
    ``registry.capture`` a capture, one ``registry.evict`` an eviction."""
    _SPANS.extend(timing.take_spans())
    return sum(s.name == name for s in _SPANS)


# ------------------------------------------------------------- the fakes

class FakeCard:
    """A card of `total` bytes: alloc hands out a block, which holds its
    bytes until it is dropped, and raises torch.OutOfMemoryError past the
    total.  free, reserved and peak are graphs.CardMemory's."""

    def __init__(self, total):
        self.total = total
        self.used = 0
        self.high = 0

    def alloc(self, n):
        if self.used + n > self.total:
            raise torch.OutOfMemoryError(
                f"fake card: {n} bytes asked, {self.total - self.used} free")
        self.used += n
        self.high = max(self.high, self.used)
        return _Block(self, n)

    def free(self):
        return self.total - self.used

    def reserved(self):
        return self.used

    def peak(self, fn):
        start = self.high = self.used
        out = fn()
        return out, self.high - start


class _Block:
    def __init__(self, card, n):
        self.card, self.n = card, n

    def __del__(self):
        self.card.used -= self.n


class CardCapture(FakeCapture):
    """FakeCapture on a FakeCard: each warm-up call's pool (`size` of its
    result, its outputs' bytes by default) is held until the next call's
    is made, so a warm-up peaks at two calls'; a captured graph holds one
    call's pool until it is dropped, a chain's graphs the pool they share
    (`size` of the first graph's result) until the last is dropped."""

    def __init__(self, card, size=graphs.nbytes):
        super().__init__()
        self.card, self.size = card, size

    def warm_up(self, fn):
        held = []
        for _ in range(graphs.WARMUP_CALLS):
            self.warm_ups += 1
            out = fn()
            held = held[-1:] + [self.card.alloc(self.size(out))]
        return out

    def graph(self, fn, pool=None):
        graph, out = super().graph(fn, pool)
        if pool is None:
            graph.pool = self.card.alloc(self.size(out))
        else:
            if not hasattr(pool, "block"):
                pool.block = self.card.alloc(self.size(out))
            graph.pool = pool
        return graph, out


def charged(card, out):
    """out, each of its tensors holding its bytes of `card` until it is
    dropped (torch.OutOfMemoryError past the card), as the card holds a
    tensor made there."""
    def hold(t):
        t.held = card.alloc(t.nbytes)
        return t
    return graphs.map_tensors(out, hold)


def charge_clones(monkeypatch, card):
    """Every replay's clones of its outputs (graphs.clone_out) made on
    `card`: a clone past the card raises under the entry's lock, as on
    the card."""
    monkeypatch.setattr(graphs, "clone_out", lambda outputs: charged(
        card, graphs.map_tensors(outputs, torch.clone)))


class ChargingRegistry(graphs.Registry):
    """A Registry whose eager allocations (Registry.allocate: the port's
    uploads and casts, a replay's whole call) are made on its fake card:
    each tensor they return is charged there."""

    def allocate(self, fn, need, keep=None):
        return super().allocate(lambda: charged(self.memory, fn()), need,
                                keep)


def on_card(compiled, registry, size=graphs.nbytes):
    """A Graphed or Chain on the CPU made to capture on registry's fake
    card, in that registry."""
    compiled.capturer = CardCapture(registry.memory, size)
    compiled.registry = registry
    return compiled


def call(g, *args):
    """What Graphed.__call__ does on the card."""
    return g.on_card(args, {})


def run(chain, *args, start=cloned):
    """What Chain.__call__ does on the card, whole, on a FakeStream."""
    with chain.use(graphs.signature(args, {}), args) as entry:
        return entry.run(graphs.tensors_of(args, {}), start, FakeStream())


def _const(n):
    return lambda out: n


def _toy(fn, registry, size=_const(UNIT), max_entries=graphs.MAX_ENTRIES):
    return on_card(graphs.Graphed(fn, CPU, max_entries), registry, size)


def _double(x):
    return {"y": 2 * x}


def _plus_one(x):
    return {"y": x + 1}


def _leaves(*objs):
    out = []
    graphs.map_tensors(objs, out.append)
    return out


def _zero(tensors):
    return not any(bool(t.any()) for t in tensors)


# ------------------------------------------------------- the sequence

SEQUENCE = (2, 4, 6, 8, 2)


def _sym_inputs(b, n=1024, seed=3):
    rng = np.random.default_rng(seed + b)
    return (rng.uniform(-1, 1, (b, n // 2)).astype(np.float32),
            (rng.integers(0, 3, n) - 1).astype(np.int32),
            rng.integers(0, 2 ** 32, (b, 16)).astype(np.uint32),
            rng.integers(0, 2 ** 32, (b, 16)).astype(np.uint32))


def test_signatures_beyond_the_card_all_run_and_equal_jax():
    """Batches of 2, 4, 6 and 8 messages, each fitting the fake card
    alone, whose pools together do not (so eviction by count, 8 a
    function, would run out): every call completes, each equal to the JAX
    fused encryptor on the same inputs, and the last B = 2 is captured
    again after its eviction."""
    P = jcfg.default_parms(1024, 1)
    enc = SymEncryptor(parms_from_jax(P), CPU)
    inputs = {b: _sym_inputs(b) for b in SEQUENCE}
    pools = {b: graphs.nbytes(enc(*state_to_device(*inputs[b], device=CPU)))
             for b in set(SEQUENCE)}
    card = FakeCard(2 * max(pools.values()))
    assert sum(pools.values()) > card.total
    reg = graphs.Registry(card)
    g = on_card(graphs.Graphed(enc, CPU), reg)
    jfn = jfast.make_fused_encryptor(P, "f64")
    for b in SEQUENCE:
        out = call(g, *state_to_device(*inputs[b], device=CPU))
        want = jfn(*map(jnp.asarray, inputs[b]))
        for k in ("c0", "c1", "pt", "pte", "ok"):
            got = out[k].numpy()
            assert np.array_equal(got, np.asarray(want[k]).astype(got.dtype)
                                  ), (b, k)
        assert card.used <= card.total
    assert reg.evictions == 3
    assert _count("registry.evict") == reg.evictions
    assert len(g.capturer.kinds("capture")) == len(SEQUENCE)
    assert _count("registry.capture") == len(SEQUENCE)
    assert [e.resident - graphs.nbytes(e.inputs)
            for e in reg.order.values()] == [pools[8], pools[2]]


# --------------------------------------- eager allocations on a full card

HELD = 4


def test_held_outputs_beside_idle_entries_run_and_equal_jax(monkeypatch):
    """A loop that holds every output, as `outs.append(f(x))` does, on a
    card that three idle entries of another function and the live entry
    fill: each call's clones evict the least recently used idle entry
    and run again, so all HELD calls complete, each equal to the JAX
    fused encryptor on the same inputs, and the live entry is never
    evicted (one capture)."""
    P = jcfg.default_parms(1024, 1)
    enc = SymEncryptor(parms_from_jax(P), CPU)
    inputs = [_sym_inputs(2, seed=10 + 7 * i) for i in range(HELD)]
    out_bytes = graphs.nbytes(enc(*state_to_device(*inputs[0], device=CPU)))
    card = FakeCard(5 * out_bytes)
    reg = graphs.Registry(card)
    charge_clones(monkeypatch, card)
    other = _toy(_double, reg, _const(out_bytes))
    for k in (3, 4, 5):
        call(other, torch.arange(k))
    g = on_card(graphs.Graphed(enc, CPU), reg)
    jfn = jfast.make_fused_encryptor(P, "f64")
    held = []
    for i in range(HELD):
        held.append(call(g, *state_to_device(*inputs[i], device=CPU)))
        want = jfn(*map(jnp.asarray, inputs[i]))
        for k in ("c0", "c1", "pt", "pte", "ok"):
            got = held[-1][k].numpy()
            assert np.array_equal(got, np.asarray(want[k]).astype(got.dtype)
                                  ), (i, k)
    assert reg.evictions == 3 and not other.entries
    assert _count("registry.evict") == reg.evictions
    assert len(g.capturer.kinds("capture")) == 1 and len(g.entries) == 1
    assert _count("registry.capture") == 4
    assert card.used == card.total


def test_allocation_never_evicts_the_entry_under_way():
    """Registry.allocate evicts least recently used entries for an
    allocation that runs out, but never `keep`, even where it is the
    oldest; with nothing else left it raises torch.OutOfMemoryError."""
    card = FakeCard(4 * UNIT)
    reg = graphs.Registry(card)
    g1, g2, g3 = (_toy(fn, reg) for fn in (_double, _plus_one, _double))
    a = torch.arange(3)
    for g in (g1, g2, g3):
        call(g, a)
    entry, = g1.entries.values()
    keep = (g1.ref, graphs.signature((a,), {}))
    assert next(iter(reg.order)) == keep            # the oldest
    block = reg.allocate(lambda: card.alloc(3 * UNIT), 3 * UNIT, keep)
    assert not g2.entries and not g3.entries and reg.evictions == 2
    assert _count("registry.evict") == reg.evictions
    assert g1.entries == {keep[1]: entry} and entry.graph is not None
    with pytest.raises(torch.OutOfMemoryError):
        reg.allocate(lambda: card.alloc(UNIT), UNIT, keep)
    assert entry.graph is not None and reg.evictions == 2
    assert _count("registry.evict") == reg.evictions
    del block
    assert reg.allocate(lambda: card.alloc(UNIT), UNIT, keep).n == UNIT


def test_held_outputs_beyond_the_card_raise_once_nothing_is_left(
        monkeypatch):
    """Held outputs evict the idle entry of another function, then fill
    the card: the next call raises torch.OutOfMemoryError, its entry
    still live and the card as before; once an output is dropped the
    entry replays again without a capture."""
    card = FakeCard(5 * UNIT)
    reg = graphs.Registry(card)
    charge_clones(monkeypatch, card)
    other = _toy(_plus_one, reg)
    call(other, torch.arange(3))
    g = _toy(_double, reg)
    x = torch.arange(UNIT // 8)                      # outputs of one UNIT
    held = [call(g, x + i) for i in range(4)]
    entry, = g.entries.values()
    assert not other.entries and reg.evictions == 1
    assert _count("registry.evict") == reg.evictions
    with pytest.raises(torch.OutOfMemoryError):
        call(g, x)
    assert g.entries == {graphs.signature((x,), {}): entry}
    assert entry.graph is not None and card.used == card.total
    held.pop(0)
    assert torch.equal(call(g, x + 9)["y"], 2 * (x + 9))
    assert len(g.capturer.kinds("capture")) == 1 and reg.evictions == 1
    assert _count("registry.evict") == reg.evictions
    assert all(torch.equal(h["y"], 2 * (x + i + 1))
               for i, h in enumerate(held[:3]))


def test_a_retried_call_counts_its_launches_once(monkeypatch):
    """A call whose clones ran out runs again whole (copy-in, replay,
    clone): its launches are added to the counters once."""
    card = FakeCard(4 * UNIT)
    reg = graphs.Registry(card)
    charge_clones(monkeypatch, card)
    launches = dict(dict.fromkeys(counters.COUNTERS, 0), ntt=3, encode=1)

    def counted(x):
        counters.add(launches)
        return {"y": 3 * x + 1}

    other = _toy(_plus_one, reg)
    call(other, torch.arange(3))
    g = _toy(counted, reg)
    x = torch.arange(UNIT // 8)
    before = counters.tallies()
    try:
        held = [call(g, x), call(g, x + 1)]
        mark = counters.read()
        held.append(call(g, x + 2))            # runs out, evicts, again
        assert reg.evictions == 1 and not other.entries
        assert _count("registry.evict") == reg.evictions
        assert counters.since(mark) == launches
        assert torch.equal(held[-1]["y"], 3 * (x + 2) + 1)
    finally:
        counters.restore(before)


def test_a_capture_that_evicts_during_a_retry_ends_without_deadlock(
        monkeypatch):
    """A replay whose clones ran out lets its entry's lock go before it
    waits to evict: a capture on another thread, under way meanwhile,
    evicts that entry (its release takes the lock), and both calls end
    with their own outputs."""
    card = FakeCard(7 * UNIT // 2)
    reg = graphs.Registry(card)
    charge_clones(monkeypatch, card)
    idle = _toy(_plus_one, reg)
    call(idle, torch.arange(3))
    g1 = _toy(_double, reg)
    x = torch.arange(UNIT // 8)
    out0 = call(g1, x)
    entry, = g1.entries.values()
    inside, go = threading.Event(), threading.Event()

    def slow(y):
        inside.set()
        go.wait(timeout=30)
        return {"y": y + 1}

    g2 = _toy(slow, reg)
    y = torch.arange(5)
    results, errors = {}, []

    def run(tag, g, arg):
        try:
            results[tag] = call(g, arg)["y"]
        except Exception as exc:       # reported below, not swallowed
            errors.append((tag, exc))

    # Daemons: a deadlock fails the test without holding the process.
    capturer = threading.Thread(target=run, args=("capture", g2, y),
                                daemon=True)
    capturer.start()
    assert inside.wait(timeout=30)
    replayer = threading.Thread(target=run, args=("replay", g1, x + 1),
                                daemon=True)
    replayer.start()
    try:
        time.sleep(0.3)
        assert replayer.is_alive()              # waiting to evict
        assert entry.lock.acquire(blocking=False)   # not holding the lock
        entry.lock.release()
    finally:
        go.set()
        capturer.join(timeout=30)
        replayer.join(timeout=30)
    assert not capturer.is_alive() and not replayer.is_alive()
    assert not errors, errors
    assert torch.equal(results["capture"], y + 1)
    assert torch.equal(results["replay"], 2 * (x + 1))
    assert torch.equal(out0["y"], 2 * x)
    assert entry.graph is None and not idle.entries


def test_memory_is_read_only_when_a_call_runs_out(monkeypatch):
    """The common case: a live entry's call whose clones fit reads the
    card's memory no more (no synchronize, no empty_cache).  One that
    runs out reads it once before and once after its eviction."""
    card = CountingCard(5 * UNIT)
    reg = graphs.Registry(card)
    charge_clones(monkeypatch, card)
    other = _toy(_plus_one, reg)
    call(other, torch.arange(3))
    g = _toy(_double, reg)
    x = torch.arange(UNIT // 8)
    held = [call(g, x)]
    readings = card.readings
    held += [call(g, x + i) for i in (1, 2)]
    assert card.readings == readings and other.entries
    held.append(call(g, x + 3))
    assert card.readings == readings + 2 and not other.entries
    assert all(torch.equal(h["y"], 2 * (x + i)) for i, h in enumerate(held))


@pytest.mark.parametrize("path", ["seeded", "streaming"])
def test_api_uploads_on_a_card_full_of_idle_entries_equal_jax(
        monkeypatch, path):
    """se_encrypt_seeded (values, seed words, the send path's int32
    casts) and se_encrypt_streaming (values, seed words) on a card whose
    free bytes idle entries hold: each upload that runs out evicts them
    and runs again, and the bytes sent equal the JAX API's."""
    _uploads_on_a_full_card(monkeypatch, path)


@pytest.mark.parametrize("path", ["seeded", "streaming"])
def test_staged_api_uploads_on_a_card_full_of_idle_entries_equal_jax(
        monkeypatch, path):
    """The same through the card's upload path (graphs.to_device staging
    each input in host memory, the device tensor an eager allocation):
    the device tensors that run out evict idle entries as before."""
    pins = fake_pinned(monkeypatch)
    _uploads_on_a_full_card(monkeypatch, path)
    # The context's secret key at set-up, then the call's values and two
    # batches of seed words (n = 1024, B = 2).
    assert pins == [(1024,), (2, 512), (2, 16), (2, 16)]


def _uploads_on_a_full_card(monkeypatch, path):
    n, L, scale, b = 1024, 1, 2.0 ** 20, 2
    jctx = japi.se_setup_custom(n, L, scale, japi.SYM, sk_seed=seed_bytes(1))
    ctx = tapi.se_setup_custom(n, L, scale, tapi.SYM, sk_seed=seed_bytes(1),
                               device=CPU)
    values = np.random.default_rng(5).uniform(-1, 1, (b, n // 2)).astype(
        np.float32)
    share = [seed_bytes(10 + i) for i in range(b)]
    seeds = [seed_bytes(20 + i) for i in range(b)]
    reg = ChargingRegistry(FakeCard(3 * UNIT + 1024))
    monkeypatch.setattr(graphs, "registry_for", lambda device: reg)
    fillers = [_toy(_double, reg) for _ in range(3)]
    for g in fillers:
        g.capturer = SqueezedCapture(reg.memory, _const(UNIT))
        call(g, torch.arange(3))
    assert reg.memory.free() < values.nbytes
    jsend, jstore = jnet.collecting_sender()
    tsend, tstore = tnet.collecting_sender()
    if path == "seeded":
        japi.se_encrypt_seeded(jctx, values, share, seeds, send=jsend)
        tapi.se_encrypt_seeded(ctx, values, share, seeds, send=tsend)
    else:
        jstream.se_encrypt_streaming(jctx, values, share, seeds, jsend)
        tstream.se_encrypt_streaming(ctx, values, share, seeds, tsend)
    assert tstore == jstore and len(tstore) == 2 * L * b
    assert reg.evictions >= 1
    assert sum(bool(g.entries) for g in fillers) == 3 - reg.evictions
    assert _count("registry.evict") == reg.evictions


# ----------------------------------------------------------- the policy

def test_eviction_is_least_recently_used_across_functions():
    """Two Graphed and one Chain in one registry: each capture evicts the
    entry of whichever function was used least recently."""
    reg = graphs.Registry(FakeCard(4 * UNIT))
    g1, g2 = _toy(_double, reg), _toy(_plus_one, reg)
    chain = on_card(_toy_chain(), reg, _const(UNIT))
    a, b, x = torch.arange(4), torch.arange(5), torch.arange(6)
    call(g1, a)
    run(chain, x)
    call(g2, b)
    assert torch.equal(call(g1, a)["y"], 2 * a)      # g1 is now the newest
    sig = graphs.signature
    assert list(reg.order) == [(chain.ref, sig((x,), {})),
                               (g2.ref, sig((b,), {})),
                               (g1.ref, sig((a,), {}))]
    # New signatures of as many bytes as the old ones: a warm-up that
    # runs out evicts what the last capture needed at those bytes.
    c = torch.arange(5).reshape(5, 1)
    assert torch.equal(call(g2, c)["y"], c + 1)
    assert not chain.entries and reg.evictions == 1
    assert _count("registry.evict") == reg.evictions
    d = torch.arange(4).reshape(2, 2)
    call(g1, d)
    assert list(reg.order) == [(g1.ref, sig((a,), {})),
                               (g2.ref, sig((c,), {})),
                               (g1.ref, sig((d,), {}))]
    assert reg.evictions == 2 and reg.memory.used == 3 * UNIT
    assert _count("registry.evict") == reg.evictions


def test_warm_up_past_the_card_raises_once_nothing_is_left():
    reg = graphs.Registry(FakeCard(3 * UNIT))
    small = _toy(_double, reg)
    big = _toy(_plus_one, reg, _const(2 * UNIT))
    a = torch.arange(3)
    call(small, a)
    with pytest.raises(torch.OutOfMemoryError):
        call(big, torch.arange(4))     # its warm-up peaks at 4 units
    assert not big.entries and not small.entries and not reg.order
    assert reg.memory.used == 0
    assert torch.equal(call(small, a)["y"], 2 * a)


def test_a_warm_up_that_runs_out_evicts_one_entry_at_a_time():
    """A warm-up past what is free runs again after each eviction of the
    least recently used entry, so only as many go as it needs."""
    reg = graphs.Registry(FakeCard(5 * UNIT))
    small = [_toy(fn, reg) for fn in (_double, _plus_one, _double, _double)]
    a = torch.arange(3)
    for g in small:
        call(g, a)
    big = _toy(_plus_one, reg, _const(2 * UNIT))   # its warm-up peaks at 4
    assert torch.equal(call(big, a)["y"], a + 1)
    assert reg.retries == 3 and reg.evictions == 3
    assert _count("registry.evict") == reg.evictions
    assert _count("registry.capture") == 5
    assert [bool(g.entries) for g in small] == [False, False, False, True]
    assert reg.memory.used == 3 * UNIT


def test_a_warm_up_that_runs_out_evicts_what_its_last_capture_needed():
    """A function whose warm-up ran out evicts, in one round, what its
    last capture needed per byte of its inputs at this call's inputs,
    and its warm-up then fits: it runs once again, not once an entry."""
    reg = graphs.Registry(FakeCard(6 * UNIT))
    f = _toy(_double, reg, graphs.nbytes)
    x = torch.arange(UNIT // 16)                 # UNIT / 2 bytes
    call(f, x)
    others = [_toy(fn, reg) for fn in (_plus_one, _double, _double,
                                        _double)]
    for g in others:
        call(g, torch.arange(3))
    y = torch.arange(UNIT // 4)                  # four times as many
    assert torch.equal(call(f, y)["y"], 2 * y)
    assert reg.retries == 1 and reg.evictions == 3
    assert _count("registry.evict") == reg.evictions
    assert _count("registry.capture") == 6
    assert [bool(g.entries) for g in others] == [False, False, True, True]
    assert f.need_per_byte == 2.0


class CountingCard(FakeCard):
    """A FakeCard that counts its readings of what is free, on which a
    warm-up's peak reads `need` once that is set (as on a card whose
    allocator served the warm-up from its cache)."""

    def __init__(self, total):
        super().__init__(total)
        self.readings = 0
        self.need = None

    def free(self):
        self.readings += 1
        return super().free()

    def peak(self, fn):
        out, peak = super().peak(fn)
        return out, peak if self.need is None else self.need


def test_room_is_made_from_one_reading_per_round():
    """The victims are chosen by their resident bytes against one reading
    of what is free, which is read again once they are released: a
    capture reads the card the same number of times whatever it evicts."""
    card = CountingCard(5 * UNIT)
    reg = graphs.Registry(card)
    olds = [_toy(_double, reg) for _ in range(3)]
    a = torch.arange(3)
    for g in olds:
        call(g, a)
    readings, card.need = card.readings, 5 * UNIT
    assert torch.equal(call(_toy(_plus_one, reg), a)["y"], a + 1)
    assert reg.evictions == 3 and not any(g.entries for g in olds)
    assert _count("registry.evict") == reg.evictions
    assert card.readings - readings == 3


class SqueezedCapture(CardCapture):
    """A warm-up on a full card, whose allocator recycles each call's
    cache for the next: it peaks at one call's pool."""

    def warm_up(self, fn):
        for _ in range(graphs.WARMUP_CALLS):
            self.warm_ups += 1
            out = fn()
            self.card.alloc(self.size(out))
        return out


def test_room_is_made_for_the_first_replays_outputs():
    """A warm-up whose peak is one pool leaves the capture no room for
    the replay's copies of its outputs: the registry evicts for them
    after the capture."""
    x = torch.arange(1024)
    pool = graphs.nbytes(_double(x))
    reg = graphs.Registry(FakeCard(5 * pool // 2))
    g = _toy(_double, reg, graphs.nbytes)
    g.capturer = SqueezedCapture(reg.memory)
    call(g, x)
    out = call(g, x + 1)["y"]
    y = x.reshape(32, 32)
    assert torch.equal(call(g, y)["y"], 2 * y)
    assert list(g.entries) == [graphs.signature((y,), {})]
    assert reg.evictions == 1 and reg.memory.free() >= pool
    assert _count("registry.evict") == reg.evictions
    assert torch.equal(out, 2 * (x + 1))


def test_a_function_below_max_entries_keeps_every_entry():
    """Up to MAX_ENTRIES signatures of one function, on a card with room
    for all, stay live: only the count beyond it or a capture's need
    evicts."""
    reg = graphs.Registry(FakeCard(1 << 40))
    g = _toy(_double, reg)
    xs = [torch.arange(1, k) for k in range(2, 2 + graphs.MAX_ENTRIES)]
    for n, x in enumerate(xs, 1):
        call(g, x)
        assert len(g.entries) == len(reg.order) == n
    assert reg.evictions == 0
    assert _count("registry.evict") == reg.evictions


def test_max_entries_per_function_still_holds():
    reg = graphs.Registry(FakeCard(1 << 40))
    g = _toy(_double, reg, max_entries=2)
    xs = [torch.arange(1, k) for k in (3, 4, 5)]
    for x in xs:
        call(g, x)
    first = graphs.signature((xs[0],), {})
    assert first not in g.entries and len(g.entries) == 2
    assert len(reg.order) == 2 and reg.evictions == 1
    assert _count("registry.evict") == reg.evictions
    assert reg.memory.used == 2 * UNIT


# ----------------------------------------------------- evicting safely

def test_eviction_waits_for_a_replay_that_holds_the_lock():
    reg = graphs.Registry(FakeCard(5 * UNIT // 2))
    g1, g2 = _toy(_double, reg), _toy(_plus_one, reg)
    a = torch.arange(1, 5)
    call(g1, a)
    entry, = g1.entries.values()
    held, go = threading.Event(), threading.Event()

    def replaying():
        with entry.lock:
            held.set()
            go.wait(timeout=30)

    holder = threading.Thread(target=replaying)
    holder.start()
    assert held.wait(timeout=30)
    capturer = threading.Thread(target=call, args=(g2, torch.arange(6)))
    capturer.start()
    time.sleep(0.3)
    assert capturer.is_alive()                 # waiting for the lock
    assert entry.graph is not None and entry.inputs[0].any()
    inputs = entry.inputs
    go.set()
    holder.join(timeout=30)
    capturer.join(timeout=30)
    assert not holder.is_alive() and not capturer.is_alive()
    assert entry.graph is None and _zero(inputs) and not g1.entries


def test_eviction_waits_for_a_chains_pending_reads():
    """An entry whose stream still reads its ring slots (the events its
    start returned, one a slot) is zeroed only after those reads end."""
    reg = graphs.Registry(FakeCard(5 * UNIT // 2))
    chain = on_card(_toy_chain(), reg, _const(UNIT))
    x = torch.arange(1, 6)
    seen = []

    class Reads:
        """A read's end: at its synchronize the outputs must be intact."""

        def synchronize(self):
            seen.append(not _zero(_leaves(entry.outputs)))

    run(chain, x)
    entry, = chain.entries.values()
    run(chain, x, start=lambda j, out, ev: (cloned(j, out, ev)[0], Reads()))
    kept = _leaves(entry.inputs, entry.carry, entry.outputs)
    call(_toy(_double, reg), torch.arange(3))
    assert seen == [True] * graphs.RING_SLOTS
    assert not chain.entries and _zero(kept)


def test_evicted_entries_are_zeroed_before_their_graphs_are_dropped():
    """Static inputs, hand-offs and a chain's outputs are zero when the
    graph (and with it the pool) goes, for a Graphed and a Chain."""
    reg = graphs.Registry(FakeCard(3 * UNIT))
    g = _toy(_double, reg)
    chain = on_card(_toy_chain(), reg, _const(UNIT))
    call(g, torch.arange(1, 5))
    run(chain, torch.arange(1, 6))
    zero_at_drop = []
    for owner in (g, chain):
        entry, = owner.entries.values()
        kept = _leaves(entry.inputs, getattr(entry, "carry", None),
                       entry.outputs if owner is chain else None)
        assert kept and not _zero(kept)
        weakref.finalize(entry.graph, lambda k=kept: zero_at_drop.append(
            _zero(k)))
    g2 = _toy(_plus_one, reg)
    call(g2, torch.arange(3))          # evicts g's entry
    call(g2, torch.arange(3).reshape(3, 1))    # and then the chain's
    assert zero_at_drop == [True, True] and reg.evictions == 2
    assert _count("registry.evict") == reg.evictions
    assert not g.entries and not chain.entries


def test_recaptured_signature_gives_equal_outputs_and_tallies():
    reg = graphs.Registry(FakeCard(3 * UNIT))
    launches = dict(dict.fromkeys(counters.COUNTERS, 0), ntt=3, encode=1)

    def counted(x):
        counters.add(launches)
        return {"y": 3 * x + 1}

    g = _toy(counted, reg)
    chain = on_card(_toy_chain(launches_per_step=5), reg, _const(UNIT))
    other = _toy(_double, reg, _const(3 * UNIT // 2))
    a, x = torch.arange(1, 9), torch.arange(2, 7)
    before = counters.tallies()
    try:
        firsts = []
        for _ in range(2):
            ys = call(g, a)["y"]
            outs = run(chain, x)
            entries = (*g.entries.values(), *chain.entries.values())
            mark = counters.tallies()
            call(g, a)
            run(chain, x)
            firsts.append((ys, outs, [e.launches for e in entries],
                           counters.tallies_since(mark)))
            call(other, torch.arange(3))   # evicts both
            assert not g.entries and not chain.entries
        (y1, o1, l1, t1), (y2, o2, l2, t2) = firsts
        assert torch.equal(y1, y2) and torch.equal(y1, 3 * a + 1)
        for got, want in zip(o2, _eager_toy(x)):
            assert all(torch.equal(p, q) for p, q in zip(got, want))
        assert l1 == l2 and t1 == t2
        assert t1["ntt"] == 3 + 5 * 3 and t1["encode"] == 1
        assert len(g.capturer.kinds("capture")) == 2
        assert len(chain.capturer.kinds("pool")) == 2
    finally:
        counters.restore(before)


# ------------------------------------------------ dropped functions

@pytest.mark.parametrize("kind", ["graphed", "chain"])
def test_a_dropped_function_hands_back_its_bytes_zeroed(kind):
    """The registry holds functions weakly: once a Graphed or a Chain is
    dropped, its entries leave the registry, their static inputs (a
    caller's key among them), hand-offs and a chain's outputs are zeroed,
    and the card has their bytes back."""
    reg = graphs.Registry(FakeCard(8 * UNIT))
    keep = _toy(_double, reg)
    call(keep, torch.arange(1, 4))
    if kind == "graphed":
        f = _toy(_plus_one, reg)
        for k in (5, 6):
            call(f, torch.arange(1, k))
    else:
        f = on_card(_toy_chain(), reg, _const(UNIT))
        for k in (5, 6):
            run(f, torch.arange(1, k))
    kept = []
    for entry in f.entries.values():
        kept += _leaves(entry.inputs, getattr(entry, "carry", None),
                        entry.outputs if kind == "chain" else None)
    assert kept and not _zero(kept) and reg.memory.used == 3 * UNIT
    del f, entry
    gc.collect()
    assert _zero(kept) and reg.memory.used == UNIT
    assert [k[0]() for k in reg.order] == [keep] and reg.evictions == 0
    assert _count("registry.evict") == reg.evictions


def test_a_function_dropped_during_a_capture_goes_when_it_ends():
    """A function dropped while another captures (the collector can run
    anywhere) keeps its entry until that capture is done: a graph capture
    allows no release."""
    reg = graphs.Registry(FakeCard(8 * UNIT))
    holder = [_toy(_double, reg)]
    call(holder[0], torch.arange(1, 4))
    entry, = holder[0].entries.values()
    inputs, live = entry.inputs, []

    def dropping(x):
        holder.clear()
        gc.collect()
        live.append(entry.graph is not None)
        return {"y": x + 1}

    call(_toy(dropping, reg), torch.arange(3))
    # The warm-up's calls and the capture's; the fake's replay reruns it.
    captured = graphs.WARMUP_CALLS + 1
    assert live[:captured] == [True] * captured
    assert entry.graph is None and _zero(inputs)
    assert reg.memory.used == 0 and not reg.order


def test_a_live_entry_replays_while_another_function_captures():
    """A capture holds the device's capture lock, not the bookkeeping:
    a replay of another function's live entry does not wait for it."""
    reg = graphs.Registry(FakeCard(8 * UNIT))
    g1 = _toy(_double, reg)
    a = torch.arange(1, 5)
    call(g1, a)
    inside, go = threading.Event(), threading.Event()

    def slow(x):
        inside.set()
        go.wait(timeout=30)
        return {"y": x + 1}

    g2 = _toy(slow, reg)
    capturer = threading.Thread(target=call, args=(g2, torch.arange(6)))
    capturer.start()
    try:
        assert inside.wait(timeout=30)
        assert torch.equal(call(g1, a + 1)["y"], 2 * (a + 1))
        assert capturer.is_alive()           # still in its warm-up
    finally:
        go.set()
        capturer.join(timeout=30)
    assert not capturer.is_alive() and len(reg.order) == 2


def test_the_kernel_library_loads_inside_the_first_capture(monkeypatch):
    """The kernel library loads at the first launch, in the first
    capture's warm-up: one ``kernels.load`` span, a child of that
    capture's ``registry.capture`` (set-up's capture time is the
    capture's less the load's), and none in a later capture."""
    from seal_embedded_tpu_torch.ops.kernels import build
    opened = []
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", lambda: "libfake.so")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: (
        opened.append(path) or SimpleNamespace(
            sek_error_string=SimpleNamespace())))

    def launching(x):
        build.lib()
        return {"y": 2 * x}

    reg = graphs.Registry(FakeCard(4 * UNIT))
    g = _toy(launching, reg)
    for k in (3, 4):
        assert torch.equal(call(g, torch.arange(k))["y"], 2 * torch.arange(k))
    spans = timing.take_spans()
    captures = [s for s in spans if s.name == "registry.capture"]
    load, = [s for s in spans if s.name == "kernels.load"]
    assert len(captures) == 2 and opened == ["libfake.so"]
    assert load.parent == captures[0].id
    assert captures[0].start_ns <= load.start_ns <= load.end_ns \
        <= captures[0].end_ns
