"""The port's span recorder (utils/timing.py) on the CPU.

One sym and one asym ``se_encrypt_streaming`` call with the recorder on
give one ``api.call`` and, under it, the spans of each layer boundary
with the call's id and their parents; off, the same call records
nothing and a span is one shared context that allocates nothing and
calls no torch function.  Under ``torch.profiler`` the spans' names are
among the profiler's host events.  A compiled chain run through the fake
capture of test_torch_chain.py marks its prologue and steps with timing
events between the graphs, which its fetches read into device spans,
and its next run records the same events again; the graphs it captures
are the same with the recorder on and off.  The device intervals of the
card's copies run only on the card (``perf_spans.py``)."""

import tracemalloc

import numpy as np
import pytest
import torch

from seal_embedded_tpu_torch import api as tapi
from seal_embedded_tpu_torch import graphs
from seal_embedded_tpu_torch.ckks import stream as tstream
from seal_embedded_tpu_torch.config import PRIMES_27BIT, Parms
from seal_embedded_tpu_torch.convert import state_to_device
from seal_embedded_tpu_torch.io import network as tnet
from seal_embedded_tpu_torch.utils import timing

from conftest import seed_bytes
from test_torch_chain import FakeTimingEvent, _fetched, faked, run_chain

torch.set_num_threads(2)

P = Parms(degree=1024, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)
B = 2
CPU = torch.device("cpu")


@pytest.fixture
def recording():
    """The recorder on for the test, nothing recorded before it kept."""
    timing.take_spans()
    timing.record_spans(True)
    yield
    timing.record_spans(False)
    timing.take_spans()


def _context(kind):
    rng = np.random.default_rng(3)
    n = P.degree
    sk = (rng.integers(0, 3, n) - 1).astype(np.int32)
    pk = [np.stack([rng.integers(0, q, n) for q in P.moduli]).astype(
        np.uint32) for _ in range(2)]
    return tapi._make_context(P, kind, CPU, sk_signed=sk, pk0=pk[0],
                              pk1=pk[1])


def _call(ctx, send=None):
    values = np.random.default_rng(4).uniform(
        -1, 1, (B, P.degree // 2)).astype(np.float32)
    share = [seed_bytes(10 + b) for b in range(B)]
    err = [seed_bytes(20 + b) for b in range(B)]
    return tstream.se_encrypt_streaming(ctx, values, share, err, send)


def _named(spans, name):
    return [s for s in spans if s.name == name]


@pytest.mark.parametrize("kind", ["sym", "asym"])
def test_a_streaming_call_gives_one_call_and_its_layers(kind, recording):
    """One api.call (a root with a call id of its own); under it, the
    seed packing and uploads of the call's inputs, one chain.run a step
    (the CPU runs each step as it is reached) with that limb's
    fetch.queue, one fetch.wait, fetch.view and api.send a limb: every
    span with the call's id, inside its parent's interval.  The limbs
    are those of the same call with the recorder off, their wait_ms 0.0."""
    ctx = _context(kind)
    sender, sent = tnet.collecting_sender()
    got = _call(ctx, sender)
    spans = timing.take_spans()
    root, = _named(spans, "api.call")
    assert root.parent is None and root.call is not None
    by_id = {s.id: s for s in spans}
    L = P.nprimes
    want = {"api.seed_pack": (2 if kind == "sym" else 1, "api.call"),
            "api.upload": (3 if kind == "sym" else 2, "api.call"),
            "chain.run": (L, "api.call"),
            "fetch.queue": (L, "chain.run"),
            "fetch.wait": (L, "api.call"),
            "fetch.view": (L, "api.call"),
            "api.send": (L, "api.call")}
    assert sorted({s.name for s in spans}) == sorted({"api.call", *want})
    for name, (count, parent) in want.items():
        found = _named(spans, name)
        assert len(found) == count, name
        for s in found:
            up = by_id[s.parent]
            assert up.name == parent and s.call == root.call, name
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
            assert not s.card and s.limb is None
    assert len(sent) == 2 * B * L
    assert [l["wait_ms"] for l in got] == [0.0] * L
    timing.record_spans(False)
    again = _call(ctx)
    assert timing.take_spans() == []
    for a, b in zip(got, again):
        assert np.array_equal(a["c0"], b["c0"])
        assert np.array_equal(a["c1"], b["c1"])


def test_two_calls_have_their_own_ids(recording):
    ctx = _context("sym")
    _call(ctx)
    _call(ctx)
    spans = timing.take_spans()
    calls = [s.call for s in _named(spans, "api.call")]
    assert len(set(calls)) == 2
    assert {s.call for s in spans} == set(calls)


def test_recorder_off_records_nothing():
    timing.take_spans()
    got = _call(_context("sym"))
    assert timing.take_spans() == []
    assert [l["wait_ms"] for l in got] == [0.0] * P.nprimes


def test_span_names_are_profiler_events(recording):
    """Inside torch.profiler (CPU activity) each span opens
    record_function under its name."""
    ctx = _context("sym")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _call(ctx)
    names = {e.name for e in prof.events()}
    assert {"api.call", "api.seed_pack", "api.upload", "chain.run",
            "fetch.queue", "fetch.wait", "fetch.view"} <= names


def test_an_off_span_allocates_nothing_and_calls_no_torch(monkeypatch):
    """Off, span() is one shared context: it allocates nothing, and calls
    neither the profiler nor CUDA, nor does a chain's card clock; a
    timed span still times.  The recorder reads no environment
    variable."""
    def forbidden(*a, **k):
        raise AssertionError("a torch call from a span that is off")

    timing.record_spans(False)
    for target, name in ((torch.profiler, "record_function"),
                         (torch._C._autograd, "_profiler_enabled"),
                         (torch.cuda, "Event")):
        monkeypatch.setattr(target, name, forbidden)
    assert timing.span("api.call", root=True) is timing.span("fetch.wait")
    spare = []
    assert timing.card_clock(None, forbidden, spare) is timing.span("x")
    with timing.span("fetch.wait", timed=True) as wait:
        pass
    assert wait.ms >= 0.0
    n = 10000
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        kept = [timing.span("chain.run") for _ in range(n)]
        kept += [timing.card_clock(None, forbidden, spare) for _ in range(n)]
        for ctx in kept:
            with ctx as got:
                assert got is None and timing.current_clock() is None
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    # The list's pointers alone, no object a span (a Span takes about
    # 150 bytes).
    assert grown < 16 * len(kept)
    assert len({id(ctx) for ctx in kept}) == 1
    assert timing.take_spans() == []
    source = open(timing.__file__).read()
    assert "environ" not in source and "getenv" not in source


def _sym_stream_args():
    rng = np.random.default_rng(5)
    n = P.degree
    return state_to_device(
        rng.uniform(-1, 1, (B, n // 2)).astype(np.float32),
        (rng.integers(0, 3, n) - 1).astype(np.int32),
        rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32),
        rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32), device=CPU)


def test_a_compiled_run_marks_its_prologue_and_steps(recording):
    """Through the fake capture, a run of the compiled sym stream inside
    an api.call: its card clock marks dev.prologue and one dev.step a
    limb, in walk order, which the fetches read into device spans of the
    call; every mark's interval on the fake card clock lies after the
    call's first event, and the replay records the events the capture's
    run made.  The capture and the replays are the same with
    the recorder off: no span or event goes into a graph."""
    s = tstream.sym_stream(P, "forward", CPU)
    args = _sym_stream_args()
    logs = []
    for on in (True, False):
        timing.record_spans(on)
        chain = faked(graphs.Chain(s.chain.prologue, s.chain.step,
                                   s.chain.nsteps, CPU))
        with timing.span("api.call", root=True) as call:
            for _ in range(2):                  # the capture, then a replay
                limbs = list(map(tstream._fetch, run_chain(
                    chain, *args, start=_fetched(s))))
        logs.append(chain.capturer.log)
        spans = timing.take_spans()
        if on:
            device = [x for x in spans if x.card]
            assert [(x.name, x.limb) for x in device] == 2 * [
                ("dev.prologue", None),
                *(("dev.step", j) for j in range(P.nprimes))]
            assert all(x.call == call.call and x.parent is None
                       and 0 <= x.start_ns < x.end_ns for x in device)
            assert all(x.ms == pytest.approx(FakeTimingEvent.TICK_MS)
                       for x in device)
            assert len(_named(spans, "chain.run")) == 0    # run_chain's own
            assert len(_named(spans, "registry.capture")) == 1
            entry, = chain.entries.values()     # the events made once
            assert len(entry.spare_events) == 2 + 2 * P.nprimes
        else:
            assert spans == []
        assert [l["prime_idx"] for l in limbs] == list(range(P.nprimes))
    assert logs[0] == logs[1]


def test_threads_record_their_own_stacks(recording):
    """Threads (more than the cores) that open calls and nested spans at
    once, the interpreter switching often, while another thread takes
    the spans: none is lost or counted twice, and each span's parent and
    call are those of its own thread."""
    import os
    import sys
    import threading

    nthreads, rounds = 2 * (os.cpu_count() or 2) + 1, 200
    taken, done = [], threading.Event()

    def work(tag):
        for _ in range(rounds):
            with timing.span("api.call", root=True):
                with timing.span(f"t{tag}.outer"):
                    with timing.span(f"t{tag}.inner"):
                        pass

    def take():
        while not done.is_set():
            taken.extend(timing.take_spans())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        taker = threading.Thread(target=take)
        taker.start()
        workers = [threading.Thread(target=work, args=(t,))
                   for t in range(nthreads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        done.set()
        taker.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers) and not taker.is_alive()
    taken.extend(timing.take_spans())
    assert len(taken) == 3 * nthreads * rounds
    assert len({s.id for s in taken}) == len(taken)
    by_id = {s.id: s for s in taken}
    for s in taken:
        if s.name.endswith(".inner"):
            outer = by_id[s.parent]
            root = by_id[outer.parent]
            assert outer.name == s.name[:-len("inner")] + "outer"
            assert root.name == "api.call" and root.parent is None
            assert s.call == outer.call == root.call


def test_a_device_mark_is_read_once_it_has_ended(recording):
    """A run's card clock is read after the run has left it, mark by mark
    in order as each ends (no wait): a later mark stays unread behind one
    that has not ended; once all are read, its events go back to the
    spare list for a later run, which records them again."""
    class Pending(FakeTimingEvent):
        ended = True

        def query(self):
            return self.ended and self.at is not None

    spare = []
    with timing.span("api.call", root=True) as call:
        with timing.card_clock(None, Pending, spare) as clock:
            assert timing.current_clock() is clock
            clock.limb = 0
            begin = clock.event(None)
            end = clock.event(None)
            end.ended = False
            clock.mark("dev.step", begin, end)
            last = clock.event(None)
            clock.mark("dev.copy", end, last)
            timing.read_card_marks()          # the run has not left it
        assert timing.current_clock() is None
        timing.read_card_marks()
        assert timing.take_spans() == [] and spare == []
        end.ended = True
        timing.read_card_marks()
    step, copy, root = timing.take_spans()
    assert (step.name, copy.name, root.name) == ("dev.step", "dev.copy",
                                                 "api.call")
    assert step.call == copy.call == call.call and step.limb == 0
    assert step.ms == copy.ms == pytest.approx(FakeTimingEvent.TICK_MS)
    assert step.end_ns == copy.start_ns
    made = {id(e) for e in (clock.origin, begin, end, last)}
    assert len(spare) == 4 and {id(e) for e in spare} == made
    with timing.card_clock(None, Pending, spare) as again:
        assert id(again.origin) in made and len(spare) == 3
    timing.take_spans()
