"""The per-prime seeded form (wire/seed.py): whole runs on the CPU of a
cell that sends it, through a stand-in for the program's seed-only
option, with the chunks broken underneath; its reader against
bytes-like chunks of every kind; and the form tied to the batch API's
seeded ciphertext."""

import json

import numpy as np
import pytest

from benchmark import harness, trace, traffic
from benchmark.catalog import Catalog
from benchmark.reference.params import from_config
from benchmark.tests import copies
from benchmark.tests.test_bench_send import (at_chunk, dropped, duplicated,
                                             flipped)

CELL = "n4096.sym.b16.seed"
SEED = 2 ** 31 + 37
L, N = 3, 4096


def seed_copy(root, kind="sym") -> Catalog:
    """A copy of the benchmark with a cell whose traffic sends the seeded
    form, as a later PR would add it: a traffic file naming the form, the
    cell's entry, and its name in the workloads of the per-layer metrics
    it reports, send_ms among them.  `kind` "asym" sends it from a
    public-key traffic instead."""
    copies.copy(root)
    base = "sym.b16" if kind == "sym" else "asym.b512"
    mix = dict(Catalog(root).traffic(base), send="seed")
    (root / f"benchmark/traffic/{base}.seed.json").write_text(
        json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "seal-default-n4096",
                              "traffic": f"{base}.seed", "chips": 1,
                              "why": "16 messages a call, each prime's c0 "
                                     "sent with the message's seed for c1"})
    spec["per_layer"].append({"name": "send_ms", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "API entry", "moves": "enc_per_s",
                              "workloads": []})
    for m in spec["per_layer"]:
        if m["name"] in ("host_ms.small", "registry_evictions",
                         "alloc_retries", "send_ms"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Catalog(root)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A copy of the benchmark with the seed-sending cell CELL."""
    return seed_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def short(monkeypatch):
    """One warm-up call, two batches of values, two sampled calls."""
    monkeypatch.setattr(harness, "WARMUP_CALLS", 1)
    monkeypatch.setattr(traffic, "VALUE_BATCHES", 2)
    monkeypatch.setattr(traffic, "CHECK_MESSAGES", 2)


def seed_chunks(out, share_seeds) -> list:
    """The per-prime seeded form of a call's limb dicts, in walk order:
    the first limb's chunk of message b its 64-byte shareable seed and
    c0, each later limb's c0 alone, as little-endian u32."""
    from seal_embedded_tpu_torch.io import serialize
    return [(share_seeds[b].ljust(64, b"\x00") if j == 0 else b"")
            + serialize.ct_component_bytes(limb["c0"][b])
            for j, limb in enumerate(out) for b in range(len(limb["c0"]))]


def stand_in(monkeypatch, mangle=None, without_c0=()):
    """The program's entry as the seed-only option will be: the real
    stream without `send`, the seeded form sent from its limbs (through
    mangle(send), where given), c1 dropped from the limb dicts it
    returns, and c0 too from the limbs numbered in `without_c0`."""
    from seal_embedded_tpu_torch.ckks import stream
    encrypt = stream.se_encrypt_streaming

    def seed_only_entry(ctx, values, share_seeds=None, err_seeds=None,
                        send=None, order="forward", seed_only=False):
        if not seed_only:
            raise TypeError("the stand-in serves the seed-only option")
        out = encrypt(ctx, values, share_seeds=share_seeds,
                      err_seeds=err_seeds, order=order)
        sender = mangle(send) if mangle else send
        for chunk in seed_chunks(out, share_seeds):
            sender(chunk)
        return [{k: v for k, v in limb.items()
                 if k != "c1" and not (k == "c0" and j in without_c0)}
                for j, limb in enumerate(out)]
    monkeypatch.setattr(stream, "se_encrypt_streaming", seed_only_entry)


def run(catalog, traced=False):
    return harness.run(catalog, CELL, SEED, 0.01, traced, "cpu")


def flipped_c0(send, chunk, held):
    at = 64 + 20
    send(chunk[:at] + bytes([chunk[at] ^ 0x10]) + chunk[at + 1:])


def seedless(send, chunk, held):
    send(chunk[64:])


def no_trace(monkeypatch):
    """The traced path with a trace that saw nothing (the CPU has no
    card)."""
    def segment(call, seconds, host=False):
        call()
        return trace.Segment([], 0.0, 1)
    monkeypatch.setattr(harness.tr, "segment", segment)


def test_a_sound_seed_run_is_correct(small, short, monkeypatch):
    stand_in(monkeypatch)
    no_trace(monkeypatch)
    result = run(small, traced=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 16
    assert result["checks"]["walk_errors"]["value"] == 0
    assert result["checks"]["coeff_mismatches"]["value"] == 0
    assert result["metrics"]["send_ms"]["value"] > 0


def test_a_flipped_seed_byte_fails_every_coefficient_of_c1(small, short,
                                                           monkeypatch):
    """Byte 20 of each call's first chunk, message 0's seed: the c0 sent
    matches the limbs returned, and c1 drawn from that seed misses the
    reference's in all L n coefficients (the last call's message 0 is
    always kept)."""
    stand_in(monkeypatch, at_chunk(1, flipped))
    result = run(small)
    assert not result["correct"]
    assert result["checks"]["walk_errors"]["value"] == 0
    assert result["checks"]["coeff_mismatches"]["value"] >= L * N


def test_a_flipped_c0_byte_shows_in_coeff_mismatches(small, short,
                                                     monkeypatch):
    stand_in(monkeypatch, at_chunk(1, flipped_c0))
    result = run(small)
    assert not result["correct"]
    assert result["checks"]["coeff_mismatches"]["value"] > 0


@pytest.mark.parametrize("where,act", [(3, dropped), (3, duplicated),
                                       (1, seedless)])
def test_a_chunk_astray_is_a_walk_error(small, short, monkeypatch, where,
                                        act):
    stand_in(monkeypatch, at_chunk(where, act))
    result = run(small)
    assert not result["correct"], result["checks"]
    assert result["checks"]["walk_errors"]["value"] > 0


def test_a_limb_returned_without_c0_is_a_walk_error(small, short,
                                                    monkeypatch):
    """The window runs on and the run ends with its whole result."""
    stand_in(monkeypatch, without_c0=(1,))
    result = run(small)
    assert {"correct", "attempted", "failed", "metrics", "device",
            "checks"} <= set(result)
    assert not result["correct"]
    assert result["checks"]["walk_errors"]["value"] > 0
    assert result["checks"]["coeff_mismatches"]["value"] == 0


def test_complete_runs_only_after_the_window(small, short, monkeypatch):
    """Never in the window or in a traced segment: once for each kept
    message, once the program's state is freed."""
    phase, calls = ["set-up"], []
    form = small.wire("seed")
    complete = form.complete

    def counted(got, params):
        calls.append(phase[0])
        return complete(got, params)

    def during(name, f):
        def wrapped(*args, **kw):
            phase[0] = name
            try:
                return f(*args, **kw)
            finally:
                phase[0] = "after " + name
        return wrapped

    def segment(call, seconds, host=False):
        call()
        return trace.Segment([], 0.0, 1)
    monkeypatch.setattr(form, "complete", counted)
    monkeypatch.setattr(small, "wire", lambda name: form)
    monkeypatch.setattr(harness.Cell, "window",
                        during("window", harness.Cell.window))
    monkeypatch.setattr(harness.Cell, "free",
                        during("free", harness.Cell.free))
    monkeypatch.setattr(harness.tr, "segment", during("trace", segment))
    stand_in(monkeypatch)
    result = run(small, traced=True)
    assert result["correct"], result["checks"]
    assert calls == ["after free"] * result["calls"]["messages_checked"]
    assert calls


def test_an_asym_traffic_sending_seed_is_refused_at_set_up(tmp_path,
                                                           monkeypatch):
    """Refused by name before the program's set-up begins."""
    from seal_embedded_tpu_torch import api

    def no_setup(*args, **kw):
        raise AssertionError("set-up ran")
    monkeypatch.setattr(api, "se_setup_custom", no_setup)
    catalog = seed_copy(tmp_path, kind="asym")
    with pytest.raises(ValueError, match=r"'seed' carries \('sym',\).*"
                                         r"encrypt_type 'asym'"):
        harness.run(catalog, CELL, SEED, 0.01, False, "cpu")


def synthetic(batch=4, seed=7):
    """Random seeds and c0 of `batch` messages at n = 4096, three primes,
    and their chunks in the seeded form."""
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(64) for _ in range(batch)]
    c0 = rng.integers(0, 2 ** 30, (batch, L, N), dtype=np.uint32)
    chunks = [(seeds[b] if j == 0 else b"") + c0[b, j].astype("<u4").tobytes()
              for j in range(L) for b in range(batch)]
    return seeds, c0, chunks


def as_u32_view(chunk):
    return memoryview(np.frombuffer(chunk, "<u4").copy())


@pytest.mark.parametrize("kind", [bytearray, memoryview, as_u32_view])
def test_chunks_read_the_same_as_bytes_in_any_buffer(kind):
    """bytes, bytearray, a view of bytes and a view of uint32 words (a
    pinned buffer's) read alike, and each message is copied out of them."""
    p = from_config(Catalog().config("seal-default-n4096"))
    form = Catalog().wire("seed")
    seeds, c0, chunks = synthetic()
    want, bad = form.read(chunks, p, 4)
    views = [kind(c) for c in chunks]
    got, bad_views = form.read(views, p, 4)
    assert bad == bad_views == 0
    for b in range(4):
        assert want[b][1] == got[b][1] == seeds[b]
        assert np.array_equal(want[b][0], c0[b])
        assert np.array_equal(got[b][0], c0[b])
    if kind is bytearray:
        message = got[0]
        views[0][70] ^= 1
        assert np.array_equal(message[0], c0[0])


@pytest.mark.parametrize("fault,bad,empty", [
    (lambda c: c[:3] + c[4:], 2, [3]),          # message 3's seed chunk gone
    (lambda c: c + c[-1:], 1, []),              # a chunk extra
    (lambda c: [c[0][64:]] + c[1:], 1, [0]),    # message 0's seed missing
    (lambda c: c[:5] + [c[5][:-4]] + c[6:], 1, [1]),    # a c0 chunk short
], ids=["dropped", "extra", "seedless", "short"])
def test_the_reader_counts_each_fault_and_empties_its_message(fault, bad,
                                                              empty):
    """Four messages, three limbs: the chunks missing or extra and those of
    the wrong length, each counted once; a message with such a chunk reads
    as empty, and stays empty in both halves once completed."""
    p = from_config(Catalog().config("seal-default-n4096"))
    form = Catalog().wire("seed")
    _, _, chunks = synthetic()
    messages, counted = form.read(fault(chunks), p, 4)
    assert counted == bad
    assert [b for b in range(4) if messages[b][0].size == 0] == empty
    for b in empty:
        assert messages[b][1] == b""
        c0, c1 = form.complete(messages[b], p)
        assert c0.size == c1.size == 0


def test_the_per_prime_form_reads_as_the_batch_apis_seeded_blob():
    """At n = 4096, three primes, B = 4, the same inputs: each message's
    seed and c0 read by wire/seed.py from the streaming call's limbs equal
    serialize.seeded_ct_parse of what se_encrypt_seeded sent with
    send_seed_only, and `complete` draws the c1 that the streaming call
    returned."""
    import torch
    from seal_embedded_tpu_torch import api
    from seal_embedded_tpu_torch.ckks import stream
    from seal_embedded_tpu_torch.io import serialize
    B = 4
    c = Catalog()
    form = c.wire("seed")
    assert form.KWARGS == {"seed_only": True} and form.KINDS == ("sym",)
    assert form.RETURNS == ("c0",) and form.limb_chunks(B) == B
    mix = dict(c.traffic("sym.b16"), batch=B, send="seed")
    p = from_config(c.config("seal-default-n4096"))
    t = traffic.Traffic(p.degree, mix, SEED)
    ctx = api.se_setup_custom(p.degree, p.nprimes, p.scale, "sym", sk=t.sk,
                              pk_seed=t.pk_seed, device=torch.device("cpu"))
    share, err = t.seeds(0)
    values = t.values(0)
    out = stream.se_encrypt_streaming(ctx, values, share_seeds=share,
                                      err_seeds=err, order="forward")
    messages, bad = form.read(seed_chunks(out, share), p, B)
    blobs = []
    api.se_encrypt_seeded(ctx, values, share_seeds=share, seeds=err,
                          send=blobs.append, send_seed_only=True)
    assert bad == 0 and len(blobs) == B
    for b, blob in enumerate(blobs):
        seed, c0 = serialize.seeded_ct_parse(blob)
        assert messages[b][1] == seed
        assert np.array_equal(messages[b][0], c0)
        got0, got1 = form.complete(messages[b], p)
        assert np.array_equal(got0, np.stack([x["c0"][b] for x in out]))
        assert np.array_equal(got1, np.stack([x["c1"][b] for x in out]))
        assert got1.dtype == np.uint32
