"""Cells whose traffic sends: the wire form's reader against the program's
own bytes, whole runs on the CPU with the chunks broken underneath, the
traffic files' inputs unchanged by the optional key, and wire forms found
by name, a new one added as a file."""

import hashlib
import json
import shutil

import numpy as np
import pytest

from benchmark import check, harness, trace, traffic
from benchmark.catalog import REPO, Catalog
from benchmark.reference.params import from_config
from benchmark.tests import copies

B = 4
CELL = "n4096.sym.b4.send"
SEED = 2 ** 31 + 29


def send_copy(root, form="components") -> Catalog:
    """A copy of the benchmark whose traffic runs B = 4 on the CPU, with a
    sending cell added as a later PR would add it: a traffic file naming
    the wire form `form`, the cell's entry, and its name in the
    workloads of the per-layer metrics it reports, send_ms among them."""
    copies.copy(root, batch=B)
    mix = dict(Catalog(root).traffic("sym.b16"), send=form)
    (root / "benchmark/traffic/sym.b4.send.json").write_text(
        json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "seal-default-n4096",
                              "traffic": "sym.b4.send", "chips": 1,
                              "why": "4 messages a call, every RNS "
                                     "component handed to the send "
                                     "callback"})
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
    """A copy of the benchmark with the sending cell CELL."""
    return send_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def short(monkeypatch):
    """One warm-up call, two batches of values, two sampled calls."""
    monkeypatch.setattr(harness, "WARMUP_CALLS", 1)
    monkeypatch.setattr(traffic, "VALUE_BATCHES", 2)
    monkeypatch.setattr(traffic, "CHECK_MESSAGES", 2)


def test_components_reads_the_programs_own_bytes_exactly():
    """At n = 4096, three primes, B = 4: every message read from the
    chunks the program sent equals the limbs it returned and the
    reference, and the chunks are those messages' bytes in the
    reference's order."""
    import torch
    from seal_embedded_tpu_torch import api
    from seal_embedded_tpu_torch.ckks import stream
    c = Catalog()
    mix = dict(c.traffic("sym.b16"), batch=B, send="components")
    p = from_config(c.config("seal-default-n4096"))
    t = traffic.Traffic(p.degree, mix, SEED)
    ctx = api.se_setup_custom(p.degree, p.nprimes, p.scale, "sym", sk=t.sk,
                              pk_seed=t.pk_seed, device=torch.device("cpu"))
    share, err = t.seeds(0)
    chunks = []
    out = stream.se_encrypt_streaming(ctx, t.values(0), share_seeds=share,
                                      err_seeds=err, send=chunks.append,
                                      order="forward")
    form = c.wire("components")
    assert form.KWARGS == {} and form.limb_chunks(B) == 2 * B
    messages, bad = form.read(chunks, p, B)
    assert bad == 0 and len(messages) == B
    got = [messages[b] for b in range(B)]
    for b, (c0, c1) in enumerate(got):
        assert c0.dtype == c1.dtype == np.uint32
        assert c0.shape == c1.shape == (p.nprimes, p.degree)
        assert np.array_equal(c0, np.stack([x["c0"][b] for x in out]))
        assert np.array_equal(c1, np.stack([x["c1"][b] for x in out]))
    wire = b"".join(got[b][part][j].astype("<u4").tobytes()
                    for j in range(p.nprimes) for b in range(B)
                    for part in (0, 1))
    assert b"".join(chunks) == wire
    nums = check.numbers(p, "sym", t.sk, t.pk_seed, got,
                         [t.message(0, b) for b in range(B)], 0, 0)
    assert check.correct(nums), nums


def run(catalog, seed=SEED, traced=False):
    return harness.run(catalog, CELL, seed, 0.01, traced, "cpu")


def sends(monkeypatch, mangle):
    """The program's entry with every call's send callback replaced by
    mangle(send), the chunks broken where they are handed over."""
    from seal_embedded_tpu_torch.ckks import stream
    encrypt = stream.se_encrypt_streaming

    def broken(*args, send=None, **kw):
        return encrypt(*args, send=mangle(send) if send else None, **kw)
    monkeypatch.setattr(stream, "se_encrypt_streaming", broken)


def at_chunk(where, act):
    """mangle(send): chunk number `where` (1-based, each call) goes to
    act(send, chunk, held) instead of send; held keeps what act holds."""
    def mangle(send):
        count, held = iter(range(1, 1 << 30)), []

        def each(chunk):
            if next(count) == where:
                act(send, chunk, held)
            elif held and held[-1] is not None:
                send(chunk)
                send(held.pop())
            else:
                send(chunk)
        return each
    return mangle


def dropped(send, chunk, held):
    pass


def duplicated(send, chunk, held):
    send(chunk)
    send(chunk)


def reordered(send, chunk, held):
    """Held back past the next chunk: message 0's c0 and c1 of the first
    limb swap places."""
    held.append(chunk)


def truncated(send, chunk, held):
    send(chunk[:-4])


def flipped(send, chunk, held):
    send(chunk[:20] + bytes([chunk[20] ^ 0x10]) + chunk[21:])


def test_a_sound_send_run_is_correct_and_reads_send_ms(small, short,
                                                       monkeypatch):
    """The traced path with a trace that saw nothing (the CPU has no
    card): the cell's per-layer metrics from its calls, send_ms among
    them."""
    def segment(call, seconds, host=False):
        call()
        return trace.Segment([], 0.0, 1)
    monkeypatch.setattr(harness.tr, "segment", segment)
    result = run(small, traced=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= B
    assert result["checks"]["walk_errors"]["value"] == 0
    assert result["checks"]["coeff_mismatches"]["value"] == 0
    assert result["metrics"]["send_ms"]["value"] > 0
    assert {"host_ms.small", "registry_evictions", "alloc_retries",
            "send_ms"} == set(result["metrics"])


@pytest.mark.parametrize("where,act", [(3, dropped), (3, duplicated),
                                       (1, reordered), (3, truncated)])
def test_a_chunk_astray_is_a_walk_error(small, short, monkeypatch, where,
                                        act):
    sends(monkeypatch, at_chunk(where, act))
    result = run(small)
    assert not result["correct"], result["checks"]
    assert result["checks"]["walk_errors"]["value"] > 0


def test_a_flipped_byte_shows_in_coeff_mismatches(small, short,
                                                  monkeypatch):
    sends(monkeypatch, at_chunk(1, flipped))
    result = run(small)
    assert not result["correct"]
    assert result["checks"]["coeff_mismatches"]["value"] > 0


@pytest.mark.parametrize("per", [1, 2, 4])
def test_the_sink_stamps_each_limbs_first_and_last_chunk(per, monkeypatch):
    """Three limbs of `per` chunks: every chunk kept in order, two clock
    reads a limb, at its first and its last chunk."""
    clock = iter(range(10 ** 6, 2 * 10 ** 6, 1000))
    monkeypatch.setattr(harness.time, "perf_counter_ns", clock.__next__)
    sink = harness.Sink(limb_chunks=per)
    for i in range(3 * per):
        sink.send(bytes([i]))
    assert [c[0] for c in sink.chunks] == list(range(3 * per))
    assert sink.stamps == list(range(10 ** 6, 10 ** 6 + 6000, 1000))
    assert sink.send_ms() == pytest.approx(3 * 1e-3)
    sink.reset()
    assert sink.chunks == [] and sink.stamps == []


# sha256 (first 16 hex digits) of a file's inputs at n = 4096 from seed
# 2**31 + 5: the secret key, the pk seed, the value pool, the seeds of
# calls 0, 1, 2, 64 and 130, and the sample's first draws; as the
# generator gave them before `send` was a key.
INPUTS = {"sym.b1024": "d3cad83acbd990ce", "sym.b16": "0170a51b5ca44832",
          "asym.b1024": "69269cbdf1515658", "asym.b512": "8fac8551e7fb35cc"}


def inputs_digest(mix) -> str:
    t = traffic.Traffic(4096, mix, 2 ** 31 + 5)
    h = hashlib.sha256()
    h.update(t.sk.tobytes())
    h.update(t.pk_seed)
    h.update(t.pool.tobytes())
    t.prepare(3)
    for k in (0, 1, 2, 64, 130):
        share, err = t.seeds(k)
        for s in (share or []) + err:
            h.update(s)
    h.update(t.sample_rng.integers(1 << 30, size=8).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_the_traffic_files_without_send_give_the_same_inputs(name):
    mix = Catalog().traffic(name)
    assert traffic.validate(mix) is mix and "send" not in mix
    assert inputs_digest(mix) == INPUTS[name]


@pytest.mark.parametrize("name", ["sym.b1024", "sym.b16"])
def test_a_send_form_changes_no_input(name):
    mix = dict(Catalog().traffic(name), send="components")
    assert traffic.validate(mix) is mix
    assert inputs_digest(mix) == INPUTS[name]


def test_an_unknown_send_form_is_refused_by_name(tmp_path, short):
    with pytest.raises(ValueError, match="'semaphore'"):
        Catalog().wire("semaphore")
    catalog = send_copy(tmp_path, form="semaphore")
    with pytest.raises(ValueError, match="'semaphore'"):
        harness.run(catalog, CELL, SEED, 0.01, False, "cpu")
    with pytest.raises(ValueError):
        traffic.validate(dict(Catalog().traffic("sym.b16"), send=3))


FRESH_FORM = '''"""The reference's order read as one buffer: (L, B, 2, n)."""
import pathlib

import numpy as np

KWARGS = {}


def limb_chunks(batch):
    return 2 * batch


def read(chunks, params, batch):
    pathlib.Path(__file__).with_suffix(".read").touch()
    L, n = params.nprimes, params.degree
    whole = b"".join(chunks)
    bad = 0 if len(whole) == L * batch * 2 * n * 4 else len(chunks)
    if bad:
        return [(np.zeros(0, np.uint32),) * 2] * batch, bad
    a = np.frombuffer(whole, "<u4").reshape(L, batch, 2, n)
    return [(a[:, b, 0].copy(), a[:, b, 1].copy())
            for b in range(batch)], bad
'''


def test_a_wire_form_is_added_as_a_file(tmp_path, short):
    """A fresh form module in a copy of the repository, a traffic file
    and a cell naming it: found and run, with no other edit."""
    repo = tmp_path / "repo"
    shutil.copytree(REPO / "benchmark", repo / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (repo / "benchmark").rglob("*")
              if p.is_file()}
    (repo / "benchmark/wire/whole.py").write_text(FRESH_FORM)
    mix = dict(json.loads((repo / "benchmark/traffic/sym.b16.json")
                          .read_text()), batch=B, send="whole")
    (repo / "benchmark/traffic/sym.b4.whole.json").write_text(
        json.dumps(mix))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "n4096.sym.b4.whole",
                              "config": "seal-default-n4096",
                              "traffic": "sym.b4.whole", "chips": 1,
                              "why": "a wire form added as a file"})
    (repo / "BENCHMARK.json").write_text(json.dumps(spec))
    catalog = Catalog(repo)
    assert "whole" in catalog.wire_files()
    result = harness.run(catalog, "n4096.sym.b4.whole", SEED, 0.01, False,
                         "cpu")
    assert result["correct"], result["checks"]
    assert result["checks"]["walk_errors"]["value"] == 0
    assert (repo / "benchmark/wire/whole.read").exists()
    for p, data in before.items():
        assert p.read_bytes() == data
