"""The ternary draw's unbounded redraw, as the C loop has it
(sample.c:218-242), and the rule every asym entry of the API shares for
the rows whose bounded refill queue fell short (ckks/asym.py
``redo_overflowed``).

The oracle is the NumPy reference of the benchmark
(``benchmark/reference``), not the JAX package: the JAX package bounds
the refills at 8 a block as the port's captured graphs do, and clears ok
where the C loop would draw on (ROADMAP R6).  Two seeds, each its 8
little-endian bytes padded with zeros to 64, need more than 8 refills in
their first block: 8337867 rejects 9 bytes of it, 2647653 rejects 8 and
one refill.  With ``TERNARY_QUEUE_CAP`` patched to 1 most rows of a batch
fall short, so every row of it takes the rule's path."""

import json
import pathlib
import sys
from functools import lru_cache

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import perf_spans  # noqa: E402
from benchmark.catalog import Catalog  # noqa: E402
from benchmark.reference import ckks as rckks  # noqa: E402
from benchmark.reference import sampling as rsp  # noqa: E402
from benchmark.reference.params import from_config  # noqa: E402
from seal_embedded_tpu_torch import api as tapi  # noqa: E402
from seal_embedded_tpu_torch.ckks import asym as tasym  # noqa: E402
from seal_embedded_tpu_torch.ckks import stream as tstream  # noqa: E402
from seal_embedded_tpu_torch.config import Parms  # noqa: E402
from seal_embedded_tpu_torch.ops import keccak as kc  # noqa: E402
from seal_embedded_tpu_torch.ops import sampling as tsp  # noqa: E402
from seal_embedded_tpu_torch.utils import timing  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
OVERFLOWING = (8337867, 2647653)
B = 8
PLANTED = (0, 5)            # the rows that hold the two seeds


def seed_of(value: int) -> bytes:
    return value.to_bytes(8, "little").ljust(64, b"\x00")


def words(seeds) -> torch.Tensor:
    return torch.as_tensor(np.stack([kc.seed_to_words(s) for s in seeds])
                           .astype(np.int64))


def counter_value(c) -> int:
    return int(c[0]) | int(c[1]) << 32


@pytest.fixture
def cap_one(monkeypatch):
    monkeypatch.setattr(tsp, "TERNARY_QUEUE_CAP", 1)


# ------------------------------------------------------------- the draw

@pytest.mark.parametrize("n", [96, 1024, 4096])
def test_the_exact_draw_equals_the_c_loop(n):
    """Both seeds and one that the cap holds: values and next counter of
    sample_ternary_exact equal the reference's ternary and its Prng's
    counter (n = 1024 ends in a tail block of 64)."""
    seeds = [seed_of(v) for v in OVERFLOWING] + [bytes(range(64))]
    u, counter = tsp.sample_ternary_exact(words(seeds),
                                          tsp.counter_zero((3,)), n)
    for i, seed in enumerate(seeds):
        prng = rsp.Prng(seed)
        assert np.array_equal(u[i].numpy(), rsp.ternary(prng, n)), i
        assert counter_value(counter[i]) == prng.counter, i


@pytest.mark.parametrize("n", [96, 1024, 4096])
def test_the_bounded_draw_flags_both_seeds_and_keeps_the_rest(n):
    """The bounded queue clears ok for both seeds; where the cap holds it
    gives the exact draw's bits and counter."""
    seeds = [seed_of(v) for v in OVERFLOWING] + [bytes(range(64))]
    w, c = words(seeds), tsp.counter_zero((3,))
    u, after, ok = tsp.sample_ternary(w, c, n)
    exact, exact_after = tsp.sample_ternary_exact(w, c, n)
    assert ok.tolist() == [False, False, True]
    assert torch.equal(u[2], exact[2]) and torch.equal(after[2],
                                                       exact_after[2])


def test_the_exact_draw_doubles_a_queue_of_one(cap_one):
    """With one refill a block, most blocks fall short, several twice
    over: every stream still equals the C loop."""
    rng = np.random.default_rng(19)
    seeds = [rng.bytes(64) for _ in range(6)]
    u, counter = tsp.sample_ternary_exact(words(seeds),
                                          tsp.counter_zero((6,)), 4096)
    assert not tsp.sample_ternary(words(seeds), tsp.counter_zero((6,)),
                                  4096)[2].any()
    for i, seed in enumerate(seeds):
        prng = rsp.Prng(seed)
        assert np.array_equal(u[i].numpy(), rsp.ternary(prng, 4096)), i
        assert counter_value(counter[i]) == prng.counter, i


# -------------------------------------------------------- the API's rule

@lru_cache(maxsize=None)
def _setup():
    """The 4096/3 configuration of the benchmark, a context set up from a
    secret key and a pk seed on the CPU, and the reference's pk."""
    p = from_config(Catalog().config("seal-default-n4096"))
    rng = np.random.default_rng(11)
    sk = rng.integers(-1, 2, p.degree).astype(np.int32)
    pk_seed = rng.bytes(64)
    ctx = tapi.se_setup_custom(p.degree, p.nprimes, p.scale, tapi.ASYM,
                               sk=sk, pk_seed=pk_seed, device=CPU)
    return p, ctx, rckks.public_key(p, sk, pk_seed)


def _batch(p, seed=12):
    rng = np.random.default_rng(seed)
    values = rng.uniform(-1, 1, (B, p.degree // 2)).astype(np.float32)
    seeds = [rng.bytes(64) for _ in range(B)]
    for row, v in zip(PLANTED, OVERFLOWING):
        seeds[row] = seed_of(v)
    return values, seeds


def _short_rows(seeds, n) -> int:
    """Rows whose bounded queue falls short at the cap in force."""
    ok = tsp.sample_ternary(words(seeds), tsp.counter_zero((len(seeds),)),
                            n)[2]
    return int((~ok).sum())


def _streaming(ctx, values, seeds):
    limbs = tstream.se_encrypt_streaming(ctx, values, err_seeds=seeds)
    assert [l["prime_idx"] for l in limbs] == list(range(ctx.parms.nprimes))
    assert all(l["ok"] is True for l in limbs)
    return (np.stack([l["c0"] for l in limbs]),
            np.stack([l["c1"] for l in limbs]))


def _seeded(ctx, values, seeds):
    out = tapi.se_encrypt_seeded(ctx, values, seeds=seeds)
    assert sorted(out) == ["c0", "c1", "ok", "pt", "pte"]
    assert bool(out["ok"].all())
    return out["c0"].numpy(), out["c1"].numpy()


@pytest.mark.parametrize("cap", [8, 1])
@pytest.mark.parametrize("entry", [_streaming, _seeded],
                         ids=["se_encrypt_streaming", "se_encrypt_seeded"])
def test_api_asym_rows_that_fell_short_equal_the_reference(
        monkeypatch, entry, cap):
    """B = 8 at 4096/3 with both seeds planted: every limb of every row
    equals the reference's asym_encrypt, no call raises, and the counter
    grows by the batch's messages and by the rows that fell short (the
    two planted at the cap of 8; most of the batch at a cap of 1)."""
    monkeypatch.setattr(tsp, "TERNARY_QUEUE_CAP", cap)
    p, ctx, pk = _setup()
    values, seeds = _batch(p)
    short = _short_rows(seeds, p.degree)
    assert short == 2 if cap == 8 else short > 2
    before = tasym.redo_counts()
    c0, c1 = entry(ctx, values, seeds)
    after = tasym.redo_counts()
    assert after["messages"] - before["messages"] == B
    assert after["rows"] - before["rows"] == short
    want0, want1 = rckks.asym_encrypt(p, pk[0], pk[1], values, seeds)
    assert np.array_equal(c0, want0) and np.array_equal(c1, want1)


def test_the_eager_and_public_streams_take_the_rule(cap_one):
    """The cached stream (asym_stream, whose steps the CPU runs eagerly)
    called directly on the context's key, and asym_encrypt_stream (its
    public function), forward and reverse, give the reference's limbs
    too, each limb its prime's."""
    p, ctx, pk = _setup()
    values, seeds = _batch(p, seed=13)
    w = words(seeds)
    want0, want1 = rckks.asym_encrypt(p, pk[0], pk[1], values, seeds)
    stream = tstream.asym_stream(ctx.parms, "forward", "cpu")
    runs = [stream(torch.as_tensor(values), *ctx._pk, w)]
    runs += [tstream.asym_encrypt_stream(values, ctx.pk0, ctx.pk1, w,
                                         ctx.parms, order=order)
             for order in ("forward", "reverse")]
    for limbs in runs:
        for limb in limbs:
            i = limb["prime_idx"]
            assert np.array_equal(limb["c0"], want0[i])
            assert np.array_equal(limb["c1"], want1[i])


# ----------------------------------------------- an encode overflow stays

P_SMALL = Parms(degree=1024, moduli=(1053818881,), scale=2.0 ** 25)


def _small_context():
    rng = np.random.default_rng(14)
    n = P_SMALL.degree
    pk = [np.stack([rng.integers(0, q, n) for q in P_SMALL.moduli]).astype(
        np.uint32) for _ in range(2)]
    return tapi._make_context(P_SMALL, tapi.ASYM, CPU, pk0=pk[0], pk1=pk[1])


def _overflowing_values(row=2):
    values = np.random.default_rng(15).uniform(
        -1, 1, (4, P_SMALL.degree // 2)).astype(np.float32)
    values[row] *= np.float32(1e25)     # |coeff| far past 2^63
    return values


@pytest.mark.parametrize("cap", [8, 1])
def test_an_encode_overflow_still_raises_in_the_stream(monkeypatch, cap):
    """A row whose encode overflows raises, whether or not its ternary
    draw fell short too (at a cap of 1 every row does)."""
    monkeypatch.setattr(tsp, "TERNARY_QUEUE_CAP", cap)
    seeds = [seed_of(v) for v in OVERFLOWING] + [bytes(64), bytes(range(64))]
    with pytest.raises(AssertionError, match="overflow"):
        tstream.se_encrypt_streaming(_small_context(), _overflowing_values(),
                                     err_seeds=seeds)


@pytest.mark.parametrize("cap", [8, 1])
def test_an_encode_overflow_clears_only_its_row_in_a_batch(monkeypatch, cap):
    """se_encrypt_seeded returns ok false on the overflowing row alone,
    the rows that were drawn again included."""
    monkeypatch.setattr(tsp, "TERNARY_QUEUE_CAP", cap)
    seeds = [seed_of(v) for v in OVERFLOWING] + [bytes(64), bytes(range(64))]
    out = tapi.se_encrypt_seeded(_small_context(), _overflowing_values(1),
                                 seeds=seeds)
    assert out["ok"].tolist() == [True, False, True, True]


# --------------------------------------------------------------- tracing

def test_a_call_that_runs_rows_again_has_a_redo_span(cap_one):
    """One stream.redo, a child of the call's api.call, after the first
    limb's wait; perf_spans reports its time and the call that had it."""
    ctx = _small_context()
    values = np.random.default_rng(16).uniform(
        -1, 1, (2, P_SMALL.degree // 2)).astype(np.float32)
    timing.take_spans()
    timing.record_spans(True)
    try:
        tstream.se_encrypt_streaming(
            ctx, values, err_seeds=[seed_of(v) for v in OVERFLOWING])
    finally:
        timing.record_spans(False)
    spans = timing.take_spans()
    root, = (s for s in spans if s.name == "api.call")
    redo, = (s for s in spans if s.name == "stream.redo")
    wait = min((s for s in spans if s.name == "fetch.wait"),
               key=lambda s: s.start_ns)
    assert redo.parent == root.id and redo.call == root.call
    assert wait.end_ns <= redo.start_ns <= redo.end_ns <= root.end_ns
    got = perf_spans.per_call(spans)
    assert got["redo_calls"] == 1 and got["redo_ms"] == redo.ms > 0
    assert json.loads(json.dumps(got))["calls"] == 1
