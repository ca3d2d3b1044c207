"""A whole run on the CPU, the look for a card skipped, with the timed
path broken underneath: `correct` has to come out false for each fault
the cells can have, and true with none.

The faults are planted in the program (seal_embedded_tpu_torch.ckks.
stream), where each limb is produced:
* a step that returns its state unchanged (sym: the shareable stream's
  counter not carried to the next limb);
* a limb that hands on the one before it (a ring slot not rewritten);
* half of the batch left out (its rows zero);
* an answer altered where it is produced (one coefficient of c0 in every
  message and limb).
The exchange between chips has no fault here: every cell runs on one
card.  The runs are small (n = 4096, three primes, B = 4): the traffic
files of the cells with only the batch cut, and the harness's warm-up,
value pool and sample cut.
"""

import pytest

from benchmark import harness, traffic
from benchmark.tests import copies

B = 4


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A copy of the benchmark whose traffic runs B = 4 on the CPU."""
    return copies.copy(tmp_path_factory.mktemp("bench"), batch=B)


@pytest.fixture(autouse=True)
def short(monkeypatch):
    """One warm-up call, two batches of values, two sampled calls."""
    monkeypatch.setattr(harness, "WARMUP_CALLS", 1)
    monkeypatch.setattr(traffic, "VALUE_BATCHES", 2)
    monkeypatch.setattr(traffic, "CHECK_MESSAGES", 2)


@pytest.fixture
def stream(monkeypatch):
    """The program's stream module, its cached streams built anew so that
    a planted fault reaches them."""
    from seal_embedded_tpu_torch.ckks import stream as st
    st._sym_stream.cache_clear()
    st._asym_stream.cache_clear()
    yield st
    st._sym_stream.cache_clear()
    st._asym_stream.cache_clear()


def run(catalog, cell, seed=2 ** 31 + 11):
    return harness.run(catalog, cell, seed, 0.01, False, "cpu")


def stale_state(st, monkeypatch):
    step = st._SymSteps.step

    def unchanged(self, j, carry, out=None):
        return carry, step(self, j, carry, out)[1]
    monkeypatch.setattr(st._SymSteps, "step", unchanged)


def stale_limb(st, monkeypatch):
    host_form, last = st._host_form, []

    def late(c0, c1, ok, out=None):
        now = tuple(t.clone() for t in host_form(c0, c1, ok, None))
        last.append(now)
        return last[-2] if len(last) > 1 else now
    monkeypatch.setattr(st, "_host_form", late)


def half_batch(st, monkeypatch):
    host_form = st._host_form

    def half(c0, c1, ok, out=None):
        got = host_form(c0, c1, ok, out)
        for t in got[:2]:
            t[B // 2:] = 0
        return got
    monkeypatch.setattr(st, "_host_form", half)


def altered(st, monkeypatch):
    host_form = st._host_form

    def bumped(c0, c1, ok, out=None):
        got = host_form(c0, c1, ok, out)
        got[0][:, 7] += 1
        return got
    monkeypatch.setattr(st, "_host_form", bumped)


@pytest.mark.parametrize("cell", ["n4096.sym.b16", "n4096.asym.b1024"])
def test_a_sound_run_is_correct(small, stream, cell):
    result = run(small, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= B
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [
    ("n4096.sym.b16", stale_state),
    ("n4096.sym.b16", stale_limb),
    ("n4096.sym.b16", half_batch),
    ("n4096.sym.b16", altered),
    ("n4096.asym.b1024", stale_limb),
    ("n4096.asym.b1024", half_batch),
    ("n4096.asym.b1024", altered),
])
def test_a_fault_in_the_timed_path_is_not_correct(small, stream, monkeypatch,
                                                  cell, fault):
    fault(stream, monkeypatch)
    result = run(small, cell)
    assert not result["correct"], result["checks"]
    assert result["checks"]["coeff_mismatches"]["value"] > 0


def test_a_call_that_raises_fails_its_messages(small, stream, monkeypatch):
    """The warm-up call runs; every window call raises, as the stream does
    where a limb's ok is false."""
    encrypt, calls = stream.se_encrypt_streaming, []

    def broken(*args, **kw):
        calls.append(1)
        if len(calls) > 1:
            raise AssertionError("sampler overflow at prime 1")
        return encrypt(*args, **kw)
    monkeypatch.setattr(stream, "se_encrypt_streaming", broken)
    result = run(small, "n4096.sym.b16")
    assert not result["correct"]
    assert result["failed"] == result["attempted"] > 0
