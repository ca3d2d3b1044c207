"""The one traffic generator: a traffic file's parameters and --seed give
every input of a run.

A traffic file holds what the traffic varies, and nothing else:
``encrypt_type`` (sym or asym), ``batch`` (messages a call) and
``values`` (``low`` and ``high`` of the uniform values), and optionally
``send``, the wire form (``wire/<send>.py``, found by the catalog) in
which the call hands each ciphertext to the API's send callback; without
it the call returns its limbs as arrays.  The form changes no input.
Every cell is one caller in a closed loop; a file with any other key is
refused, so a mix this generator cannot make is never run as one it can.

From the seed, each drawn from a stream of its own:

* the secret key, ternary (n,), and the public key's 64-byte seed;
* a pool of VALUE_BATCHES batches of values, float32 uniform in
  [low, high), `batch` messages of n/2 each; call k sends batch k mod the
  pool's size;
* every message's own 64-byte seeds (for sym a shareable and a private
  one, for asym a private one), read from one byte stream in call order,
  so no seed repeats and call k's seeds do not depend on how many calls
  the window holds;
* which messages the check compares (Sample).
"""

from __future__ import annotations

import numpy as np

SEED_BYTES = 64
CHUNK_CALLS = 64
VALUE_BATCHES = 4        # distinct batches of values a run sends in turn
CHECK_MESSAGES = 30      # calls of the window the check samples a message of
KEYS = {"encrypt_type", "batch", "values"}
OPTIONAL = {"send"}
_SK, _PK, _VALUES, _SEEDS, _SAMPLE = range(5)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed & (2 ** 64 - 1), stream])))


def validate(mix: dict) -> dict:
    """The traffic file's parameters, or ValueError where it holds a key
    or a value the generator does not make."""
    if not KEYS <= set(mix) <= KEYS | OPTIONAL \
            or set(mix["values"]) != {"low", "high"}:
        raise ValueError(f"a traffic file holds exactly {sorted(KEYS)}, "
                         f"values with low and high, and may hold "
                         f"{sorted(OPTIONAL)}; got {sorted(mix)}")
    if not isinstance(mix.get("send", ""), str):
        raise ValueError(f"send names a wire form; got {mix['send']!r}")
    if mix["encrypt_type"] not in ("sym", "asym"):
        raise ValueError(f"unknown encrypt type {mix['encrypt_type']!r}")
    if int(mix["batch"]) < 1 or not mix["values"]["low"] < \
            mix["values"]["high"]:
        raise ValueError(f"no messages to make from {mix}")
    return mix


class Traffic:
    """The inputs of one run: a configuration's degree under a traffic
    file's parameters, from `seed`."""

    def __init__(self, degree: int, mix: dict, seed: int):
        validate(mix)
        self.n = degree
        self.kind = mix["encrypt_type"]
        self.batch = int(mix["batch"])
        self.seeds_per_message = 2 if self.kind == "sym" else 1
        rng = _rng(seed, _SK)
        self.sk = rng.integers(-1, 2, degree).astype(np.int32)
        self.pk_seed = _rng(seed, _PK).bytes(SEED_BYTES)
        lo, hi = mix["values"]["low"], mix["values"]["high"]
        self.pool = _rng(seed, _VALUES).uniform(
            lo, hi, (VALUE_BATCHES, self.batch, degree // 2)
        ).astype(np.float32)
        self._seed_gen = _rng(seed, _SEEDS)
        self._chunks: list = []     # bytes of CHUNK_CALLS calls each
        self._lists: list = []      # call k's seed lists, made by prepare
        per = self.seeds_per_message  # message b's seed j: slot per * b + j
        self._slices = [[slice((per * b + j) * SEED_BYTES,
                               (per * b + j + 1) * SEED_BYTES)
                         for b in range(self.batch)] for j in range(per)]
        self.sample_rng = _rng(seed, _SAMPLE)

    @property
    def call_bytes(self) -> int:
        return self.batch * self.seeds_per_message * SEED_BYTES

    def _raw(self, k: int) -> tuple:
        """Call k's seed bytes: (chunk, offset of the call in it).  Drawn
        in chunks of CHUNK_CALLS calls, always in the same order."""
        while len(self._chunks) * CHUNK_CALLS <= k:
            self._chunks.append(
                self._seed_gen.bytes(CHUNK_CALLS * self.call_bytes))
        return self._chunks[k // CHUNK_CALLS], \
            (k % CHUNK_CALLS) * self.call_bytes

    def _make(self, k: int) -> tuple:
        raw, base = self._raw(k)
        get = raw[base:base + self.call_bytes].__getitem__
        lists = [list(map(get, s)) for s in self._slices]
        return (lists[0], lists[1]) if len(lists) == 2 else (None, lists[0])

    def prepare(self, calls: int) -> None:
        """Make the seed lists of calls [0, calls) now, before any timing,
        so that seeds(k) of those calls only hands them out."""
        while len(self._lists) < calls:
            self._lists.append(self._make(len(self._lists)))

    @property
    def prepared(self) -> int:
        return len(self._lists)

    def values(self, k: int) -> np.ndarray:
        return self.pool[k % len(self.pool)]

    def seeds(self, k: int) -> tuple:
        """Call k's seeds as the API takes them, lists of 64-byte `bytes`:
        (shareable, private) for sym, (None, private) for asym."""
        return self._lists[k] if k < len(self._lists) else self._make(k)

    def message(self, k: int, row: int) -> tuple:
        """(values (n/2,), shareable seed or None, private seed) of message
        `row` of call k."""
        share, err = self.seeds(k)
        return (self.values(k)[row], share[row] if share else None, err[row])


class Sample:
    """Which messages the check compares: `size` calls drawn uniformly
    from all the calls of the window by reservoir sampling, one message
    of each drawn from the seed, plus the first and last message of the
    window's last call."""

    def __init__(self, batch: int, rng: np.random.Generator):
        self.size = CHECK_MESSAGES
        self.batch = batch
        self.rng = rng

    def offer(self, k: int):
        """The row of the window's call k to keep and the slot to keep it
        in (slot k while the first `size` calls fill the slots), or None:
        after call k, every call so far is kept with the same chance."""
        row = int(self.rng.integers(self.batch))
        if k < self.size:
            return row, k
        slot = int(self.rng.integers(k + 1))
        return (row, slot) if slot < self.size else None
