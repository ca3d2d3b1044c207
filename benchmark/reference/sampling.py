"""The reference's PRNG and samplers, one message at a time.

Prng is SEAL-Embedded's SE_PRNG (rng.h:26-91): every fill(k) returns
SHAKE-256(seed || counter as 8 little-endian bytes, k bytes) and steps
the counter.  The samplers consume fills in the reference's order
(sample.c): a rejected word or byte is drawn again from a fresh fill, so
their outputs depend on that order, which each loop below keeps.
"""

from __future__ import annotations

import hashlib

import numpy as np

SEED_BYTES = 64
MASK64 = (1 << 64) - 1

# Bits set in each byte value, for the CBD's Hamming weights.
_POPCOUNT = np.array([bin(b).count("1") for b in range(256)], dtype=np.int64)


class Prng:
    def __init__(self, seed: bytes, counter: int = 0):
        if len(seed) > SEED_BYTES:
            raise ValueError("a PRNG seed has at most 64 bytes")
        self.seed = seed.ljust(SEED_BYTES, b"\x00")
        self.counter = counter

    def fill(self, nbytes: int) -> bytes:
        out = hashlib.shake_256(
            self.seed + self.counter.to_bytes(8, "little")).digest(nbytes)
        self.counter = (self.counter + 1) & MASK64
        return out


def max_multiple(q: int) -> int:
    """The first rejected 32-bit word of the uniform draw mod q
    (sample.c:39-57)."""
    return 0xFFFFFFFF - (0xFFFFFFFF % q) - 1


def uniform(prng: Prng, n: int, q: int) -> np.ndarray:
    """n values uniform mod q (sample.c:39-57): one fill of 4n bytes, then
    each word at or above max_multiple drawn again, in order, from fresh
    4-byte fills until one is below it.  int64 (n,)."""
    words = np.frombuffer(prng.fill(4 * n), dtype="<u4").astype(np.int64)
    limit = max_multiple(q)
    for i in np.flatnonzero(words >= limit):
        w = limit
        while w >= limit:
            w = int.from_bytes(prng.fill(4), "little")
        words[i] = w
    return words % q


def ternary(prng: Prng, n: int) -> np.ndarray:
    """n values in {-1, 0, 1} (sample.c:218-242): 96-byte blocks, each
    byte >= 0xFE drawn again from fresh 1-byte fills, value byte % 3 - 1.
    int64 (n,)."""
    out = np.empty(n, dtype=np.int64)
    for j in range(0, n, 96):
        block = np.frombuffer(prng.fill(96), dtype=np.uint8)
        block = block[:min(96, n - j)].astype(np.int64)
        for i in np.flatnonzero(block >= 0xFE):
            b = 0xFE
            while b >= 0xFE:
                b = prng.fill(1)[0]
            block[i] = b
        out[j:j + block.size] = block % 3 - 1
    return out


def cbd(prng: Prng, n: int) -> np.ndarray:
    """n centred binomial values (k = 21, sample.c:278-321): 16 values a
    96-byte fill, each from 6 bytes as hw(x0) + hw(x1) + hw(x2 & 0x1F) -
    hw(x3) - hw(x4) - hw(x5 & 0x1F).  int64 (n,)."""
    raw = b"".join(prng.fill(96) for _ in range(n // 16))
    x = np.frombuffer(raw, dtype=np.uint8).reshape(n, 6).astype(np.int64)
    x[:, 2] &= 0x1F
    x[:, 5] &= 0x1F
    hw = _POPCOUNT[x]
    return hw[:, 0] + hw[:, 1] + hw[:, 2] - hw[:, 3] - hw[:, 4] - hw[:, 5]
