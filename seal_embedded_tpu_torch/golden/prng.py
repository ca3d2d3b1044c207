"""Counter-mode SHAKE-256 PRNG — bit-exactness oracle.

Reproduces the reference PRNG exactly (reference: device/lib/rng.h:26-91):
each `fill(byte_count)` call produces `shake256(seed || counter_le8,
byte_count)` and increments the 64-bit counter by one.  The 64-byte seed size
matches SEAL's seeded-ciphertext format (defines.h:62-67).  A copy of
``seal_embedded_tpu/golden/prng.py`` (see ``golden/__init__.py``).
"""

from __future__ import annotations

from ..config import SEED_BYTE_COUNT
from .keccak import shake256_hashlib as _shake256


class Prng:
    """SE_PRNG equivalent: 64-byte seed + 64-bit call counter."""

    def __init__(self, seed: bytes = b"", counter: int = 0):
        assert len(seed) <= SEED_BYTE_COUNT
        self.seed = seed.ljust(SEED_BYTE_COUNT, b"\x00")
        self.counter = counter

    def fill(self, byte_count: int) -> bytes:
        out = _shake256(
            self.seed + self.counter.to_bytes(8, "little"), byte_count
        )
        self.counter = (self.counter + 1) & 0xFFFFFFFFFFFFFFFF
        assert self.counter != 0, "PRNG counter overflow"
        return out
