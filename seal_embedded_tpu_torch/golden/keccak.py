"""Pure-Python SHAKE-256 (FIPS 202) — bit-exactness oracle.

Implements the same XOF the reference uses for its PRNG
(reference: device/lib/shake256/fips202.c, keccakf1600.c — standard
Keccak-f[1600], rate 136).  Written from the FIPS 202 specification and,
via hashlib, self-checked against CPython's SHA-3 implementation.  A copy
of ``seal_embedded_tpu/golden/keccak.py`` (see ``golden/__init__.py``).
"""

from __future__ import annotations

import hashlib

MASK64 = (1 << 64) - 1

# Rotation offsets and round constants of Keccak-f[1600] (FIPS 202 §3.2).
_RHO = (
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
)

_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

SHAKE256_RATE = 136


def _rol(x: int, s: int) -> int:
    return ((x << s) | (x >> (64 - s))) & MASK64


def keccak_f1600(state: list[int]) -> list[int]:
    """One Keccak-f[1600] permutation over 25 64-bit lanes (lane order:
    state[x + 5*y])."""
    a = list(state)
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _RHO[x + 5 * y])
        # chi
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & b[(i % 5 + 2) % 5 + 5 * (i // 5)] & MASK64)
            for i in range(25)
        ]
        # iota
        a[0] ^= rc
    return a


def shake256(data: bytes, outlen: int) -> bytes:
    """SHAKE-256 XOF: absorb `data`, squeeze `outlen` bytes."""
    state = [0] * 25
    rate = SHAKE256_RATE

    # Absorb full blocks.
    off = 0
    while len(data) - off >= rate:
        block = data[off:off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = keccak_f1600(state)
        off += rate

    # Final (padded) block: multi-rate pad 0x1F ... 0x80.
    block = bytearray(rate)
    rem = data[off:]
    block[: len(rem)] = rem
    block[len(rem)] ^= 0x1F
    block[rate - 1] ^= 0x80
    for i in range(rate // 8):
        state[i] ^= int.from_bytes(bytes(block[8 * i:8 * i + 8]), "little")

    # Squeeze.
    out = bytearray()
    while len(out) < outlen:
        state = keccak_f1600(state)
        for i in range(rate // 8):
            out += state[i].to_bytes(8, "little")
    return bytes(out[:outlen])


def shake256_hashlib(data: bytes, outlen: int) -> bytes:
    """hashlib-backed SHAKE-256, used to cross-check the implementation above."""
    return hashlib.shake_256(data).digest(outlen)
