"""Samplers — bit-exactness oracle.

Reproduces the reference's samplers at byte-consumption granularity
(reference: device/lib/sample.c).  The exact PRNG call pattern matters for
bit-exactness: rejection re-draws consume whole new PRNG calls (fresh
counters), and block-based samplers consume one call per block.  A copy
of ``seal_embedded_tpu/golden/sampling.py`` (see ``golden/__init__.py``).
"""

from __future__ import annotations

from .prng import Prng


def _hamming_weight(b: int) -> int:
    return bin(b).count("1")


def sample_poly_uniform(n: int, q: int, prng: Prng) -> list[int]:
    """Uniform sampling mod q with per-word rejection (sample.c:39-57).

    One fill of 4n bytes, then each word >= max_multiple is re-drawn with a
    fresh 4-byte fill (new counter) until accepted.
    """
    max_multiple = 0xFFFFFFFF - (0xFFFFFFFF % q) - 1
    buf = prng.fill(4 * n)
    out = []
    for i in range(n):
        rand = int.from_bytes(buf[4 * i:4 * i + 4], "little")
        while rand >= max_multiple:
            rand = int.from_bytes(prng.fill(4), "little")
        out.append(rand % q)
    return out


def sample_small_poly_ternary_96(n: int, prng: Prng) -> bytes:
    """Compressed ternary sampling, 96-byte blocks (sample.c:218-242).

    Returns n/4 bytes, 4 two-bit values per byte, value v at index i stored at
    bit position 6 - 2*(i%4) of byte i//4.  Stored values are in {0,1,2} with
    the SEAL mapping (0 -> q-1, 1 -> 0, 2 -> 1 upon expansion).
    Per-byte rejection: byte >= 0xFE is re-drawn with a 1-byte fill.
    """
    packed = bytearray((n + 3) // 4)
    for j in range(0, n, 96):
        buf = prng.fill(96)
        i_stop = 96 if j + 95 < n else n - j
        for i in range(i_stop):
            rand = buf[i]
            while rand >= 0xFE:
                rand = prng.fill(1)[0]
            val = rand % 3
            idx = i + j
            shift = 6 - (idx % 4) * 2
            packed[idx // 4] |= val << shift
    return bytes(packed)


def expand_poly_ternary(packed: bytes, n: int, q: int) -> list[int]:
    """Expand compressed ternary to mod-q values: 0 -> q-1, 1 -> 0, 2 -> 1
    (sample.c:98-129)."""
    out = []
    for idx in range(n):
        shift = 6 - (idx % 4) * 2
        val = (packed[idx // 4] >> shift) & 0x3
        out.append(q - 1 if val == 0 else val - 1)
    return out


def ternary_signed(packed: bytes, n: int) -> list[int]:
    """Compressed ternary as signed values in {-1, 0, 1} (0 -> -1, 1 -> 0,
    2 -> 1)."""
    out = []
    for idx in range(n):
        shift = 6 - (idx % 4) * 2
        val = (packed[idx // 4] >> shift) & 0x3
        out.append(val - 1)
    return out


def _cbd_val(x: bytes) -> int:
    """One CBD(k=21) sample from 6 bytes, sigma ~= 3.24 (sample.c:278-284)."""
    return (
        _hamming_weight(x[0]) + _hamming_weight(x[1]) + _hamming_weight(x[2] & 0x1F)
        - _hamming_weight(x[3]) - _hamming_weight(x[4]) - _hamming_weight(x[5] & 0x1F)
    )


def sample_poly_cbd_16(n: int, prng: Prng) -> list[int]:
    """CBD error sampling, 16 samples (96 bytes) per PRNG call
    (sample.c:311-321)."""
    out = []
    for j in range(0, n, 16):
        buf = prng.fill(96)
        for i in range(16):
            out.append(_cbd_val(buf[6 * i:6 * i + 6]))
    return out


def sample_add_poly_cbd_16(poly: list[int], prng: Prng) -> list[int]:
    """In-place-add CBD variant feeding encode output (sample.c:347-356)."""
    n = len(poly)
    err = sample_poly_cbd_16(n, prng)
    return [p + e for p, e in zip(poly, err)]
