"""The forward negacyclic NTT mod q (ntt.c:124-165), rows at once.

Harvey's butterfly with the root w^bitrev(h + j) for group j of round h,
output in the reference's scrambled order, every step reduced exactly:
the reference's lazy [0, 4q) values converge to the same residues.
Values below 2^31 keep every product inside int64.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .params import bitrev


@lru_cache(maxsize=32)
def _twiddles(n: int, q: int, w: int) -> np.ndarray:
    """w^bitrev(t, logn) mod q for t in [0, n), int64."""
    logn = n.bit_length() - 1
    powers = [1] * n
    for e in range(1, n):
        powers[e] = powers[e - 1] * w % q
    return np.array([powers[bitrev(t, logn)] for t in range(n)],
                    dtype=np.int64)


def ntt(x: np.ndarray, q: int, w: int) -> np.ndarray:
    """x int64 (R, n), values in [0, q] -> its NTT mod q, int64 (R, n)."""
    rows, n = x.shape
    v = np.array(x, dtype=np.int64)
    s = _twiddles(n, q, w)
    h, tt = 1, n // 2
    while tt >= 1:
        g = v.reshape(rows, h, 2, tt)
        u = g[:, :, 0].copy()
        t = g[:, :, 1] * s[h:2 * h][None, :, None] % q
        g[:, :, 0] = (u + t) % q
        g[:, :, 1] = (u - t) % q
        h, tt = h * 2, tt // 2
    return v
