"""CKKS encode (ckks_common.c:105-215, fft.c:69-144), rows at once.

Each row's n/2 real values go to index_map[i] and index_map[i + n/2],
an in-place IFFT with the reference's conjugated roots runs over the
rows, and each coefficient is rounded half away from zero after the
product by scale / n.  The configuration states float64; `dtype`
float32 computes the same steps one precision lower (the control of the
benchmark's check).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from .params import Params, bitrev


@lru_cache(maxsize=8)
def index_map(n: int) -> np.ndarray:
    """The generator-3 orbit merged with bit reversal
    (ckks_common.c:32-68)."""
    logn = n.bit_length() - 1
    out = np.zeros(n, dtype=np.int64)
    pos = 1
    for i in range(n // 2):
        index1 = (pos - 1) // 2
        out[i] = bitrev(index1, logn)
        out[i + n // 2] = bitrev(n - index1 - 1, logn)
        pos = (pos * 3) & (2 * n - 1)
    return out


def _root(k: int, m: int) -> complex:
    """W^k for W = exp(2 pi i / m), as fft.c:27-45 computes it."""
    k &= m - 1
    angle = 2 * math.pi * float(k) / float(m)
    return complex(math.cos(angle), math.sin(angle))


@lru_cache(maxsize=8)
def _conj_roots(n: int) -> tuple:
    """conj(W^bitrev(t, logn)) for t in [0, n), real and imaginary parts."""
    logn = n.bit_length() - 1
    r = [_root(bitrev(t, logn), 2 * n).conjugate() for t in range(n)]
    return (np.array([z.real for z in r]), np.array([z.imag for z in r]))


def c_round(x: np.ndarray) -> np.ndarray:
    """C99 round(): half away from zero."""
    return np.where(x < 0, -np.floor(-x + 0.5), np.floor(x + 0.5))


def encode(p: Params, values: np.ndarray, dtype=np.float64) -> np.ndarray:
    """values float32 (R, n/2) -> the plaintexts int64 (R, n)."""
    n = p.degree
    values = np.asarray(values, dtype=np.float32)
    rows = values.shape[0]
    if values.shape[1] != n // 2:
        raise ValueError(f"a message holds n/2 = {n // 2} values")
    imap = index_map(n)
    re = np.zeros((rows, n), dtype=dtype)
    im = np.zeros((rows, n), dtype=dtype)
    re[:, imap[:n // 2]] = values
    re[:, imap[n // 2:]] = values
    s_re, s_im = (s.astype(dtype) for s in _conj_roots(n))
    tt, h = 1, n // 2
    while h >= 1:
        # Row r, group j: u = v[2tt j : 2tt j + tt], w = the next tt.
        vr = re.reshape(rows, h, 2, tt)
        vi = im.reshape(rows, h, 2, tt)
        sr = s_re[h:2 * h][None, :, None]
        si = s_im[h:2 * h][None, :, None]
        ur, ui = vr[:, :, 0].copy(), vi[:, :, 0].copy()
        wr, wi = vr[:, :, 1], vi[:, :, 1]
        dr, di = ur - wr, ui - wi
        vr[:, :, 0] = ur + wr
        vi[:, :, 0] = ui + wi
        vr[:, :, 1] = dr * sr - di * si
        vi[:, :, 1] = dr * si + di * sr
        tt, h = tt * 2, h // 2
    coeffs = c_round(re * (dtype(p.scale) / dtype(n)))
    return coeffs.astype(np.int64)
