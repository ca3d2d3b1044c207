"""CKKS encode/decode — bit-exactness oracle.

Reproduces the reference encode pipeline exactly (device/lib/ckks_common.c:
105-215 + device/lib/fft.c): conjugate-symmetric slot placement through the
index map (generator-3 orbit merged with bit-reversal, ckks_common.c:32-68),
in-place IFFT over f64 complex butterflies with OTF root indexing
s = conj(W^bitrev(h+j, logn)), then scale-by-(scale/n) and IEEE round to
int64.  Uses numpy float64 so every rounding matches the C reference
bit-for-bit on IEEE-754 hardware.  A copy of
``seal_embedded_tpu/golden/encode.py`` (see ``golden/__init__.py``).
"""

from __future__ import annotations

import math

import numpy as np

from ..config import Parms, bitrev


def calc_index_map(n: int, logn: int) -> np.ndarray:
    """Generator-3 orbit merged with bitrev (ckks_common.c:32-68); uint16."""
    index_map = np.zeros(n, dtype=np.uint16)
    m = 2 * n
    pos = 1
    for i in range(n // 2):
        index1 = (pos - 1) // 2
        index2 = n - index1 - 1
        index_map[i] = bitrev(index1, logn)
        index_map[i + n // 2] = bitrev(index2, logn)
        pos = (pos * 3) & (m - 1)
    return index_map


def _root(k: int, m: int) -> complex:
    """W^k for W = exp(2*pi*i/m), computed exactly as the reference does
    (fft.c:27-45): cos/sin of 2*pi*k/m in f64."""
    k &= m - 1
    angle = 2 * math.pi * float(k) / float(m)
    return complex(math.cos(angle), math.sin(angle))


def ifft_inpl(vec: np.ndarray, n: int, logn: int) -> np.ndarray:
    """In-place IFFT with OTF conjugated roots (fft.c:69-144).

    Does NOT divide by n (folded into the encode scaling step).
    """
    v = vec.astype(np.complex128).copy()
    m = 2 * n
    tt, h = 1, n // 2
    for _ in range(logn):
        for j in range(h):
            s = np.conj(_root(bitrev(h + j, logn), m))
            kstart = 2 * tt * j
            sl = slice(kstart, kstart + tt)
            sr = slice(kstart + tt, kstart + 2 * tt)
            u = v[sl].copy()
            w = v[sr].copy()
            v[sl] = u + w
            v[sr] = (u - w) * s
        tt, h = tt * 2, h // 2
    return v


def fft_inpl(vec: np.ndarray, n: int, logn: int) -> np.ndarray:
    """Forward FFT (decode direction, fft.c:146-213)."""
    v = vec.astype(np.complex128).copy()
    m = 2 * n
    h, tt = 1, n // 2
    for _ in range(logn):
        for j in range(h):
            s = _root(bitrev(h + j, logn), m)
            kstart = 2 * tt * j
            sl = slice(kstart, kstart + tt)
            sr = slice(kstart + tt, kstart + 2 * tt)
            u = v[sl].copy()
            w = v[sr] * s
            v[sl] = u + w
            v[sr] = u - w
        h, tt = h * 2, tt // 2
    return v


def c_round(x: np.ndarray) -> np.ndarray:
    """C99 round(): half away from zero (np.round is half-to-even).

    floor(|x| + 0.5) is exact for |x| < 2**52 since x + 0.5 is then exactly
    representable; beyond that f64 values are integers anyway.
    """
    x = np.asarray(x, dtype=np.float64)
    return np.where(x < 0, -np.floor(-x + 0.5), np.floor(x + 0.5))


def encode_base(parms: Parms, values) -> np.ndarray:
    """values (<= n/2 f32 reals) -> conj_vals_int int64 plaintext
    (ckks_common.c:105-215).

    Placement writes value i at index_map[i] and index_map[i + n/2]
    (conjugate pair; values are real so conj == identity), IFFT, then
    round(real * scale/n) checked against int64 range.
    """
    n, logn = parms.degree, parms.logn
    index_map = calc_index_map(n, logn)
    conj_vals = np.zeros(n, dtype=np.complex128)
    vals = np.asarray(values, dtype=np.float32)
    assert vals.size <= n // 2
    for i in range(vals.size):
        v = complex(float(vals[i]), 0.0)
        conj_vals[index_map[i]] = v
        conj_vals[index_map[i + n // 2]] = v
    conj_vals = ifft_inpl(conj_vals, n, logn)
    n_inv = np.float64(parms.scale) / np.float64(n)
    coeffs = c_round(conj_vals.real * n_inv)
    assert np.all(np.abs(coeffs) <= float(np.float64(0x7FFFFFFFFFFFFFFF))), \
        "encode overflow vs int64"
    return coeffs.astype(np.int64)


def decode(parms: Parms, pte_signed: np.ndarray) -> np.ndarray:
    """Inverse of encode_base for testing (ckks_tests_common.c semantics):
    signed plaintext coeffs -> n/2 real slot values."""
    n, logn = parms.degree, parms.logn
    index_map = calc_index_map(n, logn)
    v = np.asarray(pte_signed, dtype=np.float64).astype(np.complex128)
    v = fft_inpl(v, n, logn)
    v = v / np.float64(parms.scale)
    return v[index_map[: n // 2]].real
