"""Negacyclic NTT/INTT — bit-exactness oracle.

Same transform as the reference (device/lib/ntt.c, intt.c): forward NTT in
scrambled (bit-reversed) output order via Harvey-style butterflies with roots
w^bitrev(h+j); inverse NTT consuming inverse roots in sequential order with
the final 1/n fold.  Plain Python ints; exact mod at every step (the
reference's lazy [0,4q) accumulation converges to the same values).  A
copy of ``seal_embedded_tpu/golden/ntt.py`` (see ``golden/__init__.py``).
"""

from __future__ import annotations

from ..config import Parms, bitrev


def ntt_inpl(vec: list[int], n: int, logn: int, q: int, w: int) -> list[int]:
    """Forward negacyclic NTT, scrambled output order (ntt.c:124-165)."""
    v = list(vec)
    h, tt = 1, n // 2
    for _ in range(logn):
        for j in range(h):
            s = pow(w, bitrev(h + j, logn), q)
            kstart = 2 * tt * j
            for k in range(kstart, kstart + tt):
                u, x = v[k], (v[k + tt] * s) % q
                v[k] = (u + x) % q
                v[k + tt] = (u - x) % q
        h, tt = h * 2, tt // 2
    return v


def intt_inpl(vec: list[int], n: int, logn: int, q: int, w: int) -> list[int]:
    """Inverse of ntt_inpl (reference intt.c semantics, incl. 1/n fold)."""
    v = list(vec)
    winv = pow(w, q - 2, q)
    h, tt = n // 2, 1
    for _ in range(logn):
        for j in range(h):
            # Mirrors the forward round with inverse root of the same group.
            s = pow(winv, bitrev(h + j, logn), q)
            kstart = 2 * tt * j
            for k in range(kstart, kstart + tt):
                u, x = v[k], v[k + tt]
                v[k] = ((u + x)) % q
                v[k + tt] = ((u - x) * s) % q
        h, tt = h // 2, tt * 2
    ninv = pow(n, q - 2, q)
    return [(x * ninv) % q for x in v]


def poly_mult_sb_negacyclic(a: list[int], b: list[int], q: int) -> list[int]:
    """Schoolbook negacyclic ring multiplication (test ground truth,
    polymodmult.c:37-101)."""
    n = len(a)
    res = [0] * (2 * n)
    for i in range(n):
        ai = a[i]
        if ai == 0:
            continue
        for j in range(n):
            res[i + j] = (res[i + j] + ai * b[j]) % q
    return [(res[i] - res[i + n]) % q for i in range(n)]
