"""Precompute tables in the reference's file order.

A partial copy of ``seal_embedded_tpu/io/serialize.py`` (:139-161): the
inverse-root tables that the lazy INTT reads.  The rest of the JAX
package's ``io/`` (wire formats, file writers and readers) is not ported
yet.
"""

from __future__ import annotations

import numpy as np

from ..config import barrett_quotient, bitrev


def intt_root_table(n: int, logn: int, q: int, w: int) -> np.ndarray:
    """Inverse-root table in the reference's INTT order (intt.c:30-56):
    table[bitrev(i-1, logn) + 1] = inv_w^i, table[0] = 1."""
    inv_w = pow(w, q - 2, q)
    tbl = np.zeros(n, dtype=np.uint64)
    tbl[0] = 1
    power = inv_w
    for i in range(1, n):
        tbl[bitrev(i - 1, logn) + 1] = power
        power = (power * inv_w) % q
    return tbl.astype(np.uint32)


def intt_fast_root_table(n: int, logn: int, q: int, w: int) -> np.ndarray:
    """INTT MUMO (operand, quotient) pairs, interleaved, u32 (2n,)
    (adapter generate.cpp inverse path)."""
    ops = intt_root_table(n, logn, q, w)
    out = np.zeros(2 * n, dtype=np.uint32)
    for i in range(n):
        op = int(ops[i])
        out[2 * i] = op
        out[2 * i + 1] = barrett_quotient(op, q) & 0xFFFFFFFF
    return out
