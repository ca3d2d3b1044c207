"""Batched negacyclic NTT on torch tensors: the plain versions of kernels
KN and KA (``ops/kernels/ntt.py``).

Port of ``seal_embedded_tpu/ops/ntt.py`` (the reference's device/lib/
ntt.c): each of the log2(n) rounds is one vectorized pairwise op over a
(..., h, 2, tt) view, with the lazy Harvey accumulation in [0, 4q), Shoup
(MUMO) root products and a final correction to [0, q), bit-identical to
the reference.  Root tables are built on the host exactly as the adapter
does (table[i] = w^bitrev(i, logn) plus the Shoup quotient word).
u32 values are int64 tensors in [0, 2^32).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import barrett_quotient, bitrev, find_ntt_root
from .modarith import mul_mod_shoup_lazy


@lru_cache(maxsize=64)
def ntt_tables(n: int, q: int) -> tuple[np.ndarray, np.ndarray]:
    """(operand, quotient) forward tables, bitrev-indexed (ntt.c:40-52)."""
    logn = n.bit_length() - 1
    w = find_ntt_root(n, q)
    op = np.zeros(n, dtype=np.uint32)
    quot = np.zeros(n, dtype=np.uint32)
    power = 1
    for i in range(n):
        idx = bitrev(i, logn)
        op[idx] = power
        quot[idx] = barrett_quotient(power, q) & 0xFFFFFFFF
        power = (power * w) % q
    return op, quot


def ntt_tables_stacked(n: int, moduli) -> tuple[np.ndarray, np.ndarray]:
    """Forward tables stacked over the limb axis: u32 (L, n) each."""
    ops, quots = zip(*(ntt_tables(n, int(q)) for q in moduli))
    return np.stack(ops), np.stack(quots)


def ntt_limbs(x, op, quot, q):
    """Forward NTT of every row of every limb: the plain version of KN.

    x: int64 (L, B, n) values in [0, 4q) (reduce_pte's output can equal q);
    op, quot: int64 (L, n) tables; q: int64 (L,).  Returns canonical
    [0, q) NTTs in bit-reversed order, (L, B, n).
    """
    L, B, n = x.shape
    logn = n.bit_length() - 1
    qv = q.reshape(L, 1, 1, 1)
    two_q = 2 * qv
    v = x
    h, tt = 1, n // 2
    for _ in range(logn):
        v = v.reshape(L, B, h, 2, tt)
        u = v[..., 0, :]
        w = v[..., 1, :]
        # Root for group j of this round: table[h + j] (ntt.c:89).
        s_op = op[:, h:2 * h].reshape(L, 1, h, 1)
        s_quot = quot[:, h:2 * h].reshape(L, 1, h, 1)
        # Harvey butterfly, values stay in [0, 4q) (ntt.c:93-106).
        u = torch.where(u >= two_q, u - two_q, u)
        t = mul_mod_shoup_lazy(w, s_op, s_quot, qv)
        v = torch.stack([u + t, u + two_q - t], dim=-2)
        h, tt = h * 2, tt // 2
    v = v.reshape(L, B, n)
    qv = q.reshape(L, 1, 1)
    # Final correction [0, 4q) -> [0, q) (ntt.c:171-185).
    v = torch.where(v >= 2 * qv, v - 2 * qv, v)
    return torch.where(v >= qv, v - qv, v)


def sym_epilogue(v, a, s_op, s_quot, q):
    """c0 = -a * ntt(s) + v mod q in Shoup form, exactly the fused epilogue
    of the JAX kernel (kernels/ntt.py:217-223).

    v, a: int64 (L, B, n) in [0, q); s_op, s_quot: (L, n) Shoup pair of
    ntt(s); q: (L,)."""
    L = v.shape[0]
    qv = q.reshape(L, 1, 1)
    t = mul_mod_shoup_lazy(a, s_op[:, None, :], s_quot[:, None, :], qv)
    t = torch.where(t >= qv, t - qv, t)
    t = torch.where(t == 0, t, qv - t)
    v = t + v
    return torch.where(v >= qv, v - qv, v)


def asym_epilogue(nu, other, p_op, p_quot, q):
    """pk * ntt(u) + other mod q in Shoup form, exactly the combine of the
    JAX fused-asym kernel (kernels/ntt.py:328-334).

    nu, other: int64 (L, B, n) in [0, q); p_op, p_quot: (L, n) Shoup pair
    of a public-key component; q: (L,)."""
    L = nu.shape[0]
    qv = q.reshape(L, 1, 1)
    t = mul_mod_shoup_lazy(nu, p_op[:, None, :], p_quot[:, None, :], qv)
    t = torch.where(t >= qv, t - qv, t)
    v = t + other
    return torch.where(v >= qv, v - qv, v)


def ntt_asym_plain(u, e1, pte, op, quot, q, p0_op, p0_quot, p1_op, p1_quot):
    """The plain version of kernel KA: three NTTs and the two pk combines,
    c0 = pk0 * ntt(u) + ntt(pte) and c1 = pk1 * ntt(u) + ntt(e1) mod q.
    Shapes as ntt_limbs and asym_epilogue; returns (c0, c1)."""
    nu = ntt_limbs(u, op, quot, q)
    c1 = asym_epilogue(nu, ntt_limbs(e1, op, quot, q), p1_op, p1_quot, q)
    c0 = asym_epilogue(nu, ntt_limbs(pte, op, quot, q), p0_op, p0_quot, q)
    return c0, c1


def ntt(x, q: int):
    """Forward NTT over the last axis for one modulus: int64 (..., n)."""
    n = x.shape[-1]
    op, quot = ntt_tables(n, int(q))
    dev = x.device
    out = ntt_limbs(x.reshape(1, -1, n),
                    torch.as_tensor(op.astype(np.int64), device=dev)[None],
                    torch.as_tensor(quot.astype(np.int64), device=dev)[None],
                    torch.tensor([int(q)], dtype=torch.int64, device=dev))
    return out.reshape(x.shape)
