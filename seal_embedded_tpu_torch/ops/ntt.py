"""Batched negacyclic NTT on torch tensors: the plain versions of kernels
KN (plain and from pte) and KA (from the signed rows,
``ops/kernels/ntt.py``), and the inverse,
on-the-fly and pointwise transforms the JAX package keeps outside its
kernels.

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
from ..io.serialize import intt_root_table
from .modarith import (MASK32, Mod, add_mod, mul_mod, mul_mod_shoup_lazy,
                       reduce_pte_i64, shift_result, sub_mod)
from .sampling import ternary_to_modq_any


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


def ntt_sym_from_pte_plain(pte, a, s_op, s_quot, op, quot, q, r0, r1):
    """The plain version of KN's from-pte entry: c0 = -a * ntt(s) +
    ntt(reduce_pte(pte)) mod q for every limb.

    pte: int64 (B, n) plaintext + error; a: int64 (L, B, n) in [0, q);
    s_op, s_quot, op, quot: int64 (L, n); q, r0, r1: int64 (L,), the
    moduli and the words of floor(2^64 / q).  Returns (L, B, n)."""
    mod = Mod(q[:, None, None], r0[:, None, None], r1[:, None, None], None)
    x = reduce_pte_i64(pte[None], mod)
    return sym_epilogue(ntt_limbs(x, op, quot, q), a, s_op, s_quot, q)


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
    """Three NTTs and the two pk combines, c0 = pk0 * ntt(u) + ntt(pte)
    and c1 = pk1 * ntt(u) + ntt(e1) mod q, of rows already in [0, 4q).
    Shapes as ntt_limbs and asym_epilogue; returns (c0, c1)."""
    nu = ntt_limbs(u, op, quot, q)
    c1 = asym_epilogue(nu, ntt_limbs(e1, op, quot, q), p1_op, p1_quot, q)
    c0 = asym_epilogue(nu, ntt_limbs(pte, op, quot, q), p0_op, p0_quot, q)
    return c0, c1


def ntt_asym_from_signed_plain(u, e1, pte, op, quot, q, r0, r1, p0_op,
                               p0_quot, p1_op, p1_quot):
    """The plain version of kernel KA: ntt_asym_plain of u and e1 mapped
    x < 0 -> x + q and of reduce_pte(pte), per limb.

    u, e1, pte: int64 (B, n), u in {-1, 0, 1}, e1 in [-63, 63]; op, quot,
    p0_op, p0_quot, p1_op, p1_quot: int64 (L, n); q, r0, r1: int64 (L,).
    Returns (c0, c1) int64 (L, B, n)."""
    mod = Mod(q[:, None, None], r0[:, None, None], r1[:, None, None], None)
    shape = (q.shape[0],) + tuple(u.shape)
    return ntt_asym_plain(ternary_to_modq_any(u[None], mod).expand(shape),
                          ternary_to_modq_any(e1[None], mod).expand(shape),
                          reduce_pte_i64(pte[None], mod), op, quot, q, p0_op,
                          p0_quot, p1_op, p1_quot)


@lru_cache(maxsize=64)
def ntt_tables_on(n: int, q: int, device: torch.device):
    """ntt_tables(n, q) as int64 (1, n) tensors on `device`, with q as an
    int64 (1,) tensor: uploaded once per (n, q, device), not per call."""
    op, quot = ntt_tables(n, q)
    return (torch.as_tensor(op.astype(np.int64), device=device)[None],
            torch.as_tensor(quot.astype(np.int64), device=device)[None],
            torch.tensor([q], dtype=torch.int64, device=device))


def ntt(x, q: int):
    """Forward NTT over the last axis for one modulus: int64 (..., n)."""
    n = x.shape[-1]
    out = ntt_limbs(x.reshape(1, -1, n), *ntt_tables_on(n, int(q), x.device))
    return out.reshape(x.shape)


# ---------------------------------------------------------------- inverse
# The inverse transforms, the OTF forward NTT and the pointwise product are
# jnp code outside any Pallas kernel in the JAX package, so they stay plain
# torch here, on whatever device their input lies.

@lru_cache(maxsize=64)
def intt_tables(n: int, q: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse-root tables, same indexing as forward (intt.c:511-605
    semantics)."""
    logn = n.bit_length() - 1
    winv = pow(find_ntt_root(n, q), q - 2, q)
    op = np.zeros(n, dtype=np.uint32)
    quot = np.zeros(n, dtype=np.uint32)
    power = 1
    for i in range(n):
        idx = bitrev(i, logn)
        op[idx] = power
        quot[idx] = barrett_quotient(power, q) & MASK32
        power = (power * winv) % q
    return op, quot


def _u32(table, like):
    return torch.as_tensor(np.asarray(table, dtype=np.uint32).astype(np.int64),
                           device=like.device)


def intt(x, q: int):
    """Inverse of ntt(): canonical [0, q) coefficients (intt.c semantics,
    including the 1/n fold).  x: int64 (..., n) in [0, q)."""
    op, quot = intt_tables(x.shape[-1], q)
    return intt_with_tables(x, _u32(op, x), _u32(quot, x), q)


def intt_with_tables(x, op, quot, q: int):
    """intt() with its tables given: op, quot int64 (n,), intt_tables(n, q)
    on x's device."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    batch = x.shape[:-1]
    v = x
    h, tt = n // 2, 1
    for _ in range(logn):
        v = v.reshape(batch + (h, 2, tt))
        u, w = v[..., 0, :], v[..., 1, :]
        s_op = op[h:2 * h].reshape(h, 1)
        s_quot = quot[h:2 * h].reshape(h, 1)
        add = shift_result(u + w, q)
        diff = shift_result(u + q - w, q)
        t = shift_result(mul_mod_shoup_lazy(diff, s_op, s_quot, q), q)
        v = torch.stack([add, t], dim=-2)
        h, tt = h // 2, tt * 2
    v = v.reshape(batch + (n,))
    ninv = pow(n, q - 2, q)
    return shift_result(mul_mod_shoup_lazy(
        v, ninv, barrett_quotient(ninv, q) & MASK32, q), q)


@lru_cache(maxsize=64)
def intt_lazy_consts(n: int, q: int) -> tuple[tuple, tuple]:
    """((inv_n, quot), (last_inv_sn, quot)) MUMO scalars for the lazy
    INTT's merged final round (intt.c:226-268): inv_n = n^-1 mod q,
    last_inv_sn = s * inv_n where s is the final round's root."""
    logn = n.bit_length() - 1
    tbl = intt_root_table(n, logn, q, find_ntt_root(n, q))
    inv_n = pow(n, q - 2, q)
    last_inv_sn = int(tbl[n - 1]) * inv_n % q
    return ((inv_n, barrett_quotient(inv_n, q) & MASK32),
            (last_inv_sn, barrett_quotient(last_inv_sn, q) & MASK32))


def intt_lazy_with_tables(x, op, quot, q: int):
    """Lazy ("fast") INTT with MUMO tables in the reference's INTT file
    order (intt_lazy_inpl, intt.c:72-129, and the [0, q) correction at
    intt.c:490-496): values stay in [0, 2q) across rounds, the last round
    is merged with the inv_n / last_inv_sn products, and one correction
    lands canonical [0, q).

    x: int64 (..., n) in [0, q); op, quot: int64 (n,), e.g. the columns of
    intt_fast_root_table; round h reads rows [n - 2h + 1, n - h + 1).
    Value-identical to intt().
    """
    n = x.shape[-1]
    logn = n.bit_length() - 1
    batch = x.shape[:-1]
    two_q = 2 * q
    v = x
    h, tt = n // 2, 1
    for _ in range(logn - 1):
        v = v.reshape(batch + (h, 2, tt))
        u, w = v[..., 0, :], v[..., 1, :]
        s_op = op[n - 2 * h + 1:n - h + 1].reshape(h, 1)
        s_quot = quot[n - 2 * h + 1:n - h + 1].reshape(h, 1)
        val1 = (u + w) & MASK32
        val1 = torch.where(val1 >= two_q, val1 - two_q, val1)
        val2 = (u + two_q - w) & MASK32
        t = mul_mod_shoup_lazy(val2, s_op, s_quot, q)
        v = torch.stack([val1, t], dim=-2)
        h, tt = h // 2, tt * 2
    v = v.reshape(batch + (n,))
    (inv_n, inv_n_q), (lsn, lsn_q) = intt_lazy_consts(n, q)
    u, w = v[..., :n // 2], v[..., n // 2:]
    val1 = (u + w) & MASK32
    val1 = torch.where(val1 >= two_q, val1 - two_q, val1)
    val2 = (u + two_q - w) & MASK32
    v = torch.cat([mul_mod_shoup_lazy(val1, inv_n, inv_n_q, q),
                   mul_mod_shoup_lazy(val2, lsn, lsn_q, q)], dim=-1)
    return shift_result(v, q)


@lru_cache(maxsize=64)
def _gen_powers(n: int, q: int) -> tuple:
    """The logn generator squarings w^(2^b) mod q plus the bitrev gather:
    the only precomputed state of the OTF mode."""
    logn = n.bit_length() - 1
    w = find_ntt_root(n, q)
    sq = tuple(pow(w, 1 << b, q) for b in range(logn))
    brv = np.array([bitrev(i, logn) for i in range(n)], dtype=np.int64)
    return sq, brv


def ntt_roots_ingraph(n: int, q: int, device=None):
    """The bitrev-indexed root vector built from the logn generator
    squarings by log-depth doubling (SE_NTT_TYPE 0/1: ntt.c:144-149),
    int64 (n,) on `device`."""
    sq, brv = _gen_powers(n, q)
    pows = torch.ones((1,), dtype=torch.int64, device=device)
    for wb in sq:  # pows_{b+1} = [pows_b, pows_b * w^(2^b)]
        pows = torch.cat([pows, mul_mod(pows, wb, q)])
    return pows[torch.as_tensor(brv, device=device)]


def ntt_otf(x, q: int):
    """Forward negacyclic NTT with on-the-fly roots (SE_NTT_TYPE 0
    analog): roots from ntt_roots_ingraph and the reference's non-lazy
    butterflies (Barrett mul_mod, canonical add/sub per stage,
    ntt.c:124-165).  Value-identical to ntt().  x: int64 (..., n) in
    [0, q)."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    op = ntt_roots_ingraph(n, q, x.device)
    batch = x.shape[:-1]
    v = x
    h, tt = 1, n // 2
    for _ in range(logn):
        v = v.reshape(batch + (h, 2, tt))
        u, w = v[..., 0, :], v[..., 1, :]
        t = mul_mod(w, op[h:2 * h].reshape(h, 1), q)
        v = torch.stack([add_mod(u, t, q), sub_mod(u, t, q)], dim=-2)
        h, tt = h * 2, tt // 2
    return v.reshape(batch + (n,))


def pointwise_mul_mod(a, b, q):
    """NTT-domain multiply = coefficient-wise mul mod q (ntt.h:66-85)."""
    return mul_mod(a, b, q)
