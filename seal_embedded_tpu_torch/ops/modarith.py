"""Exact 32-bit modular arithmetic on torch tensors.

Port of ``seal_embedded_tpu/ops/modarith.py`` (the reference's Barrett
layer, device/lib/modulo.h, uintmodarith.h, uint_arith.h).  torch has no
usable unsigned 32-bit type (its ``uint32`` lacks shifts, adds and
compares), so every u32 value is held in an ``int64`` tensor in
[0, 2^32); each operation that wraps in u32 masks with ``MASK32``.
Products are split into 16-bit halves so no intermediate leaves int64.

Moduli arrive as Python ints, as a ``Mod`` of ints, or as a ``Mod`` of
int64 tensors that broadcast against the data (per-limb constants).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..config import const_ratio

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


class Mod(NamedTuple):
    """Modulus constants: ints, or int64 tensors broadcastable to data."""
    q: Any
    r0: Any   # low word of floor(2^64/q)
    r1: Any   # high word of floor(2^64/q)
    max_multiple: Any  # uniform-sampler rejection bound (sample.c:46)


def as_mod(q) -> Mod:
    """int modulus -> Mod of ints; a Mod passes through."""
    if isinstance(q, Mod):
        return q
    q = int(q)
    r0, r1 = const_ratio(q)
    return Mod(q, r0, r1, MASK32 - (MASK32 % q) - 1)


def modpack(moduli, device=None) -> Mod:
    """Stacked per-limb constants: a Mod of int64 (L,) tensors."""
    ms = [as_mod(q) for q in moduli]
    return Mod(*(torch.tensor([getattr(m, f) for m in ms], dtype=torch.int64,
                              device=device) for f in Mod._fields))


def mullo(a, b):
    """Low 32 bits of a*b for u32 values a, b."""
    return (a * (b & _MASK16) + (((a * (b >> 16)) & _MASK16) << 16)) & MASK32


def mulhi(a, b):
    """High 32 bits of the 64-bit product a*b (mul_uint32_high,
    uint_arith.h:67): floor((a*b_hi + floor(a*b_lo / 2^16)) / 2^16),
    every term below 2^49."""
    return (a * (b >> 16) + ((a * (b & _MASK16)) >> 16)) >> 16


def _q(q):
    return q.q if isinstance(q, Mod) else q


def shift_result(x, q):
    """Constant-time [0,2q) -> [0,q) (modulo.h:21-32)."""
    qv = _q(q)
    return torch.where(x >= qv, x - qv, x)


def barrett32(x, q):
    """x (u32) mod q for q <= 31 bits (modulo.h:43-75)."""
    m = as_mod(q)
    tmp = mulhi(x, m.r1)
    tmp = (x - mullo(tmp, m.q)) & MASK32
    return shift_result(tmp, m.q)


def barrett_wide(x_lo, x_hi, q):
    """64-bit (lo, hi u32 pair) mod q (modulo.h:84-116)."""
    m = as_mod(q)
    right_hw = mulhi(x_lo, m.r0)
    mid_lo = mullo(x_lo, m.r1)
    mid_hi = mulhi(x_lo, m.r1)
    middle_lw = (right_hw + mid_lo) & MASK32
    carry = (middle_lw < right_hw).to(torch.int64)
    middle_hw = (mid_hi + carry) & MASK32

    mid2_lo = mullo(x_hi, m.r0)
    mid2_hi = mulhi(x_hi, m.r0)
    middle2_lw = (middle_lw + mid2_lo) & MASK32
    carry2 = (middle2_lw < middle_lw).to(torch.int64)
    middle2_hw = (mid2_hi + carry2) & MASK32

    tmp = (mullo(x_hi, m.r1) + middle_hw + middle2_hw) & MASK32
    tmp = (x_lo - mullo(tmp, m.q)) & MASK32
    return shift_result(tmp, m.q)


def mul_mod(a, b, q):
    """(a*b) mod q for arbitrary u32 operands (uintmodarith.h:123)."""
    return barrett_wide(mullo(a, b), mulhi(a, b), q)


def add_mod(a, b, q):
    """(a+b) mod q; requires a+b < 2q (uintmodarith.h:26-42)."""
    return shift_result((a + b) & MASK32, q)


def neg_mod(a, q):
    """(-a) mod q; requires a <= q (uintmodarith.h:64-73)."""
    return torch.where(a == 0, torch.zeros_like(a), (_q(q) - a) & MASK32)


def sub_mod(a, b, q):
    """(a-b) mod q; requires a,b <= q."""
    return add_mod(a, neg_mod(b, q), q)


def mul_mod_shoup_lazy(x, y_op, y_quot, q):
    """Lazy Shoup/MUMO multiply: result in [0,2q) (uintmodarith.h:308-331).
    y_op < q with y_quot = floor(y_op * 2^32 / q)."""
    return (mullo(x, y_op) - mullo(mulhi(x, y_quot), _q(q))) & MASK32


def mul_mod_shoup(x, y_op, y_quot, q):
    """Shoup multiply reduced to [0,q)."""
    return shift_result(mul_mod_shoup_lazy(x, y_op, y_quot, q), q)


def shoup_quotient(y, q):
    """floor(y * 2^32 / q) for y < q < 2^31, the Shoup partner of y."""
    return torch.div(y << 32, _q(q), rounding_mode="floor")


def reduce_pte(lo, hi, neg, q):
    """int64 plaintext+error (|x| as (lo, hi) u32 pair, neg = sign mask)
    -> mod q (ckks_common.c:224-237).  Negative values map to
    q - (|x| mod q), keeping the reference's x < 0, |x| % q == 0 -> q
    quirk: the result can equal q."""
    r = barrett_wide(lo, hi, q)
    return torch.where(neg, (_q(q) - r) & MASK32, r)


def reduce_pte_i64(x, q):
    """reduce_pte from an int64 tensor.  |INT64_MIN| stays 2^63 as a bit
    pattern, as the JAX version's uint64 cast gives."""
    ab = torch.abs(x)
    return reduce_pte(ab & MASK32, (ab >> 32) & MASK32, x < 0, q)
