"""Parameter sets for the PyTorch/CUDA CKKS encode/encrypt port.

A copy of ``seal_embedded_tpu/config.py``: that module is pure Python, but
importing it runs ``seal_embedded_tpu/__init__.py``, which imports jax, so
the port carries its own copy (tests/test_torch_fast.py holds the two
equal).  It adds the port's default device (``CUDA``) and a context's
encrypt types (``SYM``, ``ASYM``): every layer of the port imports this
module, so nothing below the API reaches up for them.

Mirrors the capability surface of the reference's parameter layer
(reference: device/lib/parameters.{h,c}, device/lib/modulus.{h,c}) but as a
runtime dataclass instead of a compile-time matrix.

Prime chains and scales are the exact default sets of the reference
(parameters.c:129-174, :191-227).  NTT first-power roots are the exact
constants of the reference (ntt.c:199-292) so that ciphertexts are
interoperable with Microsoft SEAL 3.7.2 tables.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Sequence

import torch

# 27-bit primes, q = 1 mod 8192 (parameters.c:129-142)
PRIMES_27BIT = (134012929, 134111233, 134176769)

# 30-bit primes, q = 1 mod 65536 (parameters.c:149-174)
PRIMES_30BIT = (
    1053818881,
    1054015489,
    1054212097,
    1055260673,
    1056178177,
    1056440321,
    1058209793,
    1060175873,
    1060700161,
    1060765697,
    1061093377,
    1062469633,
    1062535169,
)

# First power of the negacyclic NTT root w (a primitive 2n-th root of unity
# mod q), per (n, q).  Same values as SEAL 3.7.2 so ciphertexts decrypt under
# SEAL.  (reference: ntt.c:199-292)
NTT_ROOTS: dict[tuple[int, int], int] = {
    (1024, 134012929): 142143,
    (2048, 134012929): 85250,
    (4096, 134012929): 7470,
    (4096, 134111233): 3856,
    (4096, 134176769): 24149,
    (4096, 1053818881): 503422,
    (4096, 1054015489): 16768,
    (4096, 1054212097): 7305,
    (8192, 1053818881): 374229,
    (8192, 1054015489): 123363,
    (8192, 1054212097): 79941,
    (8192, 1055260673): 38869,
    (8192, 1056178177): 162146,
    (8192, 1056440321): 81884,
    (16384, 1053818881): 13040,
    (16384, 1054015489): 507,
    (16384, 1054212097): 1595,
    (16384, 1055260673): 68507,
    (16384, 1056178177): 3073,
    (16384, 1056440321): 6854,
    (16384, 1058209793): 44467,
    (16384, 1060175873): 16117,
    (16384, 1060700161): 27607,
    (16384, 1060765697): 222391,
    (16384, 1061093377): 105471,
    (16384, 1062469633): 310222,
    (16384, 1062535169): 2005,
}

SEED_BYTE_COUNT = 64  # SE_PRNG seed size (defines.h:67); matches SEAL

# The port's own: where its constructors and factories put their tensors
# unless told otherwise (the card; tests on the CPU pass device="cpu"),
# and a context's encrypt types.
CUDA = torch.device("cuda")
SYM = "sym"
ASYM = "asym"


@lru_cache(maxsize=None)
def find_ntt_root(n: int, q: int) -> int:
    """Primitive 2n-th root of unity mod q, SEAL-compatible.

    SEAL 3.7.2 (and therefore the reference's hard-coded table,
    ntt.c:199-292) uses the *minimal* primitive 2n-th root — verified
    against every table entry.  The table is kept as a fast path/oracle;
    this computes the same value for any (n, q) pair not in it (e.g. tiny
    degrees for sharding dry runs, or custom prime chains).
    """
    if (n, q) in NTT_ROOTS:
        return NTT_ROOTS[(n, q)]
    m = 2 * n
    assert (q - 1) % m == 0, f"q={q} has no 2n-th root (q != 1 mod {m})"
    # One primitive m-th root: x^((q-1)/m) works iff its order is exactly m
    # (probability 1/2 per random x since m is a power of two).
    w0 = None
    for x in range(2, 10_000):
        w = pow(x, (q - 1) // m, q)
        if pow(w, m // 2, q) != 1:
            w0 = w
            break
    if w0 is None:
        raise ValueError(f"no primitive {m}-th root mod {q}")
    # All primitive m-th roots are w0^j for odd j; take the minimum (SEAL's
    # choice).  Walk multiplicatively: one modmul per candidate.
    step = (w0 * w0) % q
    best, cur = w0, w0
    for _ in range(m // 2 - 1):
        cur = (cur * step) % q
        if cur < best:
            best = cur
    return best


def const_ratio(q: int) -> tuple[int, int]:
    """floor(2**64 / q) as (low32, high32) words.

    The reference stores these per prime (modulus.c:23-56); they are fully
    determined by q, so we compute them.
    """
    r = (1 << 64) // q
    return r & 0xFFFFFFFF, (r >> 32) & 0xFFFFFFFF


def barrett_quotient(operand: int, q: int) -> int:
    """floor(operand * 2**32 / q): the 'quotient' of a MUMO pair
    (uintmodarith.h:278-297)."""
    return (operand << 32) // q


@dataclasses.dataclass(frozen=True)
class Modulus:
    value: int

    @property
    def const_ratio_lo(self) -> int:
        return const_ratio(self.value)[0]

    @property
    def const_ratio_hi(self) -> int:
        return const_ratio(self.value)[1]


@dataclasses.dataclass(frozen=True)
class Parms:
    """Runtime parameters (reference: parameters.h:43-67).

    degree        polynomial ring degree n (power of two, 1024..16384)
    moduli        RNS prime chain (ciphertext modulus q_0..q_{L-1})
    scale         CKKS encoding scale
    """

    degree: int
    moduli: tuple[int, ...]
    scale: float

    def __post_init__(self):
        n = self.degree
        assert 16 <= n <= 16384 and (n & (n - 1)) == 0, "degree must be pow2 <= 16384"
        for q in self.moduli:
            assert q % (2 * n) == 1 or n < 1024, f"prime {q} != 1 mod 2n"

    @property
    def logn(self) -> int:
        return self.degree.bit_length() - 1

    @property
    def nprimes(self) -> int:
        return len(self.moduli)

    @property
    def slot_count(self) -> int:
        return self.degree // 2

    def ntt_root(self, q: int) -> int:
        return find_ntt_root(self.degree, q)


@lru_cache(maxsize=None)
def default_parms(degree: int = 4096, nprimes: int = 3,
                  scale: float | None = None,
                  use_27bit_for_4k: bool = False) -> Parms:
    """Default parameter selection (parameters.c:176-230, seal_embedded.c:90-96)."""
    if degree in (1024, 2048):
        assert nprimes == 1
        chain = PRIMES_27BIT[:1]
        default_scale = 2.0 ** 20 if degree == 1024 else 2.0 ** 25
    elif degree == 4096 and use_27bit_for_4k:
        assert nprimes <= 3
        chain = PRIMES_27BIT[:nprimes]
        default_scale = 2.0 ** 20
    elif degree == 4096:
        assert nprimes <= 3
        chain = PRIMES_30BIT[:nprimes]
        default_scale = 2.0 ** 25
    elif degree == 8192:
        assert nprimes <= 6
        chain = PRIMES_30BIT[:nprimes]
        default_scale = 2.0 ** 25
    elif degree == 16384:
        assert nprimes <= 13
        chain = PRIMES_30BIT[:nprimes]
        default_scale = 2.0 ** 25
    else:
        raise ValueError(f"no default parameters for degree {degree}")
    return Parms(degree=degree, moduli=tuple(chain),
                 scale=float(scale) if scale is not None else default_scale)


def bitrev(x: int, bits: int) -> int:
    """Reverse the lowest `bits` bits of x (fft.h:48-55)."""
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r
