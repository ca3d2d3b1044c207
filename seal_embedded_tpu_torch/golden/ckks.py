"""CKKS symmetric/asymmetric encrypt — bit-exactness oracle.

Reproduces the reference's full encode+encrypt pipelines with exact PRNG
call ordering (reference: device/lib/seal_embedded.c:98-215,
ckks_sym.c:181-301, ckks_asym.c:159-286, ckks_common.c:224-274).

Ciphertexts are produced in NTT form, one RNS component (prime) at a time,
exactly like the reference streams them.  A copy of
``seal_embedded_tpu/golden/ckks.py`` (see ``golden/__init__.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import Parms
from .encode import calc_index_map, decode, encode_base
from .ntt import intt_inpl, ntt_inpl
from .prng import Prng
from .sampling import (
    expand_poly_ternary,
    sample_add_poly_cbd_16,
    sample_poly_cbd_16,
    sample_poly_uniform,
    sample_small_poly_ternary_96,
)


def reduce_pte(conj_vals_int, q: int) -> list[int]:
    """int64 plaintext+error -> mod-q, constant-time sign fold semantics
    (ckks_common.c:224-257).  Note the reference maps a negative exact
    multiple of q to q (not 0); we reproduce that."""
    out = []
    for x in conj_vals_int:
        x = int(x)
        r = abs(x) % q
        out.append((q - r) if x < 0 else r)
    return out


def reduce_e_small(e, q: int) -> list[int]:
    """Signed int8 error -> mod-q (ckks_common.c:259-274)."""
    return [(q + int(v)) if int(v) < 0 else int(v) for v in e]


@dataclasses.dataclass
class SymCiphertext:
    """Per-prime ciphertext components, NTT form: lists of (c0, c1)."""
    parms: Parms
    components: list[tuple[list[int], list[int]]]
    conj_vals_int: np.ndarray  # encoded plaintext (before error add)
    pte: np.ndarray            # plaintext + error (int64)


def sym_encrypt(parms: Parms, values, sk_packed: bytes,
                share_seed: bytes = b"", seed: bytes = b"") -> SymCiphertext:
    """Full symmetric encode+encrypt (seal_embedded.c:98-215 sym path).

    sk_packed: compressed 2-bit ternary secret key (n/4 bytes).
    Returns per-prime (c0, c1) with c1 = a and c0 = -a*s + m + e, NTT form.
    """
    n, logn = parms.degree, parms.logn

    conj_vals_int = encode_base(parms, values)

    shareable_prng = Prng(share_seed)
    prng = Prng(seed)
    pte = np.array(
        sample_add_poly_cbd_16(conj_vals_int.tolist(), prng), dtype=np.int64
    )

    components = []
    for q in parms.moduli:
        w = parms.ntt_root(q)
        # c1 = a <- U  (uniform from the shareable PRNG)
        c1 = sample_poly_uniform(n, q, shareable_prng)
        # c0 = -a * ntt(s) + ntt(reduce(m + e))
        s = expand_poly_ternary(sk_packed, n, q)
        ntt_s = ntt_inpl(s, n, logn, q, w)
        c0 = [(q - (x * y) % q) % q for x, y in zip(ntt_s, c1)]
        ntt_pte = ntt_inpl(reduce_pte(pte, q), n, logn, q, w)
        c0 = [(x + y) % q for x, y in zip(c0, ntt_pte)]
        components.append((c0, c1))
    return SymCiphertext(parms, components, conj_vals_int, pte)


@dataclasses.dataclass
class PublicKey:
    """Per-prime (pk0, pk1), NTT form."""
    parms: Parms
    components: list[tuple[list[int], list[int]]]


def gen_pk(parms: Parms, sk_packed: bytes, seed: bytes = b"",
           ep: list[int] | None = None) -> PublicKey:
    """Device-side public key generation = symmetric encryption of zero
    (ckks_asym.c:159-171): pk0 = -a*ntt(s) + ntt(ep), pk1 = a."""
    n, logn = parms.degree, parms.logn
    shareable_prng = Prng(seed)
    if ep is None:
        import hashlib
        ep_prng = Prng(hashlib.shake_256(seed + b"ep").digest(64))
        ep = sample_poly_cbd_16(n, ep_prng)
    components = []
    for q in parms.moduli:
        w = parms.ntt_root(q)
        pk1 = sample_poly_uniform(n, q, shareable_prng)
        s = expand_poly_ternary(sk_packed, n, q)
        ntt_s = ntt_inpl(s, n, logn, q, w)
        pk0 = [(q - (x * y) % q) % q for x, y in zip(ntt_s, pk1)]
        ntt_ep = ntt_inpl(reduce_e_small(ep, q), n, logn, q, w)
        pk0 = [(x + y) % q for x, y in zip(pk0, ntt_ep)]
        components.append((pk0, pk1))
    return PublicKey(parms, components)


def asym_encrypt(parms: Parms, values, pk: PublicKey,
                 seed: bytes = b"") -> SymCiphertext:
    """Full asymmetric encode+encrypt (seal_embedded.c asym path,
    ckks_asym.c:173-286): c1 = pk1*ntt(u) + ntt(e1),
    c0 = pk0*ntt(u) + ntt(m + e0)."""
    n, logn = parms.degree, parms.logn

    conj_vals_int = encode_base(parms, values)

    prng = Prng(seed)
    u_packed = sample_small_poly_ternary_96(n, prng)
    pte = np.array(
        sample_add_poly_cbd_16(conj_vals_int.tolist(), prng), dtype=np.int64
    )
    e1 = sample_poly_cbd_16(n, prng)

    components = []
    for idx, q in enumerate(parms.moduli):
        w = parms.ntt_root(q)
        pk0, pk1 = pk.components[idx]
        u = expand_poly_ternary(u_packed, n, q)
        ntt_u = ntt_inpl(u, n, logn, q, w)
        c1 = [(x * y) % q for x, y in zip(pk1, ntt_u)]
        c0 = [(x * y) % q for x, y in zip(pk0, ntt_u)]
        ntt_e1 = ntt_inpl(reduce_e_small(e1, q), n, logn, q, w)
        c1 = [(x + y) % q for x, y in zip(c1, ntt_e1)]
        ntt_pte = ntt_inpl(reduce_pte(pte, q), n, logn, q, w)
        c0 = [(x + y) % q for x, y in zip(c0, ntt_pte)]
        components.append((c0, c1))
    return SymCiphertext(parms, components, conj_vals_int, pte)


def decrypt_component(parms: Parms, prime_idx: int,
                      c0: list[int], c1: list[int],
                      sk_packed: bytes) -> np.ndarray:
    """Test oracle: recover centered plaintext+error coeffs from one RNS
    component (ckks_tests_common.c:173-231 semantics)."""
    n, logn = parms.degree, parms.logn
    q = parms.moduli[prime_idx]
    w = parms.ntt_root(q)
    s = expand_poly_ternary(sk_packed, n, q)
    ntt_s = ntt_inpl(s, n, logn, q, w)
    pte_ntt = [(a + b * c) % q for a, b, c in zip(c0, c1, ntt_s)]
    pte = intt_inpl(pte_ntt, n, logn, q, w)
    centered = np.array([x - q if x > q // 2 else x for x in pte], dtype=np.int64)
    return centered


def decrypt_decode(parms: Parms, ct: SymCiphertext, sk_packed: bytes,
                   prime_idx: int = 0) -> np.ndarray:
    """Decrypt one component and CKKS-decode to n/2 real slot values."""
    centered = decrypt_component(
        parms, prime_idx, *ct.components[prime_idx], sk_packed)
    return decode(parms, centered)


def decrypt_crt(parms: Parms, components, sk_packed: bytes) -> list[int]:
    """Decrypt EVERY RNS component and CRT-compose to the centered
    plaintext+error mod Q = prod(q_i) — the reference adapter's oracle
    shape (it assembles the multi-prime SEAL ciphertext from the per-prime
    dumps and decrypts under the full chain, adapter/fileops.cpp:492-538 +
    adapter.cpp:130-140).  A corrupted component of ANY prime perturbs the
    composed value by ~Q and is caught by the decode-tolerance check.

    components: [(c0_i, c1_i)] per prime, coefficient lists.
    Returns centered big-int coefficients (python ints, |x| <= Q/2).
    """
    L = parms.nprimes
    assert len(components) == L, (len(components), L)
    moduli = [int(q) for q in parms.moduli[:L]]
    Q = 1
    for q in moduli:
        Q *= q
    # Per-prime uncentered residues.
    residues = []
    for i, (c0, c1) in enumerate(components):
        centered = decrypt_component(parms, i, list(c0), list(c1), sk_packed)
        q = moduli[i]
        residues.append([int(x) % q for x in centered])
    # Garner-free CRT: x = sum r_i * (Q/q_i) * ((Q/q_i)^-1 mod q_i) mod Q.
    basis = []
    for q in moduli:
        m = Q // q
        basis.append(m * pow(m % q, -1, q))
    n = parms.degree
    out = []
    for j in range(n):
        x = sum(residues[i][j] * basis[i] for i in range(L)) % Q
        out.append(x - Q if x > Q // 2 else x)
    return out
