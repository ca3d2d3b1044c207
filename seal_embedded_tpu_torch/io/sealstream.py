"""Microsoft SEAL 3.7.2 native stream serialization for sk/pk.

The reference adapter saves/loads keys as SEAL streams
(`adapter/fileops.cpp:379-436`: `sk.save(file,
compr_mode_type::none)` / `pk.save(...)`) under the *key context* — the
device prime chain plus a SEAL-chosen special prime
(`adapter/utils.cpp:105-141`).  This module reproduces that wire format
field-for-field from the SEAL 3.7.2 sources so a stock SEAL build can
load keys produced by this framework:

* `Serialization::SEALHeader` (seal/serialization.h): magic 0xA15E,
  header size 0x10, version 3.7, compr_mode, reserved, total size —
  written by every `save()` call, including nested `DynArray::save`.
* `SecretKey::save` = the underlying `Plaintext` (seal/plaintext.h
  save_members): parms_id (32B), coeff_count u64, scale f64, then the
  nested DynArray stream (u64 count + u64 values) — sk in NTT form over
  EVERY key-context prime (special prime included).
* `PublicKey::save` = the underlying `Ciphertext` (seal/ciphertext.cpp
  save_members): parms_id, is_ntt_form byte, size u64,
  poly_modulus_degree u64, coeff_modulus_size u64, scale f64,
  correction_factor u64, then the nested DynArray stream.
* parms_id = blake2xb-256 of the EncryptionParameters uint64 image
  (seal/encryptionparams.cpp compute_parms_id + seal/util/hash.h):
  [scheme, poly_modulus_degree, q_0..q_{L-1}, plain_modulus(=0 for CKKS)].
* The special prime follows `CoeffModulus::Create` /
  `util::get_primes` (seal/util/numth.cpp): the largest prime
  = 1 mod 2n descending from 2^bits - 2n + 1 in steps of 2n.

Offline caveat (documented per-field test strategy): SEAL itself cannot
be built without network access (the adapter fetches it from GitHub with
FetchContent), so byte-fidelity is established by implementing each
field from the 3.7.2 source layout cited above and verified by
structural round-trip tests (tests/test_sealstream.py) rather than by
diffing against a live SEAL binary.

A copy of ``seal_embedded_tpu/io/sealstream.py``;
``tests/test_torch_io.py`` holds its streams and parms_id byte-equal to
the original's.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass

import numpy as np

SEAL_MAGIC = 0xA15E
SEAL_HEADER_SIZE = 0x10
SEAL_VERSION = (3, 7)
COMPR_NONE = 0

SCHEME_CKKS = 2  # seal::scheme_type::ckks


# ---------------------------------------------------------------------------
# blake2xb (BLAKE2X over blake2b), as used by seal/util/blake2x*.c


_B2B_IV = (0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
           0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
           0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179)

_B2B_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
)

_M64 = (1 << 64) - 1


def _b2b_compress(h, block, t, final):
    m = struct.unpack("<16Q", block)
    v = list(h) + list(_B2B_IV)
    v[12] ^= t & _M64
    if final:
        v[14] ^= _M64

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _M64
        v[d] = ((v[d] ^ v[a]) >> 32 | (v[d] ^ v[a]) << 32) & _M64
        v[c] = (v[c] + v[d]) & _M64
        v[b] = ((v[b] ^ v[c]) >> 24 | (v[b] ^ v[c]) << 40) & _M64
        v[a] = (v[a] + v[b] + y) & _M64
        v[d] = ((v[d] ^ v[a]) >> 16 | (v[d] ^ v[a]) << 48) & _M64
        v[c] = (v[c] + v[d]) & _M64
        v[b] = ((v[b] ^ v[c]) >> 63 | (v[b] ^ v[c]) << 1) & _M64

    for r in range(12):
        s = _B2B_SIGMA[r]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def _b2xb_output_node(root: bytes, i: int, take: int, out_len: int) -> bytes:
    """BLAKE2X output node B2(i, take, root): blake2b with the parameter
    block {digest_length=take, fanout=0, depth=0, leaf_length=64,
    node_offset=i, xof_length=out_len, node_depth=0, inner_length=64}
    (BLAKE2X spec §2; hashlib cannot express depth=0, so the single
    compression runs on a hand-built parameter block)."""
    param = struct.pack("<BBBBIIIBB14x", take, 0, 0, 0, 64, i, out_len, 0, 64)
    param += bytes(32)  # salt + personal, zero
    h = [_B2B_IV[j] ^ struct.unpack("<8Q", param)[j] for j in range(8)]
    block = root.ljust(128, b"\x00")
    h = _b2b_compress(h, block, len(root), True)
    return struct.pack("<8Q", *h)[:take]


def _blake2b_ref(data: bytes, digest_size: int = 64) -> bytes:
    """Plain sequential blake2b on the same compression core — exists so
    tests can anchor _b2b_compress against hashlib bit-for-bit."""
    param = struct.pack("<BBBBIIIBB14x", digest_size, 0, 1, 1, 0, 0, 0, 0, 0)
    param += bytes(32)
    h = [_B2B_IV[j] ^ struct.unpack("<8Q", param)[j] for j in range(8)]
    msg = data if data else b""
    blocks = [msg[i:i + 128] for i in range(0, max(len(msg), 1), 128)]
    t = 0
    for bi, blk in enumerate(blocks):
        t += len(blk)
        final = bi == len(blocks) - 1
        h = _b2b_compress(h, blk.ljust(128, b"\x00"), t, final)
    return struct.pack("<8Q", *h)[:digest_size]


def blake2xb(data: bytes, out_len: int) -> bytes:
    """BLAKE2Xb XOF, unkeyed — matches SEAL's vendored blake2xb for the
    parms_id / PRNG hashing (seal/util/hash.h:31-40).

    Root hash via hashlib (xof_length rides the high half of
    node_offset = bytes 12..15 of the parameter block); output nodes via
    the explicit parameter block above."""
    assert 0 < out_len < (1 << 32)
    root = hashlib.blake2b(data, digest_size=64,
                           node_offset=out_len << 32).digest()
    out = b""
    i = 0
    remaining = out_len
    while remaining > 0:
        take = min(64, remaining)
        out += _b2xb_output_node(root, i, take, out_len)
        remaining -= take
        i += 1
    return out


def parms_id(degree: int, key_moduli) -> bytes:
    """SEAL parms_id (32 bytes = 4 LE uint64): blake2xb-256 over the
    parameter uint64 image (seal/encryptionparams.cpp compute_parms_id:
    scheme, poly_modulus_degree, coeff_modulus values, plain_modulus
    value — 0 under CKKS)."""
    words = [SCHEME_CKKS, degree] + [int(q) for q in key_moduli] + [0]
    return blake2xb(b"".join(struct.pack("<Q", w) for w in words), 32)


# ---------------------------------------------------------------------------
# Special (key) prime selection — CoeffModulus::Create semantics


def _is_prime(v: int) -> bool:
    """Deterministic Miller-Rabin for 64-bit inputs (seal uses 40 random
    rounds, seal/util/numth.cpp is_prime; these witness sets are exact
    for v < 3.3e24)."""
    if v < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if v % p == 0:
            return v == p
    d, r = v - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, v)
        if x in (1, v - 1):
            continue
        for _ in range(r - 1):
            x = x * x % v
            if x == v - 1:
                break
        else:
            return False
    return True


def seal_create_prime(degree: int, bits: int, count: int = 1) -> list[int]:
    """`CoeffModulus::Create(degree, {bits})` (seal/modulus.cpp ->
    util::get_primes, seal/util/numth.cpp:446-474): largest `count`
    primes == 1 mod 2n, descending from 2^bits - 2n + 1 in 2n steps."""
    factor = 2 * degree
    value = (1 << bits) - factor + 1
    out = []
    while len(out) < count and value > factor:
        if _is_prime(value):
            out.append(value)
        value -= factor
    assert len(out) == count, (degree, bits)
    return out


SPECIAL_PRIME_BITS = {1024: None, 2048: 27, 4096: 19, 8192: 38, 16384: 48}


def key_context_moduli(parms) -> list[int]:
    """Device chain + the adapter's special prime for this degree
    (adapter/utils.cpp:105-141; n=1024 has a single-prime context)."""
    moduli = [int(q) for q in parms.moduli]
    bits = SPECIAL_PRIME_BITS.get(parms.degree)
    if bits is not None:
        moduli = moduli + seal_create_prime(parms.degree, bits)
    return moduli


# ---------------------------------------------------------------------------
# SEALHeader


@dataclass
class SEALHeader:
    compr_mode: int = COMPR_NONE
    size: int = 0

    def pack(self) -> bytes:
        return struct.pack("<HBBBBHQ", SEAL_MAGIC, SEAL_HEADER_SIZE,
                           SEAL_VERSION[0], SEAL_VERSION[1],
                           self.compr_mode, 0, self.size)

    @classmethod
    def unpack(cls, b: bytes) -> "SEALHeader":
        magic, hsize, vmaj, vmin, compr, _resv, size = struct.unpack(
            "<HBBBBHQ", b[:16])
        assert magic == SEAL_MAGIC, f"bad SEAL magic {magic:#x}"
        assert hsize == SEAL_HEADER_SIZE
        assert (vmaj, vmin) == SEAL_VERSION, (vmaj, vmin)
        return cls(compr_mode=compr, size=size)


def _wrap(members: bytes, compr_mode: int = COMPR_NONE) -> bytes:
    """Serialization::Save: SEALHeader (size incl. header) + members."""
    assert compr_mode == COMPR_NONE, "zstd/zlib streams not supported"
    return SEALHeader(compr_mode, SEAL_HEADER_SIZE + len(members)).pack() \
        + members


def _unwrap(b: bytes) -> tuple[bytes, int]:
    hdr = SEALHeader.unpack(b)
    assert hdr.compr_mode == COMPR_NONE, "compressed stream unsupported"
    assert hdr.size <= len(b), (hdr.size, len(b))
    return b[16:hdr.size], hdr.size


def _dynarray_save(values: np.ndarray) -> bytes:
    """DynArray<u64>::save_members: u64 count + LE u64 values, wrapped in
    its own SEALHeader (nested Serialization::Save)."""
    v = np.ascontiguousarray(values, dtype="<u8")
    return _wrap(struct.pack("<Q", v.size) + v.tobytes())


def _dynarray_load(b: bytes) -> tuple[np.ndarray, int]:
    members, consumed = _unwrap(b)
    (count,) = struct.unpack("<Q", members[:8])
    vals = np.frombuffer(members[8:8 + 8 * count], dtype="<u8").copy()
    assert vals.size == count
    return vals, consumed


# ---------------------------------------------------------------------------
# SecretKey (= Plaintext) and PublicKey (= Ciphertext) streams


def save_secret_key(parms, sk_ntt_per_prime: np.ndarray) -> bytes:
    """SecretKey::save stream (no compression).

    sk_ntt_per_prime: u64 (L_key, n) — ntt(s) mod q for EVERY key-context
    prime (use key_context_moduli(parms); SEAL stores sk in NTT form,
    adapter/convert.cpp sk_to_ntt_form).  Layout per
    seal/plaintext.h save_members: parms_id, coeff_count u64, scale f64,
    nested DynArray data."""
    kmods = key_context_moduli(parms)
    L, n = sk_ntt_per_prime.shape
    assert L == len(kmods), (L, len(kmods))
    pid = parms_id(parms.degree, kmods)
    members = pid
    members += struct.pack("<Q", L * n)       # coeff_count
    members += struct.pack("<d", 1.0)         # scale (unused for sk)
    members += _dynarray_save(sk_ntt_per_prime.reshape(-1))
    return _wrap(members)


def load_secret_key(parms, b: bytes) -> np.ndarray:
    members, _ = _unwrap(b)
    kmods = key_context_moduli(parms)
    pid = members[:32]
    assert pid == parms_id(parms.degree, kmods), "parms_id mismatch"
    (coeff_count,) = struct.unpack("<Q", members[32:40])
    (_scale,) = struct.unpack("<d", members[40:48])
    data, _ = _dynarray_load(members[48:])
    L = len(kmods)
    n = coeff_count // L
    assert data.size == coeff_count
    return data.reshape(L, n)


def _ciphertext_members(pid: bytes, components, scale: float,
                        is_ntt: bool) -> bytes:
    """Ciphertext save_members (seal/ciphertext.cpp): parms_id,
    is_ntt_form byte, size u64, poly_modulus_degree u64,
    coeff_modulus_size u64, scale f64, correction_factor u64, nested
    DynArray data (components concatenated, prime-major)."""
    L, n = components[0].shape
    members = pid
    members += struct.pack("<B", 1 if is_ntt else 0)
    members += struct.pack("<Q", len(components))
    members += struct.pack("<Q", n)
    members += struct.pack("<Q", L)
    members += struct.pack("<d", scale)
    members += struct.pack("<Q", 1)            # correction_factor (BGV; 1)
    data = np.concatenate([c.reshape(-1) for c in components])
    return members + _dynarray_save(data)


def _ciphertext_parse(members: bytes, expect_pid: bytes):
    assert members[:32] == expect_pid, "parms_id mismatch"
    (is_ntt,) = struct.unpack("<B", members[32:33])
    size, n, L = struct.unpack("<QQQ", members[33:57])
    (scale,) = struct.unpack("<d", members[57:65])
    (_corr,) = struct.unpack("<Q", members[65:73])
    data, _ = _dynarray_load(members[73:])
    assert data.size == size * L * n, (data.size, size, L, n)
    return data.reshape(size, L, n), scale, bool(is_ntt)


def save_public_key(parms, pk0: np.ndarray, pk1: np.ndarray,
                    scale: float = 1.0) -> bytes:
    """PublicKey::save stream: the pk is a size-2 Ciphertext in NTT form
    under the key context (seal/ciphertext.cpp save_members layout).

    pk0/pk1: u64 (L_key, n) NTT-form components per key-context prime."""
    kmods = key_context_moduli(parms)
    L, n = pk0.shape
    assert pk0.shape == pk1.shape and L == len(kmods)
    return _wrap(_ciphertext_members(parms_id(parms.degree, kmods),
                                     (pk0, pk1), scale, True))


def load_public_key(parms, b: bytes) -> tuple[np.ndarray, np.ndarray]:
    members, _ = _unwrap(b)
    kmods = key_context_moduli(parms)
    comps, _scale, is_ntt = _ciphertext_parse(
        members, parms_id(parms.degree, kmods))
    assert is_ntt and comps.shape[0] == 2 and comps.shape[1] == len(kmods)
    return comps[0], comps[1]


def save_ciphertext(parms, c0: np.ndarray, c1: np.ndarray,
                    scale: float | None = None,
                    is_ntt: bool = True) -> bytes:
    """Ciphertext::save stream for a device-produced ct: a size-2
    Ciphertext under the DATA context (the device prime chain WITHOUT the
    special prime — fresh cts live at SEAL's first_context_data, which is
    what the adapter's ct loader targets, fileops.cpp:492-538).  The
    device emits per-prime NTT-form components (seal_embedded.c:180-204);
    c0/c1: u32/u64 (L, n)."""
    L, n = c0.shape
    assert c0.shape == c1.shape and L == parms.nprimes and n == parms.degree
    pid = parms_id(parms.degree, [int(q) for q in parms.moduli])
    sc = float(parms.scale if scale is None else scale)
    return _wrap(_ciphertext_members(
        pid, (c0.astype(np.uint64), c1.astype(np.uint64)), sc, is_ntt))


def load_ciphertext(parms, b: bytes):
    """Inverse of save_ciphertext: returns (c0, c1, scale) with c0/c1
    u64 (L, n) under the data context.  Validates the parms_id against
    this parameter set, so streams from a different chain fail loudly."""
    members, _ = _unwrap(b)
    pid = parms_id(parms.degree, [int(q) for q in parms.moduli])
    comps, scale, is_ntt = _ciphertext_parse(members, pid)
    assert is_ntt and comps.shape[0] == 2 and comps.shape[1] == parms.nprimes
    return comps[0], comps[1], scale
