"""CKKS encode + encrypt, sym and asym, and the public key, rows at once.

The reference's pipelines (seal_embedded.c:98-215, ckks_sym.c:181-301,
ckks_asym.c:159-286, ckks_common.c:224-274), each message with its own
seeds:

* sym: pte = encode(v) + CBD(prng(seed)); per prime q_i in chain order,
  a = uniform(prng(share_seed)), the shareable stream's counter carried
  from prime to prime; c1 = a, c0 = -a ntt(s) + ntt(pte mod q);
* asym: from prng(seed), u ternary, then pte = encode(v) + CBD, then e1
  CBD; per prime c0 = pk0 ntt(u) + ntt(pte mod q), c1 = pk1 ntt(u) +
  ntt(e1 mod q);
* the public key (the rule of the program's set-up, which SEAL-Embedded
  leaves to its caller): ep = CBD(prng(SHAKE-256(pk_seed || "ep"), 64
  bytes)); per prime a = uniform(prng(pk_seed)), pk1 = a, pk0 = -a ntt(s)
  + ntt(ep mod q).

Outputs are int64 (L, R, n) in chain order, NTT form.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import sampling as sp
from .encode import encode
from .ntt import ntt
from .params import Params


def reduce_signed(x: np.ndarray, q: int) -> np.ndarray:
    """Signed int64 -> mod q as ckks_common.c:224-274 folds it: a negative
    x maps to q - (|x| mod q), so a negative multiple of q maps to q."""
    r = np.abs(x) % q
    return np.where(x < 0, q - r, r)


def ntt_secret(p: Params, sk: np.ndarray) -> np.ndarray:
    """ntt(s mod q_i) per prime, int64 (L, n), from sk in {-1, 0, 1}."""
    s = np.asarray(sk, dtype=np.int64)[None]
    return np.stack([ntt(reduce_signed(s, q), q, w)[0]
                     for q, w in zip(p.moduli, p.roots)])


def sym_encrypt(p: Params, sk, values, share_seeds, seeds,
                dtype=np.float64):
    """(c0, c1) of the messages `values` (R, n/2) float32."""
    n = p.degree
    pte = encode(p, values, dtype)
    pte += np.stack([sp.cbd(sp.Prng(s), n) for s in seeds])
    shares = [sp.Prng(s) for s in share_seeds]
    ntt_s = ntt_secret(p, sk)
    c0, c1 = [], []
    for i, (q, w) in enumerate(zip(p.moduli, p.roots)):
        a = np.stack([sp.uniform(prng, n, q) for prng in shares])
        c0.append((q - ntt_s[i] * a % q + ntt(reduce_signed(pte, q), q, w))
                  % q)
        c1.append(a)
    return np.stack(c0), np.stack(c1)


def asym_encrypt(p: Params, pk0, pk1, values, seeds, dtype=np.float64):
    """(c0, c1) under the public key (pk0, pk1 int64 (L, n))."""
    n = p.degree
    pt = encode(p, values, dtype)
    u, pte, e1 = [], [], []
    for row, s in enumerate(seeds):
        prng = sp.Prng(s)
        u.append(sp.ternary(prng, n))
        pte.append(pt[row] + sp.cbd(prng, n))
        e1.append(sp.cbd(prng, n))
    u, pte, e1 = np.stack(u), np.stack(pte), np.stack(e1)
    c0, c1 = [], []
    for i, (q, w) in enumerate(zip(p.moduli, p.roots)):
        ntt_u = ntt(reduce_signed(u, q), q, w)
        c0.append((pk0[i] * ntt_u % q + ntt(reduce_signed(pte, q), q, w))
                  % q)
        c1.append((pk1[i] * ntt_u % q + ntt(reduce_signed(e1, q), q, w))
                  % q)
    return np.stack(c0), np.stack(c1)


def public_key_error(pk_seed: bytes, n: int) -> np.ndarray:
    """ep, the public key's CBD error, from the pk seed."""
    ep_seed = hashlib.shake_256(pk_seed + b"ep").digest(sp.SEED_BYTES)
    return sp.cbd(sp.Prng(ep_seed), n)


def public_key(p: Params, sk, pk_seed: bytes, ep=None):
    """(pk0, pk1) int64 (L, n); ep from the pk seed unless given."""
    n = p.degree
    if ep is None:
        ep = public_key_error(pk_seed, n)
    ep = np.asarray(ep, dtype=np.int64)[None]
    prng = sp.Prng(pk_seed)
    ntt_s = ntt_secret(p, sk)
    pk0, pk1 = [], []
    for i, (q, w) in enumerate(zip(p.moduli, p.roots)):
        a = sp.uniform(prng, n, q)
        pk0.append((q - ntt_s[i] * a % q + ntt(reduce_signed(ep, q), q, w)[0])
                   % q)
        pk1.append(a)
    return np.stack(pk0), np.stack(pk1)
