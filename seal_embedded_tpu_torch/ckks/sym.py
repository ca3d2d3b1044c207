"""Batched symmetric CKKS encode + encrypt, written per prime, and the
decrypt oracle.

Port of ``seal_embedded_tpu/ckks/sym.py``:

    encode (KE)  ->  + CBD error  ->  per prime:
        a = uniform(shareable stream)      [c1]
        c0 = -a * ntt(s) + ntt(reduce(pt + e))

The combine is the JAX package's Barrett mul_mod / neg_mod / add_mod in
torch, where ``SymEncryptor`` fuses it into KN in Shoup form; both give
the same canonical values.  ``decrypt_batch`` is the test oracle: per
prime, ntt(s) through KN, then c0 + c1 * ntt(s) and the inverse NTT
(plain torch, as the JAX package's jnp INTT).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..config import Parms
from ..convert import CUDA
from ..io.serialize import intt_fast_root_table
from ..ops import modarith as ma
from ..ops import sampling as sp
from ..ops.encode import encode_any
from ..ops.kernels.ntt import ntt_fwd
from ..ops.ntt import intt, intt_lazy_with_tables, ntt_otf, ntt_tables_stacked
from .limbwise import LimbscanEncryptor

NTT_VARIANTS = ("table", "otf")
INTT_IMPLS = ("canonical", "lazy")


def _ntt_table(x, moduli):
    """ntt of x int64 (L, B, n) per limb through KN, one launch."""
    dev = x.device
    op, quot = (torch.as_tensor(t.astype(np.int64), device=dev)
                for t in ntt_tables_stacked(x.shape[-1], moduli))
    q = torch.tensor(moduli, dtype=torch.int64, device=dev)
    return ntt_fwd(x.contiguous(), op, quot, q)


def _ntt_otf(x, moduli):
    """ntt of x int64 (L, B, n) per limb with on-the-fly roots (plain)."""
    return torch.stack([ntt_otf(x[i], q) for i, q in enumerate(moduli)])


def _ntt_s_for_prime(sk_signed, q: int):
    """ntt(expand(s)) for one prime through KN; sk_signed {-1, 0, 1} (n,)."""
    s_modq = sp.ternary_to_modq(sk_signed.to(torch.int64), q)
    return _ntt_table(s_modq.reshape(1, 1, -1), (int(q),))[0, 0]


def sym_encrypt_batch(values, sk_signed, share_seed_words, err_seed_words,
                      parms: Parms, ntt_variant: str = "table",
                      root_tables=None, imap=None):
    """Full batched symmetric encode + encrypt.

    values: f32 (B, <= n/2); sk_signed: int (n,) in {-1, 0, 1};
    share_seed_words, err_seed_words: int64 (B, 16) u32 seeds.
    ntt_variant: "table" (ntt(pte) for all limbs in one KN launch) or
    "otf" (roots built per call, ntt_otf; value-identical).
    root_tables / imap: optional loaded IFFT roots and index map, as
    ops.encode.table_tensors takes them.  Returns a dict with c0, c1 int64
    (L, B, n), pt, pte int64 (B, n) and ok (B,).
    """
    if ntt_variant not in NTT_VARIANTS:
        raise ValueError(f"unknown ntt variant {ntt_variant!r}")
    do_ntt = _ntt_table if ntt_variant == "table" else _ntt_otf
    B = values.shape[0]
    n = parms.degree
    dev = values.device
    moduli = tuple(int(q) for q in parms.moduli)

    pt, ok = encode_any(values, parms, "f64", root_tables, imap)
    e, _ = sp.sample_cbd(err_seed_words, sp.counter_zero((B,), dev), n)
    pte = pt + e

    # The share counter chains from prime to prime (sym.py:68-84).
    a, ok_u = sp.sample_uniform_limbs(share_seed_words, moduli, n,
                                      sp.queue_cap_for(n, moduli))
    m = ma.modpack(moduli, dev)
    mods = ma.Mod(m.q[:, None, None], m.r0[:, None, None],
                  m.r1[:, None, None], None)
    s_modq = sp.ternary_to_modq(sk_signed.to(torch.int64)[None, None], mods)
    ntt_s = do_ntt(s_modq.contiguous(), moduli)               # (L, 1, n)
    ntt_pte = do_ntt(ma.reduce_pte_i64(pte[None], mods), moduli)
    c0 = ma.add_mod(ma.neg_mod(ma.mul_mod(a, ntt_s, mods), mods), ntt_pte,
                    mods)
    return {"c0": c0, "c1": a, "pt": pt, "pte": pte, "ok": ok & ok_u}


def make_sym_encryptor(parms: Parms, layout: str = "reference",
                       device=CUDA):
    """The symmetric encryptor the JAX package caches: the limb-scan
    pipeline, bit-identical to sym_encrypt_batch in the reference layout."""
    return LimbscanEncryptor(parms, layout, device=device)


def decrypt_batch(c0, c1, sk_signed, parms: Parms,
                  intt_impl: str = "canonical", loaded_intt=None):
    """Test oracle: per-prime decrypt to centered pte, int64 (L, B, n).

    c0, c1: int64 (L, B, n) u32 values.  intt_impl: "canonical"
    (ops.ntt.intt) or "lazy", the reference's fast INTT with MUMO tables
    (intt_lazy_inpl, intt.c:72-129), reading `loaded_intt` ({q: (op,
    quot)} arrays) where it has q and computing the tables in the same
    file order where not.  Value-identical.
    """
    if intt_impl not in INTT_IMPLS:
        raise ValueError(f"unknown intt impl {intt_impl!r}")
    outs = []
    for i, q in enumerate(parms.moduli):
        q = int(q)
        ntt_s = _ntt_s_for_prime(sk_signed, q)
        pte_ntt = ma.add_mod(c0[i], ma.mul_mod(c1[i], ntt_s[None, :], q), q)
        if intt_impl == "lazy":
            if loaded_intt is not None and q in loaded_intt:
                op, quot = loaded_intt[q]
            else:
                pairs = intt_fast_root_table(parms.degree, parms.logn, q,
                                             parms.ntt_root(q))
                op, quot = pairs[0::2], pairs[1::2]
            op, quot = (torch.as_tensor(np.asarray(t, np.uint32)
                                        .astype(np.int64), device=c0.device)
                        for t in (op, quot))
            pte = intt_lazy_with_tables(pte_ntt, op, quot, q)
        else:
            pte = intt(pte_ntt, q)
        outs.append(torch.where(pte > q // 2, pte - q, pte))
    return torch.stack(outs)


def make_decryptor(parms: Parms):
    """decrypt_batch bound to its parameters."""
    return partial(decrypt_batch, parms=parms)
