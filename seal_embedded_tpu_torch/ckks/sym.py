"""Batched symmetric CKKS encode + encrypt, written per prime, and the
decrypt oracle.

Port of ``seal_embedded_tpu/ckks/sym.py``:

    encode (KE)  ->  + CBD error  ->  per prime:
        a = uniform(shareable stream)      [c1]
        c0 = -a * ntt(s) + ntt(reduce(pt + e))

The combine is the JAX package's Barrett mul_mod / neg_mod / add_mod in
torch, where ``SymEncryptor`` fuses it into KN in Shoup form; both give
the same canonical values.  ``Decryptor`` (``decrypt_batch``,
``make_decryptor``) is the test oracle: ntt(s) of every prime in one KN
launch, then per prime c0 + c1 * ntt(s) and the inverse NTT (plain
torch, as the JAX package's jnp INTT).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..config import CUDA, Parms
from ..graphs import graphed
from ..io.serialize import intt_fast_root_table
from ..ops import modarith as ma
from ..ops import sampling as sp
from ..ops.encode import table_tensors
from ..ops.kernels.ntt import ntt_fwd
from ..ops.ntt import (intt_lazy_with_tables, intt_tables, intt_with_tables,
                       ntt_otf, ntt_tables_stacked)
from .fast import EncryptorBase
from .limbwise import make_limbscan_encryptor

NTT_VARIANTS = ("table", "otf")
INTT_IMPLS = ("canonical", "lazy")


def _ntt_table(x, moduli):
    """ntt of x int64 (L, B, n) per limb through KN, one launch."""
    dev = x.device
    op, quot = (torch.as_tensor(t.astype(np.int64), device=dev)
                for t in ntt_tables_stacked(x.shape[-1], moduli))
    q = torch.tensor(moduli, dtype=torch.int64, device=dev)
    return ntt_fwd(x.contiguous(), op, quot, q)


def _ntt_s_for_prime(sk_signed, q: int):
    """ntt(expand(s)) for one prime through KN; sk_signed {-1, 0, 1} (n,)."""
    s_modq = sp.ternary_to_modq(sk_signed.to(torch.int64), q)
    return _ntt_table(s_modq.reshape(1, 1, -1), (int(q),))[0, 0]


class BatchEncryptor(EncryptorBase):
    """sym_encrypt_batch for one parameter set and NTT variant, with its
    tables resident on `device` (see EncryptorBase; the encode tables
    from `root_tables` and `imap` when given, as table_tensors takes
    them), so that a call copies nothing from the host and can run inside
    a CUDA graph (parallel.mesh.sym_encrypt_sharded).

    forward(values, sk_signed, share_words, err_words) -> dict, as
    sym_encrypt_batch."""

    def __init__(self, parms: Parms, device=CUDA, ntt_variant: str = "table",
                 root_tables=None, imap=None):
        if ntt_variant not in NTT_VARIANTS:
            raise ValueError(f"unknown ntt variant {ntt_variant!r}")
        super().__init__(parms, device)
        self.ntt_variant = ntt_variant
        self.queue_cap = sp.queue_cap_for(parms.degree, self.moduli)
        if root_tables is not None or imap is not None:
            for name, t in zip(("imap", "tw_re", "tw_im"), table_tensors(
                    parms.degree, device, root_tables, imap)):
                setattr(self, name, t)

    def ntt(self, x):
        """ntt of x int64 (L, B, n) per limb: through KN in one launch
        ("table"), or with on-the-fly roots, plain ("otf")."""
        if self.ntt_variant == "table":
            return ntt_fwd(x.contiguous(), self.ntt_op, self.ntt_quot, self.q)
        return torch.stack([ntt_otf(x[i], q)
                            for i, q in enumerate(self.moduli)])

    def forward(self, values, sk_signed, share_words, err_words):
        n = self.parms.degree
        pt, ok = self.encode(values)
        e, _ = sp.sample_cbd(err_words, sp.counter_zero(
            (values.shape[0],), values.device), n)
        pte = pt + e
        # The share counter chains from prime to prime (sym.py:68-84).
        a, ok_u = sp.sample_uniform_limbs(share_words, self.moduli, n,
                                          self.queue_cap)
        mods = ma.Mod(self.q[:, None, None], self.r0[:, None, None],
                      self.r1[:, None, None], None)
        s_modq = sp.ternary_to_modq(sk_signed.to(torch.int64)[None, None],
                                    mods)
        ntt_s = self.ntt(s_modq)                               # (L, 1, n)
        ntt_pte = self.ntt(ma.reduce_pte_i64(pte[None], mods))
        c0 = ma.add_mod(ma.neg_mod(ma.mul_mod(a, ntt_s, mods), mods),
                        ntt_pte, mods)
        return {"c0": c0, "c1": a, "pt": pt, "pte": pte, "ok": ok & ok_u}


@lru_cache(maxsize=16)
def _batch_encryptor(parms: Parms, ntt_variant: str,
                     device: torch.device) -> BatchEncryptor:
    return BatchEncryptor(parms, device, ntt_variant)


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
    (L, B, n), pt, pte int64 (B, n) and ok (B,).  Runs the cached
    BatchEncryptor of (parms, ntt_variant, device), or one built for the
    loaded tables.
    """
    if ntt_variant not in NTT_VARIANTS:
        raise ValueError(f"unknown ntt variant {ntt_variant!r}")
    if root_tables is None and imap is None:
        enc = _batch_encryptor(parms, ntt_variant, values.device)
    else:
        enc = BatchEncryptor(parms, values.device, ntt_variant, root_tables,
                             imap)
    return enc(values, sk_signed, share_seed_words, err_seed_words)


def make_sym_encryptor(parms: Parms, layout: str = "reference",
                       device=CUDA):
    """The symmetric encryptor the JAX package caches: the limb-scan
    pipeline, bit-identical to sym_encrypt_batch in the reference layout,
    compiled per input signature (make_limbscan_encryptor)."""
    return make_limbscan_encryptor(parms, layout, device=device)


class Decryptor(nn.Module):
    """Test oracle for one parameter set: per-prime decrypt to centered
    pte, with its tables resident on `device` as buffers: ntt(s)'s root
    tables (ntt_op, ntt_quot), the moduli q and the inverse tables
    (intt_op, intt_quot, (L, n)) of `intt_impl`.

    intt_impl: "canonical" (ops.ntt.intt's tables) or "lazy", the
    reference's fast INTT with MUMO tables (intt_lazy_inpl,
    intt.c:72-129), read from `loaded_intt` ({q: (op, quot)} arrays) where
    it has q and computed in the same file order where not.
    Value-identical.

    forward(c0, c1 int64 (L, B, n) u32 values, sk_signed (n,) in {-1, 0,
    1}) returns int64 (L, B, n): ntt(s) of every limb in one KN launch,
    then per limb c0 + c1 * ntt(s), the inverse NTT and centering.
    """

    def __init__(self, parms: Parms, intt_impl: str = "canonical",
                 loaded_intt=None, device=CUDA):
        super().__init__()
        if intt_impl not in INTT_IMPLS:
            raise ValueError(f"unknown intt impl {intt_impl!r}")
        n = parms.degree
        self.moduli = tuple(int(q) for q in parms.moduli)
        self.lazy = intt_impl == "lazy"
        inverse = []
        for q in self.moduli:
            if not self.lazy:
                inverse.append(intt_tables(n, q))
            elif loaded_intt is not None and q in loaded_intt:
                inverse.append(loaded_intt[q])
            else:
                pairs = intt_fast_root_table(n, parms.logn, q,
                                             parms.ntt_root(q))
                inverse.append((pairs[0::2], pairs[1::2]))
        tables = {"ntt": ntt_tables_stacked(n, self.moduli),
                  "intt": tuple(np.stack([np.asarray(t[j], np.uint32)
                                          for t in inverse])
                                for j in (0, 1))}
        for kind, (op, quot) in tables.items():
            for name, t in ((f"{kind}_op", op), (f"{kind}_quot", quot)):
                self.register_buffer(name, torch.as_tensor(
                    t.astype(np.int64), device=device))
        self.register_buffer("q", torch.tensor(self.moduli,
                                               dtype=torch.int64,
                                               device=device))

    def forward(self, c0, c1, sk_signed):
        sk = sk_signed.to(torch.int64).reshape(1, 1, -1)
        s = torch.where(sk < 0, self.q[:, None, None] - 1, sk)   # (L, 1, n)
        ntt_s = ntt_fwd(s.contiguous(), self.ntt_op, self.ntt_quot,
                        self.q)[:, 0]
        inverse = intt_lazy_with_tables if self.lazy else intt_with_tables
        outs = []
        for i, q in enumerate(self.moduli):
            pte_ntt = ma.add_mod(c0[i], ma.mul_mod(c1[i], ntt_s[i][None, :],
                                                   q), q)
            pte = inverse(pte_ntt, self.intt_op[i], self.intt_quot[i], q)
            outs.append(torch.where(pte > q // 2, pte - q, pte))
        return torch.stack(outs)


def _intt_key(loaded_intt):
    """loaded_intt ({q: (op, quot)}) as a hashable key: its bytes."""
    if loaded_intt is None:
        return None
    return tuple(sorted((int(q), *(np.asarray(t, np.uint32).tobytes()
                                   for t in tables))
                        for q, tables in loaded_intt.items()))


@lru_cache(maxsize=16)
def _decryptor(parms: Parms, intt_impl: str, intt_key,
               device: torch.device) -> Decryptor:
    loaded = None if intt_key is None else {
        q: tuple(np.frombuffer(b, np.uint32) for b in tables)
        for q, *tables in intt_key}
    return Decryptor(parms, intt_impl, loaded, device)


def decrypt_batch(c0, c1, sk_signed, parms: Parms,
                  intt_impl: str = "canonical", loaded_intt=None):
    """Test oracle: per-prime decrypt to centered pte, int64 (L, B, n),
    through the cached Decryptor of (parms, intt_impl, loaded_intt) on
    c0's device.  c0, c1: int64 (L, B, n) u32 values; see Decryptor."""
    return _decryptor(parms, intt_impl, _intt_key(loaded_intt),
                      c0.device)(c0, c1, sk_signed)


@lru_cache(maxsize=16)
def _graphed_decryptor(parms: Parms, intt_impl: str, intt_key,
                       device: torch.device):
    return graphed(_decryptor(parms, intt_impl, intt_key, device), device)


def make_decryptor(parms: Parms, intt_impl: str = "canonical",
                   loaded_intt=None, device=CUDA):
    """decrypt_batch bound to its parameters and compiled per input
    signature on `device` (the card unless told otherwise), as the JAX
    package's cached jit: fn(c0, c1, sk_signed) -> int64 (L, B, n)."""
    return _graphed_decryptor(parms, intt_impl, _intt_key(loaded_intt),
                              torch.device(device))
