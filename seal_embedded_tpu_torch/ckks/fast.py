"""Batched symmetric encode + encrypt with the reference's PRNG semantics.

Port of ``seal_embedded_tpu/ckks/fast.py``: one shareable PRNG stream
whose counter chains across primes (seal_embedded.c:145-213), restructured
so the heavy parts run as the port's three kernels:

* encode (KE), the CBD error and every SHAKE-256 expansion of the
  uniform sampler (KK);
* the NTT of the plaintext+error for all limbs in one launch, reduced
  per limb as it loads and fused with the c0 epilogue (KN), and ntt(s)
  per limb through the same kernel.

The limb loop carries only the sampler counter, the one true sequential
dependency.  On CPU tensors every kernel wrapper runs its plain version,
so the same module is the reference path of the tests.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..config import CUDA, Parms
from ..graphs import graphed
from ..ops import modarith as ma
from ..ops import sampling as sp
from ..ops.encode import check_encode_mode, scale_over_n, table_tensors
from ..ops.kernels.encode import encode_f64
from ..ops.kernels.ntt import ntt_fwd, ntt_sym_from_pte
from ..ops.ntt import ntt_tables_stacked


class EncryptorBase(nn.Module):
    """The per-parameter-set state both encryptors keep resident on
    `device` as buffers: NTT roots (ntt_op, ntt_quot), the modulus vector
    q, the Barrett constants r0, r1, the encode index map and the IFFT
    twiddles.  `device` defaults to the card."""

    def __init__(self, parms: Parms, device=CUDA):
        super().__init__()
        self.parms = parms
        self.moduli = tuple(int(q) for q in parms.moduli)
        self.scale_n = scale_over_n(parms)
        op, quot = ntt_tables_stacked(parms.degree, self.moduli)
        self.register_buffer("ntt_op", torch.as_tensor(
            op.astype(np.int64), device=device))
        self.register_buffer("ntt_quot", torch.as_tensor(
            quot.astype(np.int64), device=device))
        mods = ma.modpack(self.moduli, device)
        self.register_buffer("q", mods.q)
        self.register_buffer("r0", mods.r0)
        self.register_buffer("r1", mods.r1)
        imap, tw_re, tw_im = table_tensors(parms.degree, device)
        self.register_buffer("imap", imap)
        self.register_buffer("tw_re", tw_re)
        self.register_buffer("tw_im", tw_im)

    def encode(self, values):
        """Kernel KE: (pt int64 (B, n), ok (B,))."""
        return encode_f64(values, self.imap, self.tw_re, self.tw_im,
                          self.scale_n)


class SymEncryptor(EncryptorBase):
    """sym_encrypt_fused for one parameter set, with its tables resident
    on `device` (see EncryptorBase).

    forward(values f32 (B, <= n/2), sk_signed int (n,) in {-1, 0, 1},
    share_words, err_words int64 (B, 16) u32 PRNG seeds) returns a dict
    with c0, c1 int64 (L, B, n) u32 values, pte and pt int64 (B, n) and
    ok bool (B,), the layouts of the JAX function.
    """

    def __init__(self, parms: Parms, device=CUDA):
        super().__init__(parms, device)
        self.queue_cap = sp.queue_cap_for(parms.degree, self.moduli)

    def ntt_secret(self, sk_signed, limbs=slice(None)):
        """ntt(s) of the limbs `limbs` (a slice of the per-limb buffers):
        (l, n), s mapped {-1, 0, 1} -> {q-1, 0, 1}."""
        q = self.q[limbs]
        sk = sk_signed.to(torch.int64).reshape(1, 1, -1)
        s = torch.where(sk < 0, q[:, None, None] - 1, sk)   # (l, 1, n)
        return ntt_fwd(s.contiguous(), self.ntt_op[limbs],
                       self.ntt_quot[limbs], q)[:, 0, :]

    def forward(self, values, sk_signed, share_words, err_words):
        pt, pte, ok = self.encode_with_error(values, err_words)
        out = self.encrypt_pte(pte, sk_signed, share_words, ok)
        out["pt"] = pt
        return out

    def encode_with_error(self, values, err_words):
        """Encode (KE) and add the CBD error drawn from the private stream
        at counter 0 (ckks_encode_base + ckks_sym_init): (pt, pte int64
        (B, n), ok (B,))."""
        pt, ok = self.encode(values)
        e, _ = sp.sample_cbd(err_words, sp.counter_zero(
            (values.shape[0],), values.device), self.parms.degree)
        return pt, pt + e, ok

    def draw_c1(self, share_words):
        """Uniform a per prime; the counter chains from limb to limb."""
        return sp.sample_uniform_limbs(share_words, self.moduli,
                                       self.parms.degree, self.queue_cap)

    def encrypt_pte(self, pte, sk_signed, share_words, ok=None):
        """c0, c1 from the encoded pt + e (int64 (B, n)): a dict with c0,
        c1 (L, B, n), pte and ok (B,), the given ok (all True when None)
        and-ed with the sampler's."""
        a, ok_u = self.draw_c1(share_words)
        if ok is not None:
            ok_u = ok & ok_u
        c0 = self.c0_from_pte(pte, a, self.ntt_secret(sk_signed))
        return {"c0": c0, "c1": a, "pte": pte, "ok": ok_u}

    def c0_from_pte(self, pte, a, ntt_s, limbs=slice(None)):
        """c0 = -a * ntt(s) + ntt(pte mod q) (l, B, n) of the limbs `limbs`
        (a slice of the per-limb buffers), from pte int64 (B, n), a (l, B, n)
        and ntt_s (l, n) of those limbs, in one KN launch: KN reduces pte per
        limb as it loads it and fuses the epilogue, so neither the reduced
        pte nor ntt(pte) is ever stored."""
        q = self.q[limbs]
        s_quot = ma.shoup_quotient(ntt_s, q[:, None])
        return ntt_sym_from_pte(pte, a.contiguous(), ntt_s.contiguous(),
                                s_quot.contiguous(), self.ntt_op[limbs],
                                self.ntt_quot[limbs], q, self.r0[limbs],
                                self.r1[limbs])


def sym_encrypt_fused(values, sk_signed, share_words, err_words,
                      parms: Parms, encode_mode: str = "sf"):
    """Batched symmetric encode + encrypt (the JAX function's signature);
    builds a SymEncryptor on values' device and runs it once.  Every
    encode_mode of the JAX package is the one bit-exact f64 encode here."""
    check_encode_mode(encode_mode)
    return SymEncryptor(parms, values.device)(
        values, sk_signed, share_words, err_words)


@lru_cache(maxsize=16)
def _graphed_sym(parms: Parms, device: torch.device):
    return graphed(SymEncryptor(parms, device), device)


def make_fused_encryptor(parms: Parms, encode_mode: str = "dd",
                         device=CUDA):
    """sym_encrypt_fused bound to its parameters and compiled per input
    signature on `device` (the card unless told otherwise), as the JAX
    factory's jitted function: (values, sk_signed, share_words, err_words)
    -> dict.  One SymEncryptor per (parms, device) serves every call."""
    check_encode_mode(encode_mode)
    return _graphed_sym(parms, torch.device(device))
