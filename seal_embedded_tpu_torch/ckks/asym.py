"""Batched asymmetric (public-key) encode + encrypt and public-key
generation with the reference's PRNG semantics.

Port of ``seal_embedded_tpu/ckks/asym.py`` (ckks_asym.c:159-286):

* gen_pk: pk1 = a drawn per prime from the shareable stream, whose
  counter chains across primes; pk0 = -a * ntt(s) + ntt(ep) mod q.
* encrypt: one private stream per message feeds u <- ternary, then
  e0 <- CBD, then e1 <- CBD, the counter chaining from draw to draw; then
  per prime c1 = pk1 * ntt(u) + ntt(e1) and c0 = pk0 * ntt(u) + ntt(pte),
  pte = pt + e0.  The per-prime step has no sequential dependency: all
  limbs go through kernel KA in one launch, at every degree, straight
  from the signed (B, n) u, e1 and the int64 pte (KA maps and reduces
  them per limb as it loads them).
* the ternary draw: on the card KK's ternary role redraws without bound,
  as the C loop does, so ``ternary_ok`` is true on every row and
  ``redo_overflowed`` finds nothing to encrypt again.  On the CPU the
  draw's bounded queue (sp.TERNARY_QUEUE_CAP refills a 96-byte block)
  falls short for about 1.5e-7 of the blocks; the batch flags those rows
  apart from the encode's overflow (``ternary_ok``), and the API's asym
  entries encrypt them again exactly (``redo_overflowed``), so that every
  seed gives the C reference's bits.

On CPU tensors every kernel wrapper runs its plain version, so the same
module is the reference path of the tests.
"""

from __future__ import annotations

import threading
from functools import lru_cache

import numpy as np
import torch

from ..config import CUDA, Parms
from ..graphs import allocate, graphed, to_device
from ..ops import modarith as ma
from ..ops import sampling as sp
from ..ops.encode import check_encode_mode
from ..ops.kernels.ntt import ntt_asym_from_signed, ntt_fwd
from ..ops.ntt import ntt_tables_stacked
from ..utils import timing
from .fast import EncryptorBase


# The buffers of an AsymEncryptor's key, in key()'s order.
KEY_BUFFERS = ("pk0", "pk0_quot", "pk1", "pk1_quot")


class AsymEncryptor(EncryptorBase):
    """asym_encrypt_fused for one parameter set, with its tables (see
    EncryptorBase) and a public key, pk0, pk1 and their Shoup quotients
    (pk0_quot, pk1_quot), resident on `device` as buffers.

    pk0, pk1: int64 or uint32 (L, n) u32 values in [0, q), NTT form,
    tensors or arrays; the encryptor keeps copies, so a later in-place
    change of the caller's tensors leaves pk and its quotients consistent.
    Without them the key is zero until set_key gives one.
    forward(values f32 (B, <= n/2), seed_words int64 (B, 16) u32 private
    PRNG seeds) returns a dict with c0, c1 int64 (L, B, n) u32 values, pt
    and pte int64 (B, n) and ok bool (B,), the layouts of the JAX function,
    and ternary_ok bool (B,), false where the ternary draw's bounded
    queue fell short (ok is false there too; only on the CPU, see draws).
    """

    def __init__(self, parms: Parms, pk0=None, pk1=None, device=CUDA):
        super().__init__(parms, device)
        shape = (len(self.moduli), parms.degree)
        for name in KEY_BUFFERS:
            self.register_buffer(name, torch.zeros(shape, dtype=torch.int64,
                                                   device=device))
        if pk0 is not None:
            self.set_key(pk0, pk1)

    def key(self, pk0, pk1) -> tuple:
        """(pk0, pk0_quot, pk1, pk1_quot), the key as combine takes it,
        int64 on the encryptor's device, nothing of the encryptor changed.
        pk0, pk1: int64 or uint32 (L, n), tensors or arrays; for int64
        tensors on the device it computes on the device only, so inside a
        CUDA graph too."""
        qv = self.q[:, None]
        pk0, pk1 = (key_tensor(pk, self.q.device) for pk in (pk0, pk1))
        return (pk0, ma.shoup_quotient(pk0, qv), pk1,
                ma.shoup_quotient(pk1, qv))

    def set_key(self, pk0, pk1) -> None:
        """Copy the public key (as key() takes it) into the pk0, pk1
        buffers and their quotients into pk0_quot, pk1_quot."""
        for name, t in zip(KEY_BUFFERS, self.key(pk0, pk1)):
            getattr(self, name).copy_(t)

    def forward(self, values, seed_words, key=None, exact=False):
        """The batch under `key` (a key()), the encryptor's own if None;
        with exact, the ternary draw is sample_ternary_exact (see
        draws)."""
        pt, pte, u, e1, ok, ternary_ok = self.draws(values, seed_words,
                                                    exact)
        c0, c1 = self.combine(u, e1, pte, key=key)
        return {"c0": c0, "c1": c1, "pt": pt, "pte": pte,
                "ok": ok & ternary_ok, "ternary_ok": ternary_ok}

    def prologue(self, values, seed_words):
        """draws, its two flags folded into one: (pt, pte, u, e1, ok)."""
        pt, pte, u, e1, ok, ternary_ok = self.draws(values, seed_words)
        return pt, pte, u, e1, ok & ternary_ok

    def draws(self, values, seed_words, exact=False):
        """Encode (KE), then the private stream's draws, counters chaining
        u -> e0 -> e1 (ckks_asym.c:173-203): (pt, pte = pt + e0, u, e1
        int64 (B, n), the encode's ok and the ternary draw's ok (B,)).
        On the card the ternary draw redraws without bound
        (sp.sample_ternary_exact: KK's ternary role, one launch that a
        graph captures) and its ok is true; so on the CPU with exact (the
        role's plain version: eager, the host reads each block's flags).
        On the CPU without exact it is the bounded sp.sample_ternary,
        whose ok is false where a block's 8 refills fell short."""
        n = self.parms.degree
        pt, ok = self.encode(values)
        counter = sp.counter_zero((values.shape[0],), values.device)
        if exact or counter.device.type != "cpu":
            u, counter = sp.sample_ternary_exact(seed_words, counter, n)
            ternary_ok = torch.ones_like(ok)
        else:
            u, counter, ternary_ok = sp.sample_ternary(seed_words, counter,
                                                       n)
        e0, counter = sp.sample_cbd(seed_words, counter, n)
        e1, counter = sp.sample_cbd(seed_words, counter, n)
        return pt, pt + e0, u, e1, ok, ternary_ok

    def combine(self, u, e1, pte, limbs=slice(None), key=None):
        """(c0, c1) (l, B, n) of the limbs `limbs` (a slice of the
        per-limb buffers) in one KA launch, from the prologue's signed u,
        e1 and int64 pte (B, n), under `key` (a key() of the whole chain)
        or, if None, the encryptor's own."""
        if key is None:
            key = tuple(getattr(self, name) for name in KEY_BUFFERS)
        pk0, pk0_quot, pk1, pk1_quot = (t[limbs] for t in key)
        return ntt_asym_from_signed(
            u, e1, pte, self.ntt_op[limbs], self.ntt_quot[limbs],
            self.q[limbs], self.r0[limbs], self.r1[limbs], pk0, pk0_quot,
            pk1, pk1_quot)


# Since the process began: the asym messages the API's entries encrypted
# ("messages") and the rows among them encrypted again ("rows"), counted
# by redo_overflowed.
_redo = {"messages": 0, "rows": 0}
_redo_lock = threading.Lock()


def redo_counts() -> dict:
    """{"messages", "rows"}: the API's asym messages since the process
    began and the rows of them redo_overflowed encrypted again."""
    with _redo_lock:
        return dict(_redo)


def redo_overflowed(enc: AsymEncryptor, values, seed_words, key,
                    ternary_ok: np.ndarray):
    """The rule of every asym entry of the API for a call's rows whose
    ternary draw's bounded queue fell short (ternary_ok false, a host
    array): those rows alone encrypted again, eagerly on `enc`'s device
    with the port's kernels, the ternary draw exact (forward with exact;
    a ``stream.redo`` span), under key() (a callable giving enc.key()'s
    tuple, called only then).  The caller writes them over the call's
    outputs before it hands any of them out.  values, seed_words: the
    call's inputs on the device.  Returns (rows int64 (r,), the rows'
    forward dict), or None where no row fell short."""
    rows = np.flatnonzero(~ternary_ok)
    with _redo_lock:
        _redo["messages"] += len(ternary_ok)
        _redo["rows"] += len(rows)
    if not len(rows):
        return None
    with timing.span("stream.redo"):
        idx = torch.as_tensor(rows, device=values.device)
        return rows, enc(values[idx], seed_words[idx], key(), exact=True)


def gen_pk_batch(sk_signed, pk_seed_words, ep, parms: Parms):
    """Public-key generation (ckks_asym.c:159-171).

    sk_signed: int (n,) in {-1, 0, 1}; pk_seed_words: int64 (16,) or
    (1, 16) u32 shareable seed; ep: int (n,) CBD error.  Returns (pk0, pk1)
    int64 (L, n) u32 values on sk_signed's device.
    """
    n = parms.degree
    dev = sk_signed.device
    moduli = tuple(int(q) for q in parms.moduli)
    a, _ = sp.sample_uniform_limbs(pk_seed_words.reshape(1, 16), moduli, n,
                                   sp.queue_cap_for(n, moduli))
    pk1 = a[:, 0]

    # ntt(s) and ntt(ep) as the two rows of one KN launch: (L, 2, n).
    op, quot = (torch.as_tensor(t.astype(np.int64), device=dev)
                for t in ntt_tables_stacked(n, moduli))
    m = ma.modpack(moduli, dev)
    mods = ma.Mod(m.q[:, None], m.r0[:, None], m.r1[:, None], None)  # (L, 1)
    rows = torch.stack([
        sp.ternary_to_modq_any(sk_signed.to(torch.int64), mods),
        sp.ternary_to_modq_any(ep.to(torch.int64), mods)], dim=1)
    ntts = ntt_fwd(rows, op, quot, m.q)
    pk0 = ma.add_mod(ma.neg_mod(ma.mul_mod(pk1, ntts[:, 0], mods), mods),
                     ntts[:, 1], mods)
    return pk0, pk1


def asym_encrypt_fused(values, pk0, pk1, seed_words, parms: Parms,
                       encode_mode: str = "dd"):
    """Batched asymmetric encode + encrypt (the JAX function's signature);
    builds an AsymEncryptor on values' device and runs it once.  Every
    encode_mode of the JAX package is the one bit-exact f64 encode here."""
    check_encode_mode(encode_mode)
    return AsymEncryptor(parms, pk0, pk1, values.device)(values, seed_words)


def asym_encrypt_batch(values, pk0, pk1, seed_words, parms: Parms,
                       encode_mode: str = "f64"):
    """The JAX package's unfused asym entry; the same bits as
    asym_encrypt_fused, so the same module serves it."""
    return asym_encrypt_fused(values, pk0, pk1, seed_words, parms,
                              encode_mode)


def key_tensor(pk, device) -> torch.Tensor:
    """A public-key component (int64 or uint32 (L, n), a tensor or an
    array) as an int64 tensor on `device` (an eager allocation,
    graphs.allocate)."""
    if isinstance(pk, torch.Tensor):
        return allocate(lambda: pk.to(device, torch.int64), device,
                        pk.numel() * 8)
    return to_device(np.asarray(pk).astype(np.int64), device)


class _KeyedEncryptor:
    """fn(values, pk0, pk1, seed_words) -> dict on one (parms, device), the
    key given per call as the JAX factory's jitted function takes it: one
    AsymEncryptor, and the call's key() + forward compiled per input
    signature (`graphed`), pk among the graph's inputs (the encryptor's
    own key buffers stay unused, so two signatures share no key).  A key
    that is not an int64 tensor on `device` is moved there first."""

    def __init__(self, parms: Parms, device: torch.device):
        self.device = device
        self.encryptor = AsymEncryptor(parms, device=device)
        self.graphed = graphed(self._encrypt, device)

    def _encrypt(self, values, pk0, pk1, seed_words):
        return self.encryptor(values, seed_words,
                              self.encryptor.key(pk0, pk1))

    def __call__(self, values, pk0, pk1, seed_words):
        return self.graphed(values, key_tensor(pk0, self.device),
                            key_tensor(pk1, self.device), seed_words)

    def scrub(self) -> None:
        """Zero the key's copies: the graphs' static inputs (the next call
        copies its own key in)."""
        self.graphed.scrub()


@lru_cache(maxsize=16)
def _keyed_encryptor(parms: Parms, device: torch.device) -> _KeyedEncryptor:
    return _KeyedEncryptor(parms, device)


def make_asym_encryptor(parms: Parms, encode_mode: str = "f64",
                        device=CUDA):
    """asym_encrypt_batch bound to its parameters and compiled per input
    signature on `device` (the card unless told otherwise), as the JAX
    factory's jitted function: fn(values, pk0, pk1, seed_words) -> dict,
    pk given per call (int64 or uint32 (L, n)).  One function per (parms,
    device) serves every call and every key."""
    check_encode_mode(encode_mode)
    return _keyed_encryptor(parms, torch.device(device))


def make_fused_asym_encryptor(parms: Parms, encode_mode: str = "dd",
                              device=CUDA):
    """asym_encrypt_fused bound to its parameters; the same bits and the
    same function as make_asym_encryptor's."""
    return make_asym_encryptor(parms, encode_mode, device)
