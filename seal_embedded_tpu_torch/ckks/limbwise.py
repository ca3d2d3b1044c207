"""Limb-scan / limb-parallel symmetric pipeline.

Port of ``seal_embedded_tpu/ckks/limbwise.py``.  Two stream layouts:

* "reference": the reference's exact PRNG semantics, one shareable stream
  whose counter chains across primes (seal_embedded.c:145-213); bit-exact
  against the C reference.
* "parallel": prime i's uniform stream starts at counter
  i * PARALLEL_COUNTER_STRIDE, so the limbs do not depend on each other.
  The ciphertexts are equally valid RLWE samples and decrypt the same, but
  are not the reference's bytes.

Two walk orders: "forward" takes the modulus chain 0..L-1, "reverse" takes
L-1..0 (the reference's SE_REVERSE_CT_GEN, parameters.c:52-89); outputs
are stacked in walk order.  The JAX package scans the limbs with lax.scan
or vmap; here the sampler's limb loop is a Python loop and ntt(s) and the
fused c0 run for all limbs in one KN launch each, as in ``SymEncryptor``.
"""

from __future__ import annotations

from functools import lru_cache, partial

import torch

from ..config import CUDA, Parms
from ..graphs import graphed
from ..ops import sampling as sp
from ..ops.encode import check_encode_mode
from .fast import SymEncryptor

PARALLEL_COUNTER_STRIDE = 1 << 20
LAYOUTS = ("reference", "parallel")
ORDERS = ("forward", "reverse")


def _check(layout: str, order: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}")


def _stride(layout: str):
    return PARALLEL_COUNTER_STRIDE if layout == "parallel" else None


def _walk(parms: Parms, order: str) -> tuple[int, ...]:
    moduli = tuple(int(q) for q in parms.moduli)
    return moduli[::-1] if order == "reverse" else moduli


class LimbscanEncryptor(SymEncryptor):
    """sym_encrypt_limbscan for one parameter set, layout and order, with
    its tables resident on `device` (see EncryptorBase).  In reverse order
    the moduli, the NTT tables and the Barrett constants r0, r1 are held
    reversed, so every per-limb buffer is in walk order.

    forward(values, sk_signed, share_words, err_words) and
    encrypt_pte(pte, sk_signed, share_words, ok) as SymEncryptor's; c0
    and c1 are (L, B, n) in walk order.
    """

    def __init__(self, parms: Parms, layout: str = "reference",
                 order: str = "forward", device=CUDA):
        _check(layout, order)
        super().__init__(parms, device)
        self.layout = layout
        self.order = order
        if order == "reverse":
            self.moduli = self.moduli[::-1]
            for name in ("ntt_op", "ntt_quot", "q", "r0", "r1"):
                setattr(self, name, getattr(self, name).flip(0).contiguous())

    def draw_c1(self, share_words):
        return sp.sample_uniform_limbs(share_words, self.moduli,
                                       self.parms.degree, self.queue_cap,
                                       _stride(self.layout))


def sym_encrypt_from_pte(pte, sk_signed, share_words, parms: Parms,
                         layout: str = "reference", ok_in=None,
                         order: str = "forward"):
    """Integer-only symmetric encrypt from an already-encoded pte (int64
    (B, n)).  Returns a dict with c0, c1 (L, B, n) in walk order, pte and
    ok (B,)."""
    return LimbscanEncryptor(parms, layout, order, pte.device).encrypt_pte(
        pte, sk_signed, share_words, ok_in)


def sym_encrypt_limbscan(values, sk_signed, share_words, err_words,
                         parms: Parms, layout: str = "reference",
                         encode_mode: str = "f64", order: str = "forward"):
    """Batched symmetric encode + encrypt: encode (KE) and CBD error, then
    the limb pipeline.  Every encode_mode is the one bit-exact encode."""
    check_encode_mode(encode_mode)
    return LimbscanEncryptor(parms, layout, order, values.device)(
        values, sk_signed, share_words, err_words)


def expand_c1(share_words, parms: Parms, layout: str = "reference",
              order: str = "forward"):
    """Regenerate c1 from the 64-byte shareable seed: the receiver half of
    seed-expandable symmetric ciphertexts (SE_ENABLE_SYM_SEED_CT,
    seal_embedded.c:184-194).

    share_words: int64 (B, 16).  Returns (c1 int64 (L, B, n) in walk
    order, ok (B,)), the same draws as the encryptor of that layout.  The
    reference layout uses the sampler's default queue bound, as the JAX
    function does, so its ok is the JAX one.  The JAX function raises
    NameError for the parallel layout (it reads an undefined qcap); here
    that layout uses the encryptor's bound, queue_cap_for(n, moduli).
    """
    _check(layout, order)
    n = parms.degree
    cap = (sp.queue_cap_for(n, parms.moduli) if layout == "parallel"
           else None)
    return sp.sample_uniform_limbs(share_words, _walk(parms, order), n, cap,
                                   _stride(layout))


def add_cbd_error(pt, err_words, n: int):
    """pt + CBD error with counter 0 (ckks_sym_init, ckks_sym.c:181-197)."""
    e, _ = sp.sample_cbd(err_words, sp.counter_zero(pt.shape[:1], pt.device),
                         n)
    return pt + e


@lru_cache(maxsize=16)
def _limbscan(parms: Parms, layout: str, order: str,
              device: torch.device) -> LimbscanEncryptor:
    return LimbscanEncryptor(parms, layout, order, device)


@lru_cache(maxsize=16)
def _graphed_limbscan(parms: Parms, layout: str, order: str,
                      device: torch.device):
    return graphed(_limbscan(parms, layout, order, device), device)


def make_limbscan_encryptor(parms: Parms, layout: str = "reference",
                            encode_mode: str = "f64",
                            order: str = "forward", device=CUDA):
    """sym_encrypt_limbscan bound to its parameters and compiled per input
    signature on `device` (the card unless told otherwise), as the JAX
    factory's jitted function: (values, sk_signed, share_words, err_words)
    -> dict.  One LimbscanEncryptor per (parms, layout, order, device)."""
    _check(layout, order)
    check_encode_mode(encode_mode)
    return _graphed_limbscan(parms, layout, order, torch.device(device))


@lru_cache(maxsize=16)
def _graphed_expander(parms: Parms, layout: str, order: str,
                      device: torch.device):
    return graphed(partial(expand_c1, parms=parms, layout=layout,
                           order=order), device)


def make_c1_expander(parms: Parms, layout: str = "reference",
                     order: str = "forward", device=CUDA):
    """expand_c1 bound to its parameters and compiled per input signature
    on `device` (the card unless told otherwise): fn(share_words on
    `device`) -> (c1, ok)."""
    _check(layout, order)
    return _graphed_expander(parms, layout, order, torch.device(device))


@lru_cache(maxsize=16)
def _graphed_from_pte(parms: Parms, layout: str, device: torch.device):
    return graphed(_limbscan(parms, layout, "forward", device).encrypt_pte,
                   device)


def make_from_pte_encryptor(parms: Parms, layout: str = "reference",
                            device=CUDA):
    """sym_encrypt_from_pte bound to its parameters and compiled per input
    signature on `device` (the card unless told otherwise):
    fn(pte, sk_signed, share_words, ok=None) -> dict."""
    _check(layout, "forward")
    return _graphed_from_pte(parms, layout, torch.device(device))
