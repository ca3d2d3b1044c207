"""Per-prime streaming encryption — the reference's core operating mode.

Port of ``seal_embedded_tpu/ckks/stream.py``.  The reference generates
and transmits ONE ciphertext RNS component at a time
(seal_embedded.c:145-213: encrypt prime i, send c0/c1, advance the
modulus), bounding device memory at O(n) instead of O(L*n).  Here the
prologue (encode, error draws) runs once, then each limb is one step of
the port's kernels at (1, B, n):

* sym: the uniform draw for the limb's prime with the sampler counter
  carried from limb to limb, then KN from pte with the c0 epilogue (pte
  reduced by the limb's prime as KN loads it), on a ``LimbscanEncryptor``
  whose per-limb buffers are in walk order (reversed for
  ``order="reverse"``);
* asym: KA on the limb's row of the ``AsymEncryptor`` buffers, after its
  encode + ternary + CBD prologue.

The host fetches limb i while the device computes limb i+1.  JAX got
that overlap from asynchronous dispatch; here every kernel runs on the
caller's CUDA stream, and limb i's copies to pinned host memory run on a
side stream after an event limb i recorded.  The host waits on that
limb's copy event only, never on the compute stream.  c0 and c1 travel
as int32 (every prime is below 2^31), with the ok flags in the same
copy, and are viewed as uint32 on the host.  Each limb lands in pinned
buffers of its own, so a yielded array is never overwritten by a later
limb.  On CPU tensors the same steps run the kernels' plain versions and
the limbs are yielded as computed.

Bit-exact with the limb-scan pipeline (same sampler counter chaining).
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..config import Parms
from ..ops import sampling as sp
from ..ops.encode import check_encode_mode
from .asym import AsymEncryptor
from .fast import SymEncryptor
from .limbwise import ORDERS, LimbscanEncryptor


def _walk(nprimes: int, order: str) -> list[int]:
    """Chain indices in walk order."""
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}")
    idxs = list(range(nprimes))
    return idxs[::-1] if order == "reverse" else idxs


class _HostFetch:
    """Brings each limb's c0, c1 and ok to host memory.  On a CUDA device
    the copies go to fresh pinned buffers on a side stream, after an event
    recorded on the compute stream; on the CPU nothing is copied."""

    def __init__(self, device: torch.device):
        self.device = device
        self.copy_stream = (torch.cuda.Stream(device=device)
                            if device.type == "cuda" else None)

    def start(self, prime_idx, q, c0, c1, ok):
        """Queue one limb's copy; returns the pending item.  c0, c1 (B, n)
        int64 u32 values, ok (B,) bool, all on the compute stream."""
        parts = (c0.to(torch.int32), c1.to(torch.int32), ok)
        if self.copy_stream is None:
            return prime_idx, q, parts, None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in parts)
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(ready)
            for h, t in zip(host, parts):
                h.copy_(t, non_blocking=True)
                # Made on the compute stream, read here: the allocator
                # must not hand the memory out again before the copy ends.
                t.record_stream(self.copy_stream)
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        return prime_idx, q, host, done


def _fetch(item) -> dict:
    """Wait for one limb's copy (an item of _HostFetch.start) and return
    its dict; the host waits on that limb's copy event only."""
    prime_idx, q, (c0, c1, ok), done = item
    wait_ms = 0.0
    if done is not None:
        t0 = time.perf_counter()
        done.synchronize()
        wait_ms = (time.perf_counter() - t0) * 1e3
    ok = bool(ok.numpy().all())
    if not ok:
        raise AssertionError(
            f"sampler overflow or encode overflow at prime {prime_idx}")
    return {"prime_idx": prime_idx, "q": q,
            "c0": c0.numpy().view(np.uint32),
            "c1": c1.numpy().view(np.uint32), "ok": ok,
            "wait_ms": wait_ms}


def _pipeline(limbs, device: torch.device) -> Iterator[dict]:
    """Drive a generator of per-limb device results, keeping one limb in
    flight: limb i is fetched only after limb i+1 has been queued."""
    fetch = _HostFetch(device)
    pending = []
    for item in limbs:
        pending.append(fetch.start(*item))
        del item    # the int64 limb is freed while the next one computes
        if len(pending) > 1:
            yield _fetch(pending.pop(0))
    while pending:
        yield _fetch(pending.pop(0))


def _sym_limbs(enc: SymEncryptor, idxs, values, sk_signed, share_words,
               err_words):
    """(prime_idx, q, c0, c1, ok) per limb; enc's per-limb buffers are in
    the walk order of idxs."""
    n = enc.parms.degree
    pte, ok_enc = enc.encode_with_error(values, err_words)[1:]  # pt freed
    ntt_s = enc.ntt_secret(sk_signed)                      # (L, n)
    counter = sp.counter_zero((values.shape[0],), values.device)
    for j, prime_idx in enumerate(idxs):
        q = enc.moduli[j]
        limb = slice(j, j + 1)
        a, counter, ok_u = sp.sample_uniform(share_words, counter, n, q,
                                             queue_cap=enc.queue_cap)
        c0 = enc.c0_from_pte(pte, a[None], ntt_s[limb], limb)
        yield prime_idx, q, c0[0], a, ok_enc & ok_u
        # Only the fetch's int32 copies outlive the limb, so the next
        # limb's draw runs with less memory held than the batch's does.
        del a, c0


def _asym_limbs(enc: AsymEncryptor, idxs, values, seed_words):
    """(prime_idx, q, c0, c1, ok) per limb, enc's buffers in chain order."""
    _, pte, u, e1, ok = enc.prologue(values, seed_words)
    for i in idxs:
        c0, c1 = enc.combine(u, e1, pte, slice(i, i + 1))
        yield i, enc.moduli[i], c0[0], c1[0], ok


def _device(values, device) -> torch.device:
    return values.device if device is None else torch.device(device)


def sym_stream_with(enc: SymEncryptor, values, sk_signed, share_words,
                    err_words, order: str = "forward") -> Iterator[dict]:
    """sym_encrypt_stream on a prebuilt encryptor whose per-limb buffers
    are in the walk order of `order` (a SymEncryptor for "forward", a
    reverse LimbscanEncryptor for "reverse"); inputs on its device."""
    idxs = _walk(enc.parms.nprimes, order)
    if enc.moduli != tuple(int(enc.parms.moduli[i]) for i in idxs):
        raise ValueError(f"the encryptor's limbs are not in {order} order")
    return _pipeline(_sym_limbs(enc, idxs, values, sk_signed, share_words,
                                err_words), values.device)


def asym_stream_with(enc: AsymEncryptor, values, seed_words,
                     order: str = "forward") -> Iterator[dict]:
    """asym_encrypt_stream on a prebuilt encryptor (its pk included)."""
    idxs = _walk(enc.parms.nprimes, order)
    return _pipeline(_asym_limbs(enc, idxs, values, seed_words),
                     values.device)


def sym_encrypt_stream(values, sk_signed, share_words, err_words,
                       parms: Parms, encode_mode: str = "f64",
                       order: str = "forward",
                       device=None) -> Iterator[dict]:
    """Yields one dict per prime, in chain-walk order:
    {"prime_idx", "q", "c0", "c1", "ok", "wait_ms"} with c0/c1 uint32
    (B, n) numpy arrays that own their memory; "ok" folds the encode
    overflow flag with that limb's sampler-queue flag (an overflow raises
    AssertionError at that limb, as in the JAX package); "wait_ms" is the
    host's wait for that limb's copy (0 on the CPU).

    values f32 (B, <= n/2), sk_signed (n,) in {-1, 0, 1}, share/err words
    int64 (B, 16), moved to `device` (default: values' device).  Every
    encode_mode is the one bit-exact encode.  The device runs one limb
    ahead of the host fetch.
    """
    check_encode_mode(encode_mode)
    _walk(parms.nprimes, order)
    dev = _device(values, device)
    enc = LimbscanEncryptor(parms, "reference", order, dev)
    return sym_stream_with(enc, *(t.to(dev) for t in (
        values, sk_signed, share_words, err_words)), order=order)


def asym_encrypt_stream(values, pk0, pk1, seed_words, parms: Parms,
                        encode_mode: str = "f64",
                        order: str = "forward",
                        device=None) -> Iterator[dict]:
    """Per-prime streaming asymmetric encrypt; same contract as
    sym_encrypt_stream.  pk0/pk1: int64 (L, n) u32 values in NTT form,
    moved to `device` with their Shoup quotients once."""
    check_encode_mode(encode_mode)
    _walk(parms.nprimes, order)
    dev = _device(values, device)
    enc = AsymEncryptor(parms, pk0.to(dev), pk1.to(dev), dev)
    return asym_stream_with(enc, values.to(dev), seed_words.to(dev), order)


def se_encrypt_streaming(ctx, values, share_seeds=None, err_seeds=None,
                         send: Optional[Callable[[bytes], int]] = None,
                         order: str = "forward"):
    """API-level streaming encrypt: send c0/c1 bytes per prime as produced
    (the reference's send-per-prime loop, seal_embedded.c:180-204).

    Symmetric contexts stream through a LimbscanEncryptor of the context's
    parameters in the walk order (share_seeds = the shareable stream,
    err_seeds = the private stream); asymmetric ones through an
    AsymEncryptor of the context's pk (err_seeds = the private stream
    sampling u/e0/e1; share_seeds unused).  Streams run eagerly: the
    context's compiled batch encryptor is not used.  The seeds are required:
    a missing list raises ValueError (the JAX function dies with a
    TypeError in its seed conversion).  Returns the list of limb dicts.
    """
    from ..api import ASYM, _seed_words_batch
    from ..io import serialize

    if err_seeds is None:
        raise ValueError("se_encrypt_streaming needs err_seeds, one 64-byte "
                         "private seed per message")
    if ctx.encrypt_type != ASYM and share_seeds is None:
        raise ValueError("symmetric se_encrypt_streaming needs share_seeds, "
                         "one 64-byte shareable seed per message")
    ctx.resolved_encode_mode()
    dev = ctx.device
    vals = torch.as_tensor(
        np.atleast_2d(np.asarray(values, dtype=np.float32)), device=dev)
    err_w = _seed_words_batch(err_seeds, dev)
    if ctx.encrypt_type == ASYM:
        if ctx._pk is None:
            raise ValueError("asym streaming needs a loaded pk")
        gen = asym_stream_with(AsymEncryptor(ctx.parms, *ctx._pk, dev), vals,
                               err_w, order)
    else:
        if ctx._sk is None:
            raise ValueError("sym streaming needs the secret key")
        enc = LimbscanEncryptor(ctx.parms, "reference", order, dev)
        gen = sym_stream_with(enc, vals, ctx._sk,
                              _seed_words_batch(share_seeds, dev), err_w,
                              order)
    out = []
    for limb in gen:
        if send is not None:
            for b in range(vals.shape[0]):
                send(serialize.ct_component_bytes(limb["c0"][b]))
                send(serialize.ct_component_bytes(limb["c1"][b]))
        out.append(limb)
    return out
