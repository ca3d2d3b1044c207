"""Per-prime streaming encryption — the reference's core operating mode.

Port of ``seal_embedded_tpu/ckks/stream.py``.  The reference generates
and transmits ONE ciphertext RNS component at a time
(seal_embedded.c:145-213: encrypt prime i, send c0/c1, advance the
modulus), bounding device memory at O(n) instead of O(L*n).  Here the
prologue (encode, error draws) runs once, then each limb is one step of
the port's kernels at (1, B, n):

* sym: the prologue encodes, adds the CBD error and takes ntt(s); each
  limb draws its uniform a with the sampler counter carried from limb to
  limb, then runs KN from pte with the c0 epilogue (pte reduced by the
  limb's prime as KN loads it), on a ``LimbscanEncryptor`` whose
  per-limb buffers are in walk order (reversed for ``order="reverse"``);
* asym: the prologue runs the encode + ternary + CBD draws of an
  ``AsymEncryptor`` and computes the key's Shoup quotients, handing the
  key on with them; each limb runs KA on its row with that key.

The prologue and the steps run as a ``graphs.Chain``: on the card the
first call of an input signature captures the prologue's graph and one
graph per limb's step into one memory pool, each step writing its limb
into one of ``graphs.RING_SLOTS`` (two) slots in turn, and every call
replays them, the counterpart of the JAX package's jitted per-limb
step.  The compiled streams are cached per (parms, order, device)
(``sym_stream``, ``asym_stream``), the counterpart of its
``lru_cache(maxsize=16)`` on ``_limb_step`` and ``_asym_init``.
``sym_stream_with`` and ``asym_stream_with`` run the same steps eagerly
on a prebuilt encryptor.

The host fetches limb i while the device computes limb i+1.  JAX got
that overlap from asynchronous dispatch, and bounded the device's share
by keeping two limbs in flight; here limb i's copies to pinned host
memory run on a side stream after the event limb i recorded on the
compute stream.  A compiled stream queues every limb's copies at its
first next(), each right after its limb's graph, and the card waits for
limb i's copies before limb i+2 writes the same slot (never the host):
the card holds two limbs whatever the chain's length.  An eager one
queues limb i's copies once limb i+1 is queued.  The host waits on that
limb's copy event only, never on the compute stream.  c0 and c1 travel
as int32 (every prime is below 2^31), with the ok flags in the same
copy, and are viewed as uint32 on the host.  Each limb lands in pinned
buffers of its own, so a yielded array is never overwritten by a later
limb.  On CPU tensors the same steps run the kernels' plain versions
and the limbs are yielded as computed.

Bit-exact with the limb-scan pipeline (same sampler counter chaining).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..config import Parms
from ..convert import CUDA
from ..graphs import Chain, eager_chain, to_device
from ..ops import sampling as sp
from ..ops.encode import check_encode_mode
from ..utils import timing
from .asym import AsymEncryptor, key_tensor
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
    the copies go to fresh pinned buffers on a side stream, after the
    limb's event; on the CPU nothing is copied."""

    def __init__(self, device: torch.device):
        self.device = device
        self.copy_stream = (torch.cuda.Stream(device=device)
                            if device.type == "cuda" else None)

    def start(self, prime_idx, q, parts, ready=None):
        """Queue one limb's copy (a ``fetch.queue`` span); returns the
        pending item, its copy event last.  parts: c0, c1 int32 (B, n) and
        ok (B,) bool; ready: the event that ends them in a compiled
        stream's ring slot, None for tensors just made on the compute
        stream.  Under the run's card clock the copy is marked
        (``dev.copy``) from the end of its wait for `ready` to its end."""
        with timing.span("fetch.queue"):
            if self.copy_stream is None:
                return prime_idx, q, parts, None
            if ready is None:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
                for t in parts:
                    # Made on the compute stream, read on the side stream:
                    # the allocator must not hand the memory out again
                    # before the copy ends.
                    t.record_stream(self.copy_stream)
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in parts)
            clock = timing.current_clock()
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(ready)
                if clock:
                    begin = clock.event(self.copy_stream)
                for h, t in zip(host, parts):
                    h.copy_(t, non_blocking=True)
                if clock:
                    done = clock.event(self.copy_stream)
                    clock.mark("dev.copy", begin, done)
                else:
                    done = torch.cuda.Event()
                    done.record(self.copy_stream)
            return prime_idx, q, host, done


def _fetch(item) -> dict:
    """Wait for one limb's copy (an item of _HostFetch.start) and return
    its dict; the host waits on that limb's copy event only, and its wait
    (``fetch.wait``) is the dict's wait_ms.  While it waits, it reads the
    card's intervals that have ended (timing.read_card_marks).  The ok
    check and the host views are a ``fetch.view`` span."""
    prime_idx, q, (c0, c1, ok), done = item
    with timing.span("fetch.wait", timed=True) as wait:
        timing.read_card_marks()
        if done is not None:
            done.synchronize()
    with timing.span("fetch.view"):
        ok = bool(ok.numpy().all())
        if not ok:
            raise AssertionError(
                f"sampler overflow or encode overflow at prime {prime_idx}")
        return {"prime_idx": prime_idx, "q": q,
                "c0": c0.numpy().view(np.uint32),
                "c1": c1.numpy().view(np.uint32), "ok": ok,
                "wait_ms": 0.0 if done is None else wait.ms}


def _pipeline(outs, walk, device: torch.device) -> Iterator[dict]:
    """Drive an iterator of per-limb (c0, c1, ok) device results, the
    limbs of `walk` ((prime_idx, q) each) in turn, keeping one limb in
    flight: limb i is fetched only after limb i+1 has been queued (the
    eager stream)."""
    fetch = _HostFetch(device)
    pending = []
    for (prime_idx, q), parts in zip(walk, outs):
        pending.append(fetch.start(prime_idx, q, parts))
        del parts   # the limb's device copy is freed once fetched
        if len(pending) > 1:
            yield _fetch(pending.pop(0))
    while pending:
        yield _fetch(pending.pop(0))


def _host_form(c0, c1, ok, out=None):
    """A limb's outputs as the fetch carries them: c0, c1 (B, n) u32
    values as int32, ok (B,) bool; written into `out` (a compiled
    stream's ring slot) where it is given."""
    if out is None:
        return c0.to(torch.int32), c1.to(torch.int32), ok
    for dst, src in zip(out, (c0, c1, ok)):
        dst.copy_(src)
    return out


class _SymSteps:
    """The sym stream's prologue and per-limb step (graphs.eager_chain's
    form) on a SymEncryptor whose per-limb buffers are in walk order."""

    def __init__(self, enc: SymEncryptor):
        self.enc = enc
        self.nsteps = len(enc.moduli)

    def prologue(self, values, sk_signed, share_words, err_words):
        """Encode + CBD error (pt freed), ntt(s) of every limb and the
        share counter at 0: the hand-offs of the limb steps."""
        pte, ok = self.enc.encode_with_error(values, err_words)[1:]
        ntt_s = self.enc.ntt_secret(sk_signed)                 # (L, n)
        counter = sp.counter_zero((values.shape[0],), values.device)
        return pte, ok, ntt_s, share_words, counter

    def step(self, j, carry, out=None):
        """Limb j of the walk: its uniform draw from the counter the limb
        before left, then KN from pte with the c0 epilogue, its int32
        host forms written into `out` where given (see graphs.eager_chain).
        Only those outlive the step, so each limb's draw runs with less
        memory held than the batch's does."""
        pte, ok, ntt_s, share_words, counter = carry
        enc = self.enc
        limb = slice(j, j + 1)
        a, counter, ok_u = sp.sample_uniform(
            share_words, counter, enc.parms.degree, enc.moduli[j],
            queue_cap=enc.queue_cap)
        c0 = enc.c0_from_pte(pte, a[None], ntt_s[limb], limb)
        return ((pte, ok, ntt_s, share_words, counter),
                _host_form(c0[0], a, ok & ok_u, out))

class _AsymSteps:
    """The asym stream's prologue and per-limb step on an AsymEncryptor
    whose buffers are in chain order; limb j of the walk is prime
    idxs[j]."""

    def __init__(self, enc: AsymEncryptor, idxs):
        self.enc = enc
        self.idxs = idxs
        self.nsteps = len(idxs)

    def prologue(self, values, pk0, pk1, seed_words):
        """Encode and the private stream's draws: pte, u, e1 (B, n) and ok
        (B,), then the key (pk0, pk1 int64 (L, n)) with its quotients, all
        handed on to the limbs (so no state of the shared encryptor
        holds a caller's key)."""
        return (*self.enc.prologue(values, seed_words)[1:],
                self.enc.key(pk0, pk1))

    def step(self, j, carry, out=None):
        pte, u, e1, ok, key = carry
        i = self.idxs[j]
        c0, c1 = self.enc.combine(u, e1, pte, slice(i, i + 1), key)
        return carry, _host_form(c0[0], c1[0], ok, out)


class Stream:
    """One stream kind on one (parms, order, device): its steps compiled
    as a graphs.Chain.  Called with the prologue's tensors (on `device`),
    it returns the iterator of limb dicts (sym_encrypt_stream's)."""

    def __init__(self, steps, walk, device):
        self.steps = steps
        self.walk = walk
        self.chain = Chain(steps.prologue, steps.step, steps.nsteps, device)

    def __call__(self, *args) -> Iterator[dict]:
        fetch = _HostFetch(self.chain.device)

        def start(j, parts, ready):
            item = fetch.start(*self.walk[j], parts, ready)
            return item, item[-1]
        return map(_fetch, self.chain(args, start))

    def scrub(self) -> None:
        """Zero every copy of a caller's key the stream keeps: the chain's
        static inputs and hand-offs (ntt(s), or pk and its quotients)."""
        self.chain.scrub()


def _limbs(parms: Parms, idxs) -> list[tuple[int, int]]:
    return [(i, int(parms.moduli[i])) for i in idxs]


@lru_cache(maxsize=16)
def _sym_stream(parms: Parms, order: str, device: torch.device) -> Stream:
    idxs = _walk(parms.nprimes, order)
    steps = _SymSteps(LimbscanEncryptor(parms, "reference", order, device))
    return Stream(steps, _limbs(parms, idxs), device)


@lru_cache(maxsize=16)
def _asym_stream(parms: Parms, order: str, device: torch.device) -> Stream:
    idxs = _walk(parms.nprimes, order)
    steps = _AsymSteps(AsymEncryptor(parms, device=device), idxs)
    return Stream(steps, _limbs(parms, idxs), device)


def sym_stream(parms: Parms, order: str = "forward", device=CUDA) -> Stream:
    """The compiled sym stream of (parms, order) on `device` (the card
    unless told otherwise), one per (parms, order, device):
    fn(values, sk_signed, share_words, err_words), all on `device`, ->
    sym_encrypt_stream's iterator of limb dicts."""
    return _sym_stream(parms, order, torch.device(device))


def asym_stream(parms: Parms, order: str = "forward", device=CUDA) -> Stream:
    """The compiled asym stream of (parms, order) on `device`, one per
    (parms, order, device), the key given per call as the prologue's
    input: fn(values, pk0, pk1, seed_words), all on `device`, pk int64
    (L, n) -> the iterator of limb dicts."""
    return _asym_stream(parms, order, torch.device(device))


def _device(values, device) -> torch.device:
    return values.device if device is None else torch.device(device)


def sym_stream_with(enc: SymEncryptor, values, sk_signed, share_words,
                    err_words, order: str = "forward") -> Iterator[dict]:
    """sym_encrypt_stream run eagerly on a prebuilt encryptor whose
    per-limb buffers are in the walk order of `order` (a SymEncryptor for
    "forward", a reverse LimbscanEncryptor for "reverse"); inputs on its
    device."""
    idxs = _walk(enc.parms.nprimes, order)
    if enc.moduli != tuple(int(enc.parms.moduli[i]) for i in idxs):
        raise ValueError(f"the encryptor's limbs are not in {order} order")
    steps = _SymSteps(enc)
    return _pipeline(eager_chain(steps.prologue, steps.step, steps.nsteps,
                                 (values, sk_signed, share_words, err_words)),
                     _limbs(enc.parms, idxs), values.device)


def asym_stream_with(enc: AsymEncryptor, values, seed_words,
                     order: str = "forward") -> Iterator[dict]:
    """asym_encrypt_stream run eagerly on a prebuilt encryptor (its pk
    included)."""
    idxs = _walk(enc.parms.nprimes, order)
    steps = _AsymSteps(enc, idxs)
    return _pipeline(eager_chain(steps.prologue, steps.step, steps.nsteps,
                                 (values, enc.pk0, enc.pk1, seed_words)),
                     _limbs(enc.parms, idxs), values.device)


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
    encode_mode is the one bit-exact encode.  Runs the compiled stream of
    (parms, order, device) (sym_stream); the device runs one limb ahead of
    the host fetch.
    """
    check_encode_mode(encode_mode)
    dev = _device(values, device)
    return sym_stream(parms, order, dev)(*(to_device(t, dev) for t in (
        values, sk_signed, share_words, err_words)))


def asym_encrypt_stream(values, pk0, pk1, seed_words, parms: Parms,
                        encode_mode: str = "f64",
                        order: str = "forward",
                        device=None) -> Iterator[dict]:
    """Per-prime streaming asymmetric encrypt; same contract as
    sym_encrypt_stream.  pk0/pk1: (L, n) u32 values in NTT form, tensors
    or arrays, moved to `device` as int64; the compiled stream of (parms,
    order, device) (asym_stream) hands them on as its key."""
    check_encode_mode(encode_mode)
    dev = _device(values, device)
    return asym_stream(parms, order, dev)(
        to_device(values, dev), key_tensor(pk0, dev), key_tensor(pk1, dev),
        to_device(seed_words, dev))


def se_encrypt_streaming(ctx, values, share_seeds=None, err_seeds=None,
                         send: Optional[Callable[[bytes], int]] = None,
                         order: str = "forward"):
    """API-level streaming encrypt: send c0/c1 bytes per prime as produced
    (the reference's send-per-prime loop, seal_embedded.c:180-204).

    Symmetric contexts run the compiled sym stream of the context's
    parameters and walk order with its secret key (share_seeds = the
    shareable stream, err_seeds = the private stream); asymmetric ones the
    compiled asym stream with its public key as the key handed on in the
    prologue (err_seeds = the private stream sampling u/e0/e1;
    share_seeds unused).  Both are cached per (parms, order, device), so
    a second call replays the chain the first one captured; the context
    notes the streams it used, and se_cleanup zeroes their copies of its
    keys.  The seeds are required: a missing list raises ValueError (the
    JAX function dies with a TypeError in its seed conversion).  Returns
    the list of limb dicts.  The call is an ``api.call`` span, with the
    seeds' packing (``api.seed_pack``), each upload (``api.upload``), the
    chain's run (``chain.run``), each limb's fetch (``fetch.wait``,
    ``fetch.view``) and its sends (``api.send``) under it.
    """
    from ..api import ASYM, _seed_words_batch
    from ..io import serialize

    if err_seeds is None:
        raise ValueError("se_encrypt_streaming needs err_seeds, one 64-byte "
                         "private seed per message")
    if ctx.encrypt_type != ASYM and share_seeds is None:
        raise ValueError("symmetric se_encrypt_streaming needs share_seeds, "
                         "one 64-byte shareable seed per message")
    with timing.span("api.call", root=True):
        ctx.resolved_encode_mode()
        dev = ctx.device
        values = np.atleast_2d(np.asarray(values, dtype=np.float32))
        with timing.span("api.upload"):
            vals = to_device(values, dev)
        err_w = _seed_words_batch(err_seeds, dev)
        if ctx.encrypt_type == ASYM:
            if ctx._pk is None:
                raise ValueError("asym streaming needs a loaded pk")
            stream = asym_stream(ctx.parms, order, dev)
            gen = stream(vals, *ctx._pk, err_w)
        else:
            if ctx._sk is None:
                raise ValueError("sym streaming needs the secret key")
            stream = sym_stream(ctx.parms, order, dev)
            gen = stream(vals, ctx._sk, _seed_words_batch(share_seeds, dev),
                         err_w)
        ctx._streams.add(stream)
        out = []
        for limb in gen:
            if send is not None:
                with timing.span("api.send"):
                    for b in range(vals.shape[0]):
                        send(serialize.ct_component_bytes(limb["c0"][b]))
                        send(serialize.ct_component_bytes(limb["c1"][b]))
            out.append(limb)
        return out
