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
  key on with them; each limb runs KA on its row with that key.  Each
  limb carries the encode's and the ternary draw's flags apart; at the
  first limb the rows whose ternary queue fell short are encrypted again
  exactly (``asym.redo_overflowed``) and written into every limb before
  it is yielded.

The prologue and the steps run as a ``graphs.Chain``: on the card the
first call of an input signature captures the prologue's graph and one
graph per limb's step into one memory pool, each step writing its limb
into one of ``graphs.RING_SLOTS`` (two) slots in turn, and every call
replays them, the counterpart of the JAX package's jitted per-limb
step.  The compiled streams are cached per (parms, order, device)
(``sym_stream``, ``asym_stream``), the counterpart of its
``lru_cache(maxsize=16)`` on ``_limb_step`` and ``_asym_init``.

The host fetches limb i while the device computes limb i+1.  JAX got
that overlap from asynchronous dispatch, and bounded the device's share
by keeping two limbs in flight; here limb i's copies to pinned host
memory run on a side stream after the event limb i recorded on the
compute stream.  A stream queues every limb's copies at its first
next(), each right after its limb's graph, and the card waits for limb
i's copies before limb i+2 writes the same slot (never the host): the
card holds two limbs whatever the chain's length.  The host waits on
that limb's copy event only, never on the compute stream.  c0 and c1 travel
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

from ..config import ASYM, CUDA, Parms
from ..graphs import Chain, to_device
from ..io import serialize
from ..ops import keccak as kc
from ..ops import sampling as sp
from ..ops.encode import check_encode_mode
from ..utils import timing
from .asym import AsymEncryptor, key_tensor, redo_overflowed
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
        self.copy_stream = (torch.cuda.Stream(device=device)
                            if device.type == "cuda" else None)

    def start(self, prime_idx, q, parts, ready):
        """Queue one limb's copy (a ``fetch.queue`` span); returns the
        pending item, its copy event last.  parts: c0, c1 int32 (B, n) and
        ok (B,) bool, a stream's ring slot; ready: the event that ends
        them there (on a card).  Under the run's card clock the copy is
        marked (``dev.copy``) from the end of its wait for `ready` to its
        end."""
        with timing.span("fetch.queue"):
            if self.copy_stream is None:
                return prime_idx, q, parts, None
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


def _fetch(item, fix=None) -> dict:
    """Wait for one limb's copy (an item of _HostFetch.start) and return
    its dict; the host waits on that limb's copy event only, and its wait
    (``fetch.wait``) is the dict's wait_ms.  While it waits, it reads the
    card's intervals that have ended (timing.read_card_marks).  fix, where
    given (an asym call's _ExactRows), rewrites the limb's rows whose
    ternary queue fell short and gives the flags that remain.  The ok
    check and the host views are a ``fetch.view`` span."""
    prime_idx, q, (c0, c1, ok), done = item
    with timing.span("fetch.wait", timed=True) as wait:
        timing.read_card_marks()
        if done is not None:
            done.synchronize()
    if fix is not None:
        ok = fix(prime_idx, c0, c1, ok)
    with timing.span("fetch.view"):
        ok = bool(ok.numpy().all())
        if not ok:
            raise AssertionError(
                f"sampler overflow or encode overflow at prime {prime_idx}")
        return {"prime_idx": prime_idx, "q": q,
                "c0": c0.numpy().view(np.uint32),
                "c1": c1.numpy().view(np.uint32), "ok": ok,
                "wait_ms": 0.0 if done is None else wait.ms}


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
    form) on a LimbscanEncryptor whose per-limb buffers are in walk
    order."""

    def __init__(self, enc: LimbscanEncryptor):
        self.enc = enc
        self.nsteps = len(enc.moduli)

    def prologue(self, values, sk_signed, share_words, err_words):
        """ntt(s) of every limb, encode + CBD error (pt freed) and the
        share counter at 0: the hand-offs of the limb steps.  ntt(s) comes
        first: from L = 9 at n = 16384 its (L, n) int64 passes 1 MiB, and
        made after the encode's (B, n) temporaries were freed it would
        split one of them, so that each step's (B, n) scratch would need
        one block more of the pool."""
        ntt_s = self.enc.ntt_secret(sk_signed)                 # (L, n)
        pte, ok = self.enc.encode_with_error(values, err_words)[1:]
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

    def exact_rows(self, args):
        """The sym draw is exact: no rows to encrypt again."""
        return None


class _AsymSteps:
    """The asym stream's prologue and per-limb step on an AsymEncryptor
    whose buffers are in chain order; limb j of the walk is prime
    idxs[j]."""

    def __init__(self, enc: AsymEncryptor, idxs):
        self.enc = enc
        self.idxs = idxs
        self.nsteps = len(idxs)

    def prologue(self, values, pk0, pk1, seed_words):
        """Encode and the private stream's draws: pte, u, e1 (B, n) and
        the flags (B, 2) (the encode's ok, the ternary draw's), then the
        key (pk0, pk1 int64 (L, n)) with its quotients, all handed on to
        the limbs (so no state of the shared encryptor holds a caller's
        key)."""
        pte, u, e1, ok, ternary_ok = self.enc.draws(values, seed_words)[1:]
        return (pte, u, e1, torch.stack([ok, ternary_ok], dim=-1),
                self.enc.key(pk0, pk1))

    def step(self, j, carry, out=None):
        pte, u, e1, flags, key = carry
        i = self.idxs[j]
        c0, c1 = self.enc.combine(u, e1, pte, slice(i, i + 1), key)
        return carry, _host_form(c0[0], c1[0], flags, out)

    def exact_rows(self, args):
        """A call's _ExactRows; args: the prologue's (values, pk0, pk1,
        seed_words)."""
        return _ExactRows(self.enc, args)


class _ExactRows:
    """One asym call's limbs under asym.redo_overflowed: at its first
    limb the rows whose ternary queue fell short are encrypted again
    (host copies of their c0, c1 kept, int32 (L, r, n)); each limb's
    rows are then written from them before the limb is handed on, and the
    encode's flags are what the limb's ok check reads."""

    def __init__(self, enc: AsymEncryptor, args):
        self.enc = enc
        self.args = args
        self.rows = None

    def __call__(self, prime_idx, c0, c1, flags):
        """c0, c1 int32 (B, n), flags bool (B, 2), host tensors of limb
        `prime_idx`; returns its encode flags (B,)."""
        if self.rows is None:
            values, pk0, pk1, seed_words = self.args
            redo = redo_overflowed(self.enc, values, seed_words,
                                   lambda: self.enc.key(pk0, pk1),
                                   flags[:, 1].numpy())
            self.rows = ()
            if redo is not None:
                rows, fixed = redo
                self.rows = torch.as_tensor(rows)
                self.c0, self.c1 = (fixed[k].to(torch.int32).cpu()
                                    for k in ("c0", "c1"))
        if len(self.rows):
            c0[self.rows] = self.c0[prime_idx]
            c1[self.rows] = self.c1[prime_idx]
        return flags[:, 0]


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
        fix = self.steps.exact_rows(args)

        def start(j, parts, ready):
            item = fetch.start(*self.walk[j], parts, ready)
            return item, item[-1]
        return (_fetch(item, fix) for item in self.chain(args, start))

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
    sym_encrypt_stream, but for the ternary draw: rows whose bounded
    queue fell short are encrypted again exactly (asym.redo_overflowed)
    and written into every limb, so only an encode overflow raises.
    pk0/pk1: (L, n) u32 values in NTT form, tensors or arrays, moved to
    `device` as int64; the compiled stream of (parms, order, device)
    (asym_stream) hands them on as its key."""
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
    share_seeds unused; rows whose ternary draw's bounded queue fell
    short are encrypted again exactly at the first limb, a
    ``stream.redo`` span, and written into every limb before it is sent
    or returned: asym.redo_overflowed).  Both are cached per (parms,
    order, device), so a second call replays the chain the first one
    captured; the context
    notes the streams it used, and se_cleanup zeroes their copies of its
    keys.  The seeds are required: a missing list raises ValueError (the
    JAX function dies with a TypeError in its seed conversion).  The
    values and seed words reach the card through pinned host memory
    without the host waiting for the copies (graphs.to_device).  Returns the
    list of limb dicts.  The call is an ``api.call`` span, with the
    seeds' packing (``api.seed_pack``), each upload (``api.upload``), the
    chain's run (``chain.run``), each limb's fetch (``fetch.wait``,
    ``fetch.view``) and its sends (``api.send``) under it.
    """
    if err_seeds is None:
        raise ValueError("se_encrypt_streaming needs err_seeds, one 64-byte "
                         "private seed per message")
    if ctx.encrypt_type != ASYM and share_seeds is None:
        raise ValueError("symmetric se_encrypt_streaming needs share_seeds, "
                         "one 64-byte shareable seed per message")
    with timing.span("api.call", root=True):
        ctx.resolved_encode_mode()
        dev = ctx.device
        vals = to_device(
            np.atleast_2d(np.asarray(values, dtype=np.float32)), dev)
        err_w = to_device(kc.seed_words(err_seeds), dev)
        if ctx.encrypt_type == ASYM:
            if ctx._pk is None:
                raise ValueError("asym streaming needs a loaded pk")
            stream = asym_stream(ctx.parms, order, dev)
            gen = stream(vals, *ctx._pk, err_w)
        else:
            if ctx._sk is None:
                raise ValueError("sym streaming needs the secret key")
            stream = sym_stream(ctx.parms, order, dev)
            gen = stream(vals, ctx._sk,
                         to_device(kc.seed_words(share_seeds), dev), err_w)
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
