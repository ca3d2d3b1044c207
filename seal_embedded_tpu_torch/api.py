"""Public API: the seal_embedded.h surface on torch.

Port of ``seal_embedded_tpu/api.py``.  Mirrors the reference's public API
(device/lib/seal_embedded.{h,c}: se_setup[_custom,_default],
se_encrypt[_seeded], se_cleanup) with a batched implementation.  The
reference's SEND_FNCT_PTR network seam (seal_embedded.h:61-65) maps to a
per-component callback invoked with the serialized bytes of each RNS
component as it is produced.

A context lives on one ``device``, an explicit argument of ``se_setup*``
that defaults to ``cuda`` (which raises where there is no card; the tests
pass ``"cpu"``).  Setting up takes the compiled factories the JAX API
calls, ``make_fused_encryptor`` for symmetric contexts and
``make_fused_asym_encryptor`` (the context's pk passed per call) for
asymmetric ones: on the card each call replays a CUDA graph captured at
the first call of its shape (``graphs.py``).

Where the JAX package's API differs, on purpose:

* ``encode_mode="auto"`` resolves to ``"f64"`` on every device; every
  mode is the one bit-exact encode (the JAX package resolves it to the
  TPU's ``"dd"``, which is not bit-exact).
* ``se_setup_custom`` copies the caller's secret key, and ``se_cleanup``
  zeroes only the context's own copies, host arrays and device tensors
  (the JAX package zeroes the array the caller passed in).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from functools import lru_cache
from typing import Callable, Optional

import numpy as np
import torch

from .ckks.asym import gen_pk_batch, make_fused_asym_encryptor
from .ckks.fast import make_fused_encryptor
from .ckks.sym import make_decryptor
from .config import Parms, default_parms
from .convert import CUDA, pk_to_device, unpack_ternary
from .graphs import allocate, graphed, to_device
from .io import serialize
from .ops import keccak as kc
from .ops.encode import check_encode_mode, make_decoder
from .utils import timing

SYM = "sym"
ASYM = "asym"


@dataclasses.dataclass
class SEContext:
    """Equivalent of SE_PARMS: parameters, key material and the compiled
    encryptor for them on `device`.

    sk_signed ({-1,0,1} int32 (n,)) and pk0/pk1 (u32 (L, n), NTT form) are
    the context's own host copies; _sk is the secret key and _pk the
    public key (int64) on the device; _streams the compiled streams
    se_encrypt_streaming ran for it.  encode_mode: 'auto' (= 'f64') or
    one of 'sf', 'f64', 'dd', all the same bit-exact encode.
    """
    parms: Parms
    encrypt_type: str
    device: torch.device = CUDA
    sk_signed: Optional[np.ndarray] = None
    pk0: Optional[np.ndarray] = None
    pk1: Optional[np.ndarray] = None
    encode_mode: str = "auto"
    _sk: Optional[torch.Tensor] = None
    _pk: Optional[tuple] = None
    _sym_fn: Optional[Callable] = None
    _asym_fn: Optional[Callable] = None
    _streams: set = dataclasses.field(default_factory=set)

    @property
    def degree(self) -> int:
        return self.parms.degree

    def resolved_encode_mode(self) -> str:
        if self.encode_mode == "auto":
            return "f64"
        check_encode_mode(self.encode_mode)
        return self.encode_mode


def _seed_words_batch(seeds: list[bytes], device=None) -> torch.Tensor:
    """64-byte seeds -> int64 (B, 16) u32 words on `device` (an eager
    upload, graphs.to_device)."""
    with timing.span("api.seed_pack"):
        words = np.stack([kc.seed_to_words(s) for s in seeds]
                         ).astype(np.int64)
    with timing.span("api.upload"):
        return to_device(words, device)


def _to_host_u32(t: torch.Tensor) -> np.ndarray:
    """Canonical u32 values (< q < 2^31) held in int64 -> a uint32 numpy
    array; the copy travels as int32, half the bytes (the cast an eager
    allocation on t's device, graphs.allocate)."""
    return allocate(lambda: t.to(torch.int32), t.device,
                    t.numel() * 4).cpu().numpy().view(np.uint32)


def sample_sk_from_seed(parms: Parms, seed: bytes) -> np.ndarray:
    """Deterministic ternary secret key from a 64-byte seed, identical to the
    reference's sample_s path (ckks_sym.c:162-179)."""
    from .golden.prng import Prng
    from .golden.sampling import sample_small_poly_ternary_96, ternary_signed
    packed = sample_small_poly_ternary_96(parms.degree, Prng(seed))
    return np.array(ternary_signed(packed, parms.degree), dtype=np.int32)


def _make_context(parms: Parms, encrypt_type: str, device,
                  sk_signed=None, pk0=None, pk1=None,
                  encode_mode: str = "auto") -> SEContext:
    """A context holding its own copies of the key material, with the keys
    uploaded to `device` and its compiled encryptor."""
    if encrypt_type not in (SYM, ASYM):
        raise ValueError(f"unknown encrypt type {encrypt_type!r}")
    if encode_mode != "auto":
        check_encode_mode(encode_mode)
    device = torch.device(device)
    ctx = SEContext(parms=parms, encrypt_type=encrypt_type, device=device,
                    encode_mode=encode_mode)
    if sk_signed is not None:
        ctx.sk_signed = np.array(sk_signed, dtype=np.int32)
        ctx._sk = to_device(ctx.sk_signed.astype(np.int64), device)
    if encrypt_type == ASYM:
        if pk0 is None or pk1 is None:
            raise ValueError("an asymmetric context needs pk0 and pk1")
        ctx.pk0 = np.array(pk0, dtype=np.uint32)
        ctx.pk1 = np.array(pk1, dtype=np.uint32)
        ctx._pk = pk_to_device(ctx.pk0, ctx.pk1, device)
        ctx._asym_fn = make_fused_asym_encryptor(
            parms, ctx.resolved_encode_mode(), device)
    else:
        ctx._sym_fn = make_fused_encryptor(parms, ctx.resolved_encode_mode(),
                                           device)
    return ctx


def se_setup_custom(degree: int, nprimes: int, scale: float,
                    encrypt_type: str = SYM,
                    sk: Optional[np.ndarray] = None,
                    sk_seed: Optional[bytes] = None,
                    sk_path: Optional[str] = None,
                    pk_dir: Optional[str] = None,
                    pk_seed: Optional[bytes] = None,
                    encode_mode: str = "auto",
                    device=CUDA) -> SEContext:
    """se_setup_custom equivalent (seal_embedded.c:24-83).

    Secret key sources (priority): explicit `sk` ({-1,0,1} array, copied),
    `sk_seed` (sampled like the reference), `sk_path` (2-bit packed .dat
    file).  For asym, the pk loads from `pk_dir` (.dat files, NTT form) or
    is generated on `device` from sk + pk_seed (gen_pk_batch).
    """
    parms = default_parms(degree, nprimes, scale)
    n = degree
    sk_signed = None
    if sk is not None:
        sk_signed = np.asarray(sk)
    elif sk_seed is not None:
        sk_signed = sample_sk_from_seed(parms, sk_seed)
    elif sk_path is not None:
        sk_signed = unpack_ternary(serialize.read_sk(sk_path, n), n)

    pk0 = pk1 = None
    if encrypt_type == ASYM:
        if pk_dir is not None:
            pk0, pk1 = (np.stack([serialize.read_pk_component(pk_dir, j, n, q)
                                  for q in parms.moduli]) for j in (0, 1))
        else:
            if sk_signed is None:
                raise ValueError("need sk to generate pk")
            from .golden.prng import Prng
            from .golden.sampling import sample_poly_cbd_16
            seed = pk_seed or os.urandom(64)
            ep_seed = hashlib.shake_256(seed + b"ep").digest(64)
            ep = np.array(sample_poly_cbd_16(n, Prng(ep_seed)), dtype=np.int64)
            pk = gen_pk_batch(
                to_device(np.asarray(sk_signed, np.int64), device),
                to_device(kc.seed_to_words(seed).astype(np.int64), device),
                to_device(ep, device), parms)
            pk0, pk1 = (_to_host_u32(p) for p in pk)
    return _make_context(parms, encrypt_type, device, sk_signed, pk0, pk1,
                         encode_mode)


def se_setup(degree: int = 4096, nprimes: int = 3,
             scale: float | None = None, encrypt_type: str = SYM,
             **kw) -> SEContext:
    parms = default_parms(degree, nprimes, scale)
    return se_setup_custom(degree, nprimes, parms.scale, encrypt_type, **kw)


def se_setup_default(encrypt_type: str = SYM, **kw) -> SEContext:
    """n=4096, 3 primes, scale 2^25 (seal_embedded.c:90-96)."""
    return se_setup(4096, 3, 2.0 ** 25, encrypt_type, **kw)


def se_encrypt_seeded(ctx: SEContext, values: np.ndarray,
                      share_seeds: Optional[list[bytes]] = None,
                      seeds: Optional[list[bytes]] = None,
                      send: Optional[Callable[[bytes], int]] = None,
                      send_seed_only: bool = False):
    """se_encrypt_seeded equivalent (seal_embedded.c:98-215), batched.

    values: (B, <= n/2) float32.  seeds: per-message 64-byte seeds (random
    if omitted).  If `send` is given it receives each RNS component's bytes
    in the reference's streaming order (c0 then c1, per prime, per message).
    With send_seed_only (symmetric only) each message is sent as ONE
    compressed blob: the 64-byte shareable seed + c0 per prime; the
    receiver expands c1 via ckks.limbwise.expand_c1 (the reference's
    unfinished SE_ENABLE_SYM_SEED_CT, seal_embedded.c:184-194).
    Returns the encryptor's dict of tensors on ctx.device: c0, c1 int64
    (L, B, n), pt, pte int64 (B, n), ok (B,).
    """
    values = np.atleast_2d(np.asarray(values, dtype=np.float32))
    B = values.shape[0]
    n = ctx.parms.degree
    if values.shape[1] > n // 2:
        raise ValueError(f"at most n/2 = {n // 2} values per message")
    if values.shape[1] < n // 2:
        values = np.pad(values, ((0, 0), (0, n // 2 - values.shape[1])))
    if send_seed_only and ctx.encrypt_type != SYM:
        raise ValueError("seed-only ciphertexts are symmetric")
    ctx.resolved_encode_mode()

    dev = ctx.device
    seeds = seeds or [os.urandom(64) for _ in range(B)]
    v = to_device(values, dev)
    if ctx.encrypt_type == SYM:
        if ctx._sk is None:
            raise ValueError("symmetric encryption needs the secret key")
        share_seeds = share_seeds or [os.urandom(64) for _ in range(B)]
        out = ctx._sym_fn(v, ctx._sk, _seed_words_batch(share_seeds, dev),
                          _seed_words_batch(seeds, dev))
    else:
        if ctx._asym_fn is None:
            raise ValueError("asymmetric encryption needs the public key")
        out = ctx._asym_fn(v, *ctx._pk, _seed_words_batch(seeds, dev))

    if send is not None:
        # Sanity check before anything leaves the device: every ciphertext
        # coefficient must be canonical, < its prime (seal_embedded.c:172-177).
        # A reduction on the device: the host reads one boolean before the
        # component fetches, the only bulk transfers of the send path.
        check_c1 = not send_seed_only
        if not bool(_canon_check(ctx.parms)(
                out["c0"], out["c1"] if check_c1 else out["c0"])):
            raise ValueError("ciphertext coefficient >= modulus")
        c0 = _to_host_u32(out["c0"])
        if send_seed_only:
            for b in range(B):
                send(serialize.seeded_ct_bytes(share_seeds[b], c0[:, b]))
        else:
            c1 = _to_host_u32(out["c1"])
            for b in range(B):
                for i in range(ctx.parms.nprimes):
                    send(serialize.ct_component_bytes(c0[i, b]))
                    send(serialize.ct_component_bytes(c1[i, b]))
    return out


def _canon_check(parms: Parms):
    """Canonicality reduction on the data's device: all coefficients of
    both components < their limb's prime (seal_embedded.c:172-177).
    Returns check(c0, c1) -> 0-dim bool tensor, compiled per input
    signature on c0's device."""
    return lambda c0, c1: _canon_graph(parms, c0.device)(c0, c1)


@lru_cache(maxsize=16)
def _canon_graph(parms: Parms, device: torch.device):
    q = torch.tensor(parms.moduli, dtype=torch.int64,
                     device=device)[:, None, None]

    def check(c0, c1):
        return (c0 < q).all() & (c1 < q).all()

    return graphed(check, device)


def se_encrypt(ctx: SEContext, values: np.ndarray,
               send: Optional[Callable[[bytes], int]] = None):
    """se_encrypt equivalent: random seeds per message."""
    return se_encrypt_seeded(ctx, values, send=send)


def se_decrypt_decode(ctx: SEContext, out, prime_idx: int = 0) -> np.ndarray:
    """Verification oracle: decrypt+decode a batch result (test-side only,
    like the reference's check_decode_decrypt_inpl).  Returns float64
    (B, n/2) slot values of prime `prime_idx`'s component."""
    if ctx._sk is None:
        raise ValueError("decryption needs the secret key")
    centered = make_decryptor(ctx.parms, device=ctx.device)(
        out["c0"], out["c1"], ctx._sk)
    return make_decoder(ctx.parms, ctx.device)(
        centered[prime_idx]).cpu().numpy()


def se_cleanup(ctx: SEContext) -> None:
    """Drop key material (the reference's se_cleanup + se_secure_zero_memset
    discipline, seal_embedded.c:217-233, defines.h:405-409).

    The context's own host copies of sk/pk are zeroed in place, and its
    device copies (the secret key and the public key) with zero_(), before
    the references are dropped; so are the copies the compiled functions
    it used keep of them: the static inputs of its encryptor's and its
    decryptor's graphs, and the static inputs, last hand-offs (ntt(s),
    or pk and its quotients) and outputs of the stream graphs
    se_encrypt_streaming ran for it.  Arrays the caller passed to
    se_setup_custom are never touched: the context copied them.  A graph
    that its device's registry evicts before se_cleanup runs (to make
    room for another capture, graphs.py) has the same copies zeroed
    before its memory goes back.  Other memory that PyTorch's allocators
    free is not scrubbed, nor are the intermediates in a batch graph's
    private pool (for example ntt(s) or pk's quotients), evicted or not,
    so keep contexts short-lived and call se_cleanup as soon as the last
    batch is done."""
    for name in ("sk_signed", "pk0", "pk1"):
        buf = getattr(ctx, name)
        if buf is not None:
            buf.fill(0)
        setattr(ctx, name, None)
    if ctx._sk is not None:
        ctx._sk.zero_()
        make_decryptor(ctx.parms, device=ctx.device).scrub()
    for t in ctx._pk or ():
        t.zero_()
    for fn in (ctx._sym_fn, ctx._asym_fn, *ctx._streams):
        if fn is not None:
            fn.scrub()
    ctx._streams.clear()
    ctx._sk = None
    ctx._pk = None
    ctx._sym_fn = None
    ctx._asym_fn = None


def print_config(ctx: SEContext) -> str:
    """Runtime configuration banner — the reference's print_config
    (util_print.h:713) maps compile-time #defines to these runtime fields."""
    p = ctx.parms
    lines = [
        "seal_embedded_tpu_torch configuration",
        f"  device           : {ctx.device} (torch {torch.__version__})",
        f"  degree n         : {p.degree}",
        f"  modulus chain    : {list(p.moduli)}",
        f"  scale            : 2^{int(np.log2(p.scale))}",
        f"  encrypt type     : {ctx.encrypt_type}",
        f"  encode mode      : {ctx.encode_mode} "
        f"(resolved: {ctx.resolved_encode_mode()})",
        f"  sk loaded        : {ctx.sk_signed is not None}",
        f"  pk loaded        : {ctx.pk0 is not None}",
    ]
    banner = "\n".join(lines)
    print(banner)
    return banner
