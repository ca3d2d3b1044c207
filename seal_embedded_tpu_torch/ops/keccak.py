"""Batched Keccak-f[1600] / SHAKE-256 on torch tensors: the plain version
of kernel KK (``ops/kernels/keccak.py``).

Port of ``seal_embedded_tpu/ops/keccak.py``.  Every reference PRNG call
absorbs exactly 72 bytes (64-byte seed + 8-byte counter, rng.h:78-84),
less than the 136-byte rate, so the absorb is one padded block and the
output is a pure function of (seed, counter, block index).

Each 64-bit lane is one ``int64`` element of a (..., 25) state tensor,
lane i = x + 5y (FIPS 202).  A round is vectorized over the lane axis:
per-lane shift tensors for rho, an index gather for pi, rolled gathers
for chi, so one round is about 20 torch ops.  ``>>`` on int64 is
arithmetic, so every rotate masks the bits shifted in from the sign.

``seed_words`` packs a call's 64-byte seeds into the (B, 16) words the
samplers take (the API and the streaming call upload them).
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from ..utils import timing

RATE_WORDS = 34  # u32 words per 136-byte block
MASK32 = 0xFFFFFFFF

# Rho offsets, lane i = x + 5y (FIPS 202).
_RHO = (0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
        41, 45, 15, 21, 8, 18, 2, 61, 56, 14)

_RC = (0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
       0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
       0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
       0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
       0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
       0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
       0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
       0x8000000000008080, 0x0000000080000001, 0x8000000080008008)


def _signed64(v: int) -> int:
    """u64 bit pattern -> the int64 holding the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _pi_source() -> list[int]:
    """B[y + 5((2x + 3y) % 5)] = A[x + 5y]: the source lane of each lane."""
    src = [0] * 25
    for x in range(5):
        for y in range(5):
            src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    return src


_PI_SRC = _pi_source()
_X1 = [(x + 1) % 5 for x in range(5)]
_X2 = [(x + 2) % 5 for x in range(5)]
_XM1 = [(x - 1) % 5 for x in range(5)]


def _rol(x, r):
    """Rotate each int64 lane left by r (int or int64 tensor in [0, 64))."""
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def keccak_f1600(state):
    """The 24-round permutation over an int64 state tensor (..., 25)."""
    dev = state.device
    rho = torch.tensor(_RHO, dtype=torch.int64, device=dev)
    pi = torch.tensor(_PI_SRC, dtype=torch.int64, device=dev)
    x1 = torch.tensor(_X1, device=dev)
    x2 = torch.tensor(_X2, device=dev)
    xm1 = torch.tensor(_XM1, device=dev)
    iota = torch.zeros((24, 25), dtype=torch.int64, device=dev)
    iota[:, 0] = torch.tensor([_signed64(rc) for rc in _RC],
                              dtype=torch.int64, device=dev)
    shape = state.shape
    a = state.reshape(shape[:-1] + (5, 5))          # [..., y, x]
    for r in range(24):
        # theta
        c = a[..., 0, :] ^ a[..., 1, :] ^ a[..., 2, :] ^ a[..., 3, :] \
            ^ a[..., 4, :]
        d = c[..., xm1] ^ _rol(c[..., x1], 1)
        a = a ^ d.unsqueeze(-2)
        # rho + pi
        b = _rol(a.reshape(shape), rho)[..., pi].reshape(a.shape)
        # chi + iota
        a = b ^ (~b[..., x1] & b[..., x2])
        a = a ^ iota[r].reshape(5, 5)
    return a.reshape(shape)


def seed_to_words(seed: bytes) -> np.ndarray:
    """64-byte PRNG seed -> 16 u32 LE words."""
    seed = seed.ljust(64, b"\x00")
    return np.frombuffer(seed, dtype="<u4").copy()


# How many seed batches seed_words packed each way: "seeds.joined" (every
# seed 64 bytes: one view of their join) or "seeds.per_seed"
# (seed_to_words a seed).  perf_spans.py reports it beside the spans of
# the same work.
input_paths = collections.Counter()
_input_paths_lock = threading.Lock()


def seed_words(seeds: list[bytes]) -> np.ndarray:
    """A call's seeds -> int64 (B, 16) u32 words, as np.stack of
    seed_to_words (an ``api.seed_pack`` span): one frombuffer of their
    join where every seed is 64 bytes, else seed by seed (a short seed
    zero-padded, what seed_to_words does)."""
    with timing.span("api.seed_pack"):
        joined = set(map(len, seeds)) == {64}
        with _input_paths_lock:     # callers on several threads count each
            input_paths["seeds.joined" if joined else "seeds.per_seed"] += 1
        if joined:
            return np.frombuffer(b"".join(seeds), dtype="<u4").reshape(
                -1, 16).astype(np.int64)
        return np.stack([seed_to_words(s) for s in seeds]).astype(np.int64)


def align_seed(seed_words, counters):
    """Insert axes so seed_words (S..., 16) broadcasts against counters
    (S..., extra..., 2) by aligning leading batch dims."""
    while seed_words.dim() < counters.dim():
        seed_words = seed_words.unsqueeze(-2)
    return seed_words


def absorb72(seed_words, counters):
    """Post-absorb Keccak state for shake256(seed || counter_le8).

    seed_words: int64 (..., 16) u32 words, broadcastable against
    counters: int64 (..., 2) u32 (lo, hi) pairs.  Returns int64
    (..., 25).  The block is words 0..15 = seed, 16..17 = counter, with
    multi-rate padding word 18 ^= 0x1F and word 33 ^= 0x80000000.
    """
    batch_shape = counters.shape[:-1]
    sw = align_seed(seed_words, counters).expand(batch_shape + (16,))
    seed_lanes = sw[..., 0::2] | (sw[..., 1::2] << 32)
    ctr_lane = counters[..., 0] | (counters[..., 1] << 32)
    state = torch.zeros(batch_shape + (25,), dtype=torch.int64,
                        device=counters.device)
    state[..., 0:8] = seed_lanes
    state[..., 8] = ctr_lane
    state[..., 9] = 0x1F
    state[..., 16] = _signed64(0x80000000 << 32)
    return state


def _rate_words(state):
    """First 136 bytes of the state as 34 u32 words (int64)."""
    lanes = state[..., :17]
    w = torch.stack([lanes & MASK32, (lanes >> 32) & MASK32], dim=-1)
    return w.reshape(state.shape[:-1] + (RATE_WORDS,))


def shake256_words(seed_words, counters, nblocks: int,
                   nwords: int | None = None):
    """Squeeze nblocks * 136 bytes for each (seed, counter) stream.

    seed_words: int64 (S..., 16); counters: int64 (S..., extra..., 2).
    Returns int64 (S..., extra..., nblocks * 34) u32 words, the byte stream
    in LE word form.  nwords (nblocks == 1 only) keeps the first nwords.
    """
    assert nwords is None or nblocks == 1
    state = absorb72(seed_words, counters)
    out = []
    for _ in range(nblocks):
        state = keccak_f1600(state)
        out.append(_rate_words(state))
    words = torch.cat(out, dim=-1)
    return words if nwords is None else words[..., :nwords]


def counter_offsets(c, offs):
    """c (..., 2) u64 counter pairs + offs (K,) -> (..., K, 2), carrying
    into hi and wrapping at 2^64."""
    lo = c[..., 0, None] + offs
    hi = (c[..., 1, None] + (lo >> 32)) & MASK32
    return torch.stack([lo & MASK32, hi], dim=-1)


def words_to_bytes(words):
    """u32 words (..., W) -> byte values (..., 4W), LE order."""
    out = torch.stack([words & 0xFF, (words >> 8) & 0xFF,
                       (words >> 16) & 0xFF, (words >> 24) & 0xFF], dim=-1)
    return out.reshape(words.shape[:-1] + (words.shape[-1] * 4,))


def popcount8(b):
    """Hamming weight of byte values (sample.c:263-269)."""
    t = b - ((b >> 1) & 0x55)
    t = (t & 0x33) + ((t >> 2) & 0x33)
    return (t + (t >> 4)) & 0x0F


def cbd_values(seed_words, counter, n: int):
    """The CBD error values of sample_poly_cbd_generic_prng_16
    (sample.c:311-321): the plain version of kernel KK's CBD role.

    seed_words: int64 (..., 16); counter: int64 (..., 2).  Fill f absorbs
    counter + f and gives 16 values from its first 96 bytes, 6 bytes per
    value.  Returns int64 (..., n)."""
    nfills = -(-n // 16)
    fcounters = counter_offsets(counter, torch.arange(nfills,
                                                      device=counter.device))
    by = words_to_bytes(shake256_words(seed_words, fcounters, 1, nwords=24))
    by = by.reshape(by.shape[:-2] + (nfills * 16, 6))[..., :n, :]
    hw = popcount8(by)
    return (hw[..., 0] + hw[..., 1] + popcount8(by[..., 2] & 0x1F)
            - hw[..., 3] - hw[..., 4] - popcount8(by[..., 5] & 0x1F))


def words_to_bytes_np(words: np.ndarray) -> bytes:
    """Utility (tests): u32 word stream -> bytes."""
    return np.asarray(words, dtype="<u4").tobytes()
