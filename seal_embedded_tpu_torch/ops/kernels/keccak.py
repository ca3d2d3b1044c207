"""Wrapper of kernel KK (``csrc/keccak.cu``): batched SHAKE-256 squeezes,
the CBD error values, the uniform draw of one limb and the ternary draw.

``keccak_squeeze`` serves both TPU kernels it replaces: the multi-block
squeeze (K1, ``nblocks > 1``) and the single-block streams that keep only
their first ``nwords`` words (K2).  A seed may carry several streams at
consecutive counters (``per_seed``, ``start``), so queue draws pass their
seeds and counters as they are.  ``cbd_values`` is KK's CBD role: the
error values themselves, popcounts included.  Both read and write int64
tensors as the callers hold them.  On CPU tensors each runs its plain
version (``ops.keccak.shake256_words``, ``ops.keccak.cbd_values``); on
CUDA tensors it launches KK or raises.  ``uniform_draw`` is KK's uniform
role: the base squeeze, the rank-select against a queue drawn by
``keccak_squeeze`` and ``barrett32`` in one launch; it takes CUDA tensors
only, its plain version being ``ops.sampling.sample_uniform``'s torch
path.  ``ternary_draw`` is KK's ternary role: a whole call's ternary
draw, the unbounded redraw included, in one launch; CUDA tensors only,
its plain version being ``ops.sampling.sample_ternary_exact``'s loop.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import keccak as plain
from ..keccak import RATE_WORDS
from . import build

launches = 0
cbd_launches = 0
uniform_launches = 0
ternary_launches = 0


def _check_streams(name, seeds, counters):
    build.require(seeds.dtype == torch.int64 and counters.dtype == torch.int64,
                  f"{name}: seeds and counters must be int64")
    build.require(seeds.dim() == 2 and seeds.shape[1] == 16,
                  f"{name}: seeds must be (S, 16), got {tuple(seeds.shape)}")
    build.require(counters.shape == (seeds.shape[0], 2),
                  f"{name}: counters must be (S, 2), got "
                  f"{tuple(counters.shape)}")


def keccak_squeeze(seeds, counters, nblocks: int, nwords: int | None = None,
                   per_seed: int = 1, start: int = 0):
    """SHAKE-256(seed || counter_le8) for S seeds x per_seed streams.

    seeds: int64 (S, 16) and counters: int64 (S, 2) (lo, hi), u32 values;
    stream j of seed s absorbs counters[s] + start + j mod 2^64.  Returns
    int64 (S * per_seed, nblocks * 34) u32 words, stream j of seed s in
    row s * per_seed + j, or (S * per_seed, nwords) when nblocks == 1 and
    nwords is given.
    """
    global launches
    name = "keccak_squeeze"
    _check_streams(name, seeds, counters)
    build.require(nblocks >= 1, f"{name}: nblocks must be >= 1")
    build.require(nwords is None or (nblocks == 1 and 1 <= nwords <= RATE_WORDS),
                  f"{name}: nwords needs nblocks == 1 and 1 <= nwords <= 34")
    build.require(per_seed >= 1 and 0 <= start and start + per_seed < 2 ** 32,
                  f"{name}: per_seed >= 1 and 0 <= start < start + per_seed "
                  f"< 2^32")
    S = seeds.shape[0]
    out_words = nblocks * RATE_WORDS if nwords is None else nwords
    if build.on_cpu(name, seeds, counters):
        offs = start + torch.arange(per_seed, device=counters.device)
        words = plain.shake256_words(
            seeds, plain.counter_offsets(counters, offs), nblocks, nwords)
        return words.reshape(S * per_seed, out_words)

    out = torch.empty((S * per_seed, out_words), dtype=torch.int64,
                      device=seeds.device)
    fn = build.entry("sek_keccak_squeeze",
                     [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_ulonglong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p])
    build.check(fn(build.ptr(seeds), build.ptr(counters), build.ptr(out), S,
                   per_seed, start, nblocks, out_words, build.stream(out)),
                name)
    launches += 1
    return out


def cbd_values(seeds, counters, n: int):
    """CBD error values (sample.c:311-321) for S streams: fill f of seed s
    absorbs counters[s] + f and gives values 16f .. 16f + 15.

    seeds: int64 (S, 16), counters: int64 (S, 2) u32 values.  Returns int64
    (S, n) in [-21, 21].  The kernel needs n to be a multiple of 16.
    """
    global cbd_launches
    name = "cbd_values"
    _check_streams(name, seeds, counters)
    build.require(n >= 1, f"{name}: n must be >= 1")
    if build.on_cpu(name, seeds, counters):
        return plain.cbd_values(seeds, counters, n)

    build.require(n % 16 == 0, f"{name}: n must be a multiple of 16")
    S = seeds.shape[0]
    out = torch.empty((S, n), dtype=torch.int64, device=seeds.device)
    fn = build.entry("sek_keccak_cbd", [ctypes.c_void_p] * 3
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    build.check(fn(build.ptr(seeds), build.ptr(counters), build.ptr(out), S,
                   n // 16, build.stream(out)), name)
    cbd_launches += 1
    return out


# The uniform role keeps each stream's queue in shared memory, within the
# 48 KiB a block may take without asking: up to 12288 u32 draws.
UNIFORM_MAX_CAP = 12288


def uniform_draw(seeds, counters, queue, n: int, q: int, r1: int,
                 max_multiple: int, chunk_n: int, chunk_k: int):
    """The uniform draw of one limb for S streams (sample.c:39-57): the n
    words of SHAKE-256(seed || counter), every rejected one (>=
    max_multiple) that the chunk rule keeps replaced by rank from the
    queue, accepted draws first, then reduced mod q (barrett32, r1 the
    high word of floor(2^64 / q)).  Chunk rule: per chunk_n words only the
    first chunk_k rejections take queue values, a chunk with more clears
    ok.

    seeds: int64 (S, 16), counters: int64 (S, 2) u32 values; queue: int64
    (S, cap) u32 words, draw j of stream s at counters[s] + 1 + j.
    Returns (a int64 (S, n) in [0, q), next counters int64 (S, 2), ok bool
    (S,)).  CUDA tensors only: the plain version is
    ``ops.sampling.sample_uniform``'s torch path.
    """
    global uniform_launches
    name = "uniform_draw"
    _check_streams(name, seeds, counters)
    S = seeds.shape[0]
    build.require(queue.dtype == torch.int64 and queue.dim() == 2
                  and queue.shape[0] == S,
                  f"{name}: queue must be int64 (S, cap), got "
                  f"{queue.dtype} {tuple(queue.shape)}")
    cap = queue.shape[1]
    build.require(1 <= cap <= UNIFORM_MAX_CAP,
                  f"{name}: cap must be in [1, {UNIFORM_MAX_CAP}], got {cap}")
    build.require(n >= 2 and n % 2 == 0, f"{name}: n must be even, got {n}")
    build.require(chunk_n >= 2 and chunk_n % 2 == 0 and n % chunk_n == 0
                  and chunk_k >= 1,
                  f"{name}: chunk_n must be even and divide n, chunk_k >= 1")
    build.require(2 <= q < 2 ** 31 and 0 <= r1 < 2 ** 32
                  and 0 <= max_multiple < 2 ** 32,
                  f"{name}: q must be below 2^31, r1 and max_multiple u32")
    build.require(not build.on_cpu(name, seeds, counters, queue),
                  f"{name}: CUDA tensors only; on the CPU "
                  f"ops.sampling.sample_uniform runs the plain version")
    dev = seeds.device
    a = torch.empty((S, n), dtype=torch.int64, device=dev)
    nxt = torch.empty((S, 2), dtype=torch.int64, device=dev)
    ok = torch.empty((S,), dtype=torch.bool, device=dev)
    fn = build.entry("sek_keccak_uniform",
                     [ctypes.c_void_p] * 6
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                        ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    build.check(fn(*map(build.ptr, (seeds, counters, queue, a, nxt, ok)), S,
                   n, q, r1, max_multiple, cap, chunk_n, chunk_k,
                   build.stream(a)), name)
    uniform_launches += 1
    return a, nxt, ok


# The ternary role keeps a stream's ring of window + 32 slots of 96 bytes
# in shared memory, within the 48 KiB a block may take without asking
# (its walk's 400 bytes beside it): a window of up to 475 counters.
TERNARY_MAX_WINDOW = 475
# A ternary byte is drawn again at or above 0xFE.
_TERNARY_REJECT = 2 / 256
# Threads a launch aims at: about 500 on each of the H100's 132 SMs.
_TERNARY_THREADS = 65536


def ternary_shape(n: int, streams: int) -> tuple[int, int]:
    """(window, threads) of KK's ternary role at degree n for `streams`
    streams: window, the counters a CTA squeezes at once, covers the
    ceil(n / 96) bases, the refills' mean n r / (1 - r) and 8 times their
    spread sqrt(n r) / (1 - r) (r = 2/256), and the walk's 32 counters of
    look-ahead, odd (the ring's rows then fall on distinct banks) and at
    most TERNARY_MAX_WINDOW (a longer draw squeezes more windows); threads,
    a CTA's, enough to squeeze the window in one pass where the streams are
    few, and 128 from about 512 streams on, where the CTAs fill the card."""
    r = _TERNARY_REJECT
    refills = n * r / (1 - r) + 8 * math.sqrt(n * r) / (1 - r)
    window = min(-(-n // 96) + math.ceil(refills) + 32,
                 TERNARY_MAX_WINDOW) | 1
    fill = 32 * -(-_TERNARY_THREADS // (32 * max(streams, 1)))
    return window, min(512, 32 * -(-window // 32), max(128, fill))


def ternary_draw(seeds, counters, n: int):
    """The ternary draw of S streams (sample_small_poly_ternary_prng_96,
    sample.c:218-242), the C loop's unbounded redraw included: n // 96
    blocks of 96 bytes, then a tail of n % 96 whose later bytes cannot
    reject; each byte >= 0xFE takes, in rank order, the next refill
    (the first byte of a one-block draw at the counters after the
    block's) below 0xFE; each value byte % 3 - 1; the next block at the
    counter after the last refill taken.

    seeds: int64 (S, 16), counters: int64 (S, 2) u32 values.  Returns (u
    int64 (S, n) in {-1, 0, 1}, next counters int64 (S, 2)).  CUDA tensors
    only: the plain version is ``ops.sampling.sample_ternary_exact``'s
    loop on CPU tensors."""
    return ternary_launch(seeds, counters, n,
                          *ternary_shape(n, seeds.shape[0]))


def ternary_launch(seeds, counters, n: int, window: int, threads: int):
    """ternary_draw with the CTA's window and threads given (ternary_draw
    derives them; chip_smoke.py also forces small windows, so that the
    walk stops and the CTA squeezes again on the card)."""
    global ternary_launches
    name = "ternary_draw"
    _check_streams(name, seeds, counters)
    build.require(n >= 1, f"{name}: n must be >= 1")
    build.require(1 <= window <= TERNARY_MAX_WINDOW,
                  f"{name}: window must be in [1, {TERNARY_MAX_WINDOW}], "
                  f"got {window}")
    build.require(32 <= threads <= 512 and threads % 32 == 0,
                  f"{name}: threads must be a multiple of 32 in [32, 512]")
    build.require(not build.on_cpu(name, seeds, counters),
                  f"{name}: CUDA tensors only; on the CPU "
                  f"ops.sampling.sample_ternary_exact runs the plain version")
    S = seeds.shape[0]
    u = torch.empty((S, n), dtype=torch.int64, device=seeds.device)
    nxt = torch.empty((S, 2), dtype=torch.int64, device=seeds.device)
    fn = build.entry("sek_keccak_ternary",
                     [ctypes.c_void_p] * 4
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p])
    build.check(fn(*map(build.ptr, (seeds, counters, u, nxt)), S, n, window,
                   threads, build.stream(u)), name)
    ternary_launches += 1
    return u, nxt
