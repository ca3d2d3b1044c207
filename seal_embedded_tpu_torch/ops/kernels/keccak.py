"""Wrapper of kernel KK (``csrc/keccak.cu``): batched SHAKE-256 squeeze.

One kernel serves both TPU kernels it replaces: the multi-block squeeze
(K1, ``nblocks > 1``) and the single-block streams that keep only their
first ``nwords`` words (K2).  On CPU tensors the wrapper runs the plain
version, ``ops.keccak.shake256_words``; on CUDA tensors it launches KK or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..keccak import MASK32, RATE_WORDS, shake256_words
from . import build

launches = 0


def keccak_squeeze(seeds, counters, nblocks: int, nwords: int | None = None):
    """SHAKE-256(seed || counter_le8) for N independent streams.

    seeds: int64 (N, 16) and counters: int64 (N, 2) (lo, hi), u32 values.
    Returns int64 (N, nblocks * 34) u32 words, or (N, nwords) when
    nblocks == 1 and nwords is given.
    """
    global launches
    name = "keccak_squeeze"
    build.require(seeds.dtype == torch.int64 and counters.dtype == torch.int64,
                  f"{name}: seeds and counters must be int64")
    build.require(seeds.dim() == 2 and seeds.shape[1] == 16,
                  f"{name}: seeds must be (N, 16), got {tuple(seeds.shape)}")
    build.require(counters.shape == (seeds.shape[0], 2),
                  f"{name}: counters must be (N, 2), got "
                  f"{tuple(counters.shape)}")
    build.require(nblocks >= 1, f"{name}: nblocks must be >= 1")
    build.require(nwords is None or (nblocks == 1 and 1 <= nwords <= RATE_WORDS),
                  f"{name}: nwords needs nblocks == 1 and 1 <= nwords <= 34")
    if build.on_cpu(name, seeds, counters):
        return shake256_words(seeds, counters, nblocks, nwords)

    n_streams = seeds.shape[0]
    out_words = nblocks * RATE_WORDS if nwords is None else nwords
    s32 = seeds.to(torch.int32)
    c32 = counters.to(torch.int32)
    out = torch.empty((n_streams, out_words), dtype=torch.int32,
                      device=seeds.device)
    fn = build.entry("sek_keccak_squeeze",
                     [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p])
    build.check(fn(build.ptr(s32), build.ptr(c32), build.ptr(out), n_streams,
                   nblocks, out_words, build.stream(out)), name)
    launches += 1
    return out.to(torch.int64) & MASK32
