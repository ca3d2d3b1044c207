"""Wrapper of kernel KC (``csrc/calibrate.cu``), the op-mix calibration
loops, and the reckoning that turns their rates into ceilings.

KC replaces K7, ``seal_embedded_tpu/ops/kernels/calibrate.py:94``
``_calib_call``, reached through ``run_mix``.  ``calib_mix`` runs the
plain version (``ops.calibrate.mix_plain``) on CPU tensors and launches
KC on CUDA tensors, or raises.  ``measure_ceilings`` is the port of
``bench.py:_calibrate`` (:370-392) without its printing: the measured
element-op rate of each mix, the denominator of a kernel's
``sol_frac_calibrated``.

A TPU tile of (8, 128) lanes is one v5e TensorCore; here it is one
1024-thread block, one of 132 SMs, so the input has a leading `tiles`
axis: (tiles, nchain, 1024), lane = sub * 128 + lane of the JAX layout.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...config import CUDA
from ...utils.timing import cuda_time_ms
from ..calibrate import MIXES, check_mix, mix_plain, ops_per_iter
from ..modarith import MASK32
from . import build

launches = 0

LANES = 1024
UNROLL = 8          # iters must be a multiple of it (calibrate.py:98-99)
MAX_CHAINS = 16     # KC's instantiations: keccak 1..16, ntt even 2..16
NTT_OPS_PER_BFLY = 20           # bench.py:55
KECCAK_OPS_PER_PERM = 10.3e3    # bench.py:441, per Keccak-f permutation
TIMED_CALLS = 5


def calib_mix(x, mix: str, iters: int):
    """`iters` iterations of `mix` over x, int64 (tiles, nchain, 1024) u32
    values; returns the final chains, same layout."""
    global launches
    name = "calib_mix"
    build.require(x.dtype == torch.int64 and x.dim() == 3
                  and x.shape[2] == LANES,
                  f"{name}: x must be int64 (tiles, nchain, {LANES})")
    tiles, nchain, _ = x.shape
    check_mix(mix, nchain)
    build.require(nchain <= MAX_CHAINS,
                  f"{name}: at most {MAX_CHAINS} chains, got {nchain}")
    build.require(iters >= 0 and iters % UNROLL == 0,
                  f"{name}: iters must be a multiple of {UNROLL}")
    if build.on_cpu(name, x):
        return mix_plain(x, mix, iters)

    i32 = x.to(torch.int32)
    out = torch.empty_like(i32)
    fn = build.entry("sek_calib_mix", [ctypes.c_void_p] * 2
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    build.check(fn(build.ptr(i32), build.ptr(out), MIXES.index(mix), nchain,
                   tiles, iters, build.stream(out)), name)
    launches += 1
    return out.to(torch.int64) & MASK32


def mix_input(nchain: int = 8, tiles: int = 1, device=CUDA):
    """The mix's input, int64 (tiles, nchain, 1024): tile 0 is the JAX
    input, ``default_rng(0).integers(0, 2**31, (nchain, 8, 128))``
    (calibrate.py:149-151); further tiles are further draws of the same
    generator."""
    rng = np.random.default_rng(0)
    first = rng.integers(0, 2 ** 31, (1, nchain, LANES))
    rest = rng.integers(0, 2 ** 31, (tiles - 1, nchain, LANES))
    return torch.as_tensor(np.concatenate([first, rest]), device=device)


def run_mix(mix: str, iters: int = 200_000, nchain: int = 8, tiles: int = 1,
            device=CUDA):
    """A thunk computing the mix, as the JAX run_mix returns one; total
    source-convention op count = iters * ops_per_iter(mix, nchain) * 1024
    per tile."""
    check_mix(mix, nchain)
    x = mix_input(nchain, tiles, device)
    return lambda: calib_mix(x, mix, iters)


def measure_ceilings(device, iters: int, tiles: int) -> dict[str, float]:
    """Measured element-ops/s of each mix at 8 chains on `device`: iters *
    ops_per_iter * lanes / seconds, the seconds a CUDA-event median of
    TIMED_CALLS calls."""
    rates = {}
    for mix in MIXES:
        ms = cuda_time_ms(run_mix(mix, iters, 8, tiles, device),
                          TIMED_CALLS, 1)
        rates[mix] = iters * ops_per_iter(mix) * tiles * LANES / (ms * 1e-3)
    return rates


def ntt_butterflies(L: int, B: int, n: int, ntts: int = 1) -> int:
    """Butterflies of `ntts` forward NTTs of (L, B, n): L * B * n/2 *
    log2 n each (bench.py:417-418)."""
    return ntts * L * B * (n // 2) * (n.bit_length() - 1)


def ntt_share(butterflies: int, ms: float, ceiling_ntt: float) -> float:
    """sol_frac_calibrated of `butterflies` taking `ms`: butterflies/s
    over the ntt ceiling in butterflies/s."""
    return butterflies / (ms * 1e-3) / (ceiling_ntt / NTT_OPS_PER_BFLY)


def keccak_share(perms: int, ms: float, ceiling_keccak: float) -> float:
    """sol_frac_calibrated of `perms` Keccak-f permutations taking `ms`
    (streams * blocks, bench.py:439) over the keccak ceiling."""
    return perms / (ms * 1e-3) / (ceiling_keccak / KECCAK_OPS_PER_PERM)
