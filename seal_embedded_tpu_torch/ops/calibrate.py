"""The op-mix calibration loops on torch tensors: the plain version of
kernel KC (``ops/kernels/calibrate.py``).

Port of the mixes of ``seal_embedded_tpu/ops/kernels/calibrate.py``
(:40-90).  Each lane carries `nchain` independent u32 chains; every
iteration builds the new chains from the old ones.  u32 values are int64
tensors in [0, 2^32), masked after each op that can wrap.
"""

from __future__ import annotations

import torch

from .modarith import MASK32, mulhi, mullo

MIXES = ("keccak", "ntt")
NTT_Q = 1053818881
KECCAK_SALT = 0x9E3779B9
# Source-convention ops per chain (keccak) and per pair (ntt) per
# iteration, as the JAX bodies count them.
_OPS = {"keccak": 8, "ntt": 20}


def check_mix(mix: str, nchain: int) -> None:
    """Raise ValueError for an unknown mix, or an odd chain count in ntt
    (its chains are (u, w) pairs)."""
    if mix not in MIXES:
        raise ValueError(f"unknown mix {mix!r}")
    if nchain < 1 or (mix == "ntt" and nchain % 2):
        raise ValueError(f"{mix} mix: bad chain count {nchain}")


def ops_per_iter(mix: str, nchain: int = 8) -> int:
    """Source-convention op count of one iteration over all chains: 64
    for keccak and 80 for ntt at nchain = 8 (calibrate.py:131-137)."""
    check_mix(mix, nchain)
    return _OPS[mix] * (nchain if mix == "keccak" else nchain // 2)


def _rol(x, r: int):
    """3-op u32 rotate left by r in [1, 31] (calibrate.py:40-42)."""
    return ((x << r) & MASK32) | (x >> (32 - r))


def _keccak_iter(chains):
    nch = len(chains)
    out = []
    for i, a in enumerate(chains):
        b = chains[(i + 1) % nch]
        c = chains[(i + 2) % nch]
        t = _rol(a, (i * 7 + 1) % 31 + 1) ^ b
        t = t ^ ((b ^ MASK32) & c)
        out.append(t ^ KECCAK_SALT)
    return out


def _ntt_iter(chains):
    two_q = 2 * NTT_Q
    out = []
    for u, w in zip(chains[0::2], chains[1::2]):
        u = torch.where(u >= two_q, u - two_q, u)
        t = (mullo(w, u) - mullo(mulhi(w, u), NTT_Q)) & MASK32
        out += [(u + t) & MASK32, (u + two_q - t) & MASK32]
    return out


def mix_plain(x, mix: str, iters: int):
    """`iters` iterations of `mix` over x, int64 (tiles, nchain, lanes) u32
    values; returns the final chains in the same layout."""
    check_mix(mix, x.shape[1])
    step = _keccak_iter if mix == "keccak" else _ntt_iter
    chains = list(x.unbind(1))
    for _ in range(iters):
        chains = step(chains)
    return torch.stack(chains, dim=1)
