"""Wrappers of kernels KN and KA (``csrc/ntt.cu``).

KN, ``ntt_fwd``: forward NTT of (L, B, n) rows, and
``ntt_sym_from_pte``: the NTT fused with the symmetric c0 epilogue,
straight from the int64 plaintext + error, reduced per limb as it is
loaded; they replace K3 ntt_coeff_major and K4 ntt_coeff_major_fused_sym.
KA, ``ntt_asym_from_signed``: the three NTTs and the public-key combine
of the asymmetric path, straight from the signed u, e1 and the int64 pte,
mapped or reduced per limb as they are loaded; replaces K6
ntt_coeff_major_fused_asym.  All read and write int64 as the callers
hold it, keep the JAX package's (L, B, n) output layout and count their
launches apart (``launches``, ``pte_launches``, ``asym_launches``).  On
CPU tensors each runs its plain version (``ops.ntt``); on CUDA tensors it
launches its kernel or raises.  The kernels take n from 8 to 16384.
"""

from __future__ import annotations

import ctypes

import torch

from ..ntt import (ntt_asym_from_signed_plain, ntt_limbs,
                   ntt_sym_from_pte_plain)
from . import build

launches = 0
pte_launches = 0
asym_launches = 0


def _check_degree(name, n):
    build.require(n >= 2 and n & (n - 1) == 0, f"{name}: n must be a power of 2")


def _check_kernel_degree(name, n):
    build.require(8 <= n <= 16384, f"{name}: the kernel takes n from 8 to "
                  f"16384, got {n}")


def ntt_fwd(x, op, quot, q):
    """Per-limb forward NTT, canonical [0, q) output in bit-reversed order.

    x: int64 (L, B, n) u32 values below 4q; op, quot: int64 (L, n) root
    tables; q: int64 (L,).
    """
    global launches
    name = "ntt_fwd"
    tensors = [x, op, quot, q]
    build.require(all(t.dtype == torch.int64 for t in tensors),
                  f"{name}: all inputs must be int64")
    build.require(x.dim() == 3, f"{name}: x must be (L, B, n)")
    L, B, n = x.shape
    _check_degree(name, n)
    build.require(op.shape == (L, n) and quot.shape == (L, n)
                  and q.shape == (L,), f"{name}: tables must be (L, n), q (L,)")
    if build.on_cpu(name, *tensors):
        return ntt_limbs(x, op, quot, q)

    _check_kernel_degree(name, n)
    out = torch.empty((L, B, n), dtype=torch.int64, device=x.device)
    fn = build.entry("sek_ntt_fwd", [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    build.check(fn(*map(build.ptr, tensors + [out]), L, B,
                   n.bit_length() - 1, build.stream(out)), name)
    launches += 1
    return out


def ntt_sym_from_pte(pte, a, s_op, s_quot, op, quot, q, r0, r1):
    """c0 = -a * ntt(s) + ntt(reduce_pte(pte)) mod q for every limb, the
    pte row reduced per limb on load, so (L, B, n) reduced values are
    never stored.

    pte: int64 (B, n) plaintext + error (any int64); a: int64 (L, B, n) in
    [0, q); s_op, s_quot: int64 (L, n), the Shoup pair of ntt(s); op, quot:
    int64 (L, n) root tables; q, r0, r1: int64 (L,), the moduli and the low
    and high words of floor(2^64 / q).  Returns int64 (L, B, n).
    """
    global pte_launches
    name = "ntt_sym_from_pte"
    tensors = [pte, op, quot, q, r0, r1, a, s_op, s_quot]
    build.require(all(t.dtype == torch.int64 for t in tensors),
                  f"{name}: all inputs must be int64")
    build.require(pte.dim() == 2 and a.dim() == 3,
                  f"{name}: pte must be (B, n), a (L, B, n)")
    L, B, n = a.shape
    _check_degree(name, n)
    build.require(pte.shape == (B, n), f"{name}: pte must be (B, n) = "
                  f"({B}, {n}), got {tuple(pte.shape)}")
    build.require(all(t.shape == (L, n) for t in (op, quot, s_op, s_quot))
                  and all(t.shape == (L,) for t in (q, r0, r1)),
                  f"{name}: tables and s_op/s_quot must be (L, n), "
                  f"q/r0/r1 (L,)")
    if build.on_cpu(name, *tensors):
        return ntt_sym_from_pte_plain(pte, a, s_op, s_quot, op, quot, q, r0,
                                      r1)

    _check_kernel_degree(name, n)
    out = torch.empty((L, B, n), dtype=torch.int64, device=a.device)
    fn = build.entry("sek_ntt_from_pte", [ctypes.c_void_p] * 10
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    build.check(fn(*map(build.ptr, tensors + [out]), L, B,
                   n.bit_length() - 1, build.stream(out)), name)
    pte_launches += 1
    return out


def ntt_asym_from_signed(u, e1, pte, op, quot, q, r0, r1, p0_op, p0_quot,
                         p1_op, p1_quot):
    """The asymmetric per-limb step for every limb: returns (c0, c1) with
    c0 = pk0 * ntt(u) + ntt(reduce_pte(pte)) and c1 = pk1 * ntt(u) +
    ntt(e1) mod q, u and e1 mapped x < 0 -> x + q per limb on load.

    u: int64 (B, n) in {-1, 0, 1}; e1: int64 (B, n) in [-63, 63]; pte:
    int64 (B, n), any value; op, quot: int64 (L, n) root tables; q, r0,
    r1: int64 (L,), the moduli and the low and high words of
    floor(2^64 / q); p0_op, p0_quot, p1_op, p1_quot: int64 (L, n), the
    Shoup pairs of pk0 and pk1.  Returns int64 (L, B, n) in [0, q).
    """
    global asym_launches
    name = "ntt_asym_from_signed"
    rows = [u, e1, pte]
    pk = [p0_op, p0_quot, p1_op, p1_quot]
    tensors = rows + [op, quot, q, r0, r1] + pk
    build.require(all(t.dtype == torch.int64 for t in tensors),
                  f"{name}: all inputs must be int64")
    build.require(u.dim() == 2 and q.dim() == 1,
                  f"{name}: u must be (B, n), q (L,)")
    B, n = u.shape
    L = q.shape[0]
    _check_degree(name, n)
    build.require(all(t.shape == (B, n) for t in rows),
                  f"{name}: u, e1 and pte must have one (B, n) shape")
    build.require(all(t.shape == (L, n) for t in [op, quot] + pk)
                  and r0.shape == r1.shape == (L,),
                  f"{name}: tables and pk pairs must be (L, n), q/r0/r1 (L,)")
    if build.on_cpu(name, *tensors):
        return ntt_asym_from_signed_plain(*tensors)

    _check_kernel_degree(name, n)
    c0, c1 = (torch.empty((L, B, n), dtype=torch.int64, device=u.device)
              for _ in range(2))
    fn = build.entry("sek_ntt_asym_from_signed", [ctypes.c_void_p] * 14
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    build.check(fn(*map(build.ptr, tensors + [c0, c1]), L, B,
                   n.bit_length() - 1, build.stream(c0)), name)
    asym_launches += 1
    return c0, c1
