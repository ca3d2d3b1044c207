"""Wrappers of kernels KN and KA (``csrc/ntt.cu``).

KN, ``ntt_fwd``: forward NTT of (L, B, n) rows, optionally fused with
the symmetric c0 epilogue; replaces K3 ntt_coeff_major and K4
ntt_coeff_major_fused_sym.  KA, ``ntt_asym``: the three NTTs and the
public-key combine of the asymmetric path; replaces K6
ntt_coeff_major_fused_asym.  Both keep the JAX package's (L, B, n)
layout at the boundary and count their launches apart (``launches``,
``asym_launches``).  On CPU tensors each runs its plain version
(``ops.ntt``); on CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..modarith import MASK32
from ..ntt import ntt_asym_plain, ntt_limbs, sym_epilogue
from . import build

launches = 0
asym_launches = 0


def ntt_fwd(x, op, quot, q, a=None, s_op=None, s_quot=None):
    """Per-limb forward NTT, canonical [0, q) output in bit-reversed order.

    x: int64 (L, B, n) u32 values below 4q; op, quot: int64 (L, n) root
    tables; q: int64 (L,).  With a (L, B, n) and s_op, s_quot (L, n), the
    Shoup pair of ntt(s), returns c0 = -a * ntt(s) + ntt(x) mod q instead.
    """
    global launches
    name = "ntt_fwd"
    fused = a is not None
    tensors = [x, op, quot, q] + ([a, s_op, s_quot] if fused else [])
    build.require(all(t.dtype == torch.int64 for t in tensors),
                  f"{name}: all inputs must be int64")
    build.require(x.dim() == 3, f"{name}: x must be (L, B, n)")
    L, B, n = x.shape
    build.require(n >= 2 and n & (n - 1) == 0, f"{name}: n must be a power of 2")
    build.require(op.shape == (L, n) and quot.shape == (L, n)
                  and q.shape == (L,), f"{name}: tables must be (L, n), q (L,)")
    if fused:
        build.require(a.shape == x.shape and s_op.shape == (L, n)
                      and s_quot.shape == (L, n),
                      f"{name}: a must be (L, B, n), s_op/s_quot (L, n)")
    else:
        build.require(s_op is None and s_quot is None,
                      f"{name}: s_op/s_quot need a")
    if build.on_cpu(name, *tensors):
        v = ntt_limbs(x, op, quot, q)
        return sym_epilogue(v, a, s_op, s_quot, q) if fused else v

    i32 = [t.to(torch.int32) for t in tensors]
    out = torch.empty((L, B, n), dtype=torch.int32, device=x.device)
    null = ctypes.c_void_p(None)
    fn = build.entry("sek_ntt_fwd", [ctypes.c_void_p] * 8
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    args = [build.ptr(t) for t in i32] + ([] if fused else [null] * 3)
    build.check(fn(*args, build.ptr(out), L, B, n.bit_length() - 1,
                   build.stream(out)), name)
    launches += 1
    return out.to(torch.int64) & MASK32


def ntt_asym(u, e1, pte, op, quot, q, p0_op, p0_quot, p1_op, p1_quot):
    """The asymmetric per-limb step: returns (c0, c1) with
    c0 = pk0 * ntt(u) + ntt(pte) and c1 = pk1 * ntt(u) + ntt(e1) mod q.

    u, e1, pte: int64 (L, B, n) u32 values below 4q; op, quot: int64 (L, n)
    root tables; q: int64 (L,); p0_op, p0_quot, p1_op, p1_quot: int64
    (L, n), the Shoup pairs of pk0 and pk1.
    """
    global asym_launches
    name = "ntt_asym"
    rows = [u, e1, pte]
    pk = [p0_op, p0_quot, p1_op, p1_quot]
    tensors = rows + [op, quot, q] + pk
    build.require(all(t.dtype == torch.int64 for t in tensors),
                  f"{name}: all inputs must be int64")
    build.require(u.dim() == 3, f"{name}: u must be (L, B, n)")
    L, B, n = u.shape
    build.require(n >= 2 and n & (n - 1) == 0, f"{name}: n must be a power of 2")
    build.require(all(t.shape == u.shape for t in rows),
                  f"{name}: u, e1 and pte must have one (L, B, n) shape")
    build.require(all(t.shape == (L, n) for t in [op, quot] + pk)
                  and q.shape == (L,),
                  f"{name}: tables and pk pairs must be (L, n), q (L,)")
    if build.on_cpu(name, *tensors):
        return ntt_asym_plain(*tensors)

    i32 = [t.to(torch.int32) for t in tensors]
    c0, c1 = (torch.empty((L, B, n), dtype=torch.int32, device=u.device)
              for _ in range(2))
    fn = build.entry("sek_ntt_asym", [ctypes.c_void_p] * 12
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    build.check(fn(*map(build.ptr, i32 + [c0, c1]), L, B, n.bit_length() - 1,
                   build.stream(c0)), name)
    asym_launches += 1
    return c0.to(torch.int64) & MASK32, c1.to(torch.int64) & MASK32
