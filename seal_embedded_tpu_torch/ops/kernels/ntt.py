"""Wrapper of kernel KN (``csrc/ntt.cu``): forward NTT of (L, B, n) rows,
optionally fused with the symmetric c0 epilogue.

Replaces both TPU NTT kernels on the symmetric path (K3 ntt_coeff_major,
K4 ntt_coeff_major_fused_sym) and keeps the JAX package's (L, B, n)
layout at the boundary.  On CPU tensors it runs the plain version
(``ops.ntt.ntt_limbs`` and ``ops.ntt.sym_epilogue``); on CUDA tensors it
launches KN or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..modarith import MASK32
from ..ntt import ntt_limbs, sym_epilogue
from . import build

launches = 0


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
