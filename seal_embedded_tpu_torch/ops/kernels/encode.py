"""Wrapper of kernel KE (``csrc/encode.cu``): bit-exact CKKS encode in
IEEE f64, one thread block per batch row up to n = 4096 and a cluster of
two from n = 8192 (at 16384 the row's planes exceed a block's shared
memory), in one launch at every degree.

Replaces the TPU's software-f64 encode kernel (K5, encode_sf_fused).  On
CPU tensors it runs the plain version, ``ops.encode.encode_tables``; on
CUDA tensors it launches KE or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..encode import encode_tables
from . import build

launches = 0

_MAX_N = 16384


def encode_f64(values, imap, tw_re, tw_im, scale_n: float):
    """values float32 (B, vlen <= n/2); imap int32 (n,); tw_re, tw_im
    float64 (n - 1,) (ops.encode.ifft_tables_flat); scale_n = scale / n.
    On the card n runs from 8 to 16384: one CTA a row below n = 8192, a
    cluster of two from it (at 8192 that measured a little faster than
    one block a row on an H100, PERF.md).
    Returns (coeff int64 (B, n), ok bool (B,))."""
    global launches
    name = "encode_f64"
    build.require(values.dtype == torch.float32 and values.dim() == 2,
                  f"{name}: values must be float32 (B, vlen)")
    build.require(imap.dtype == torch.int32 and imap.dim() == 1,
                  f"{name}: imap must be int32 (n,)")
    n = imap.shape[0]
    build.require(n >= 4 and n & (n - 1) == 0, f"{name}: n must be a power of 2")
    build.require(values.shape[1] <= n // 2, f"{name}: vlen must be <= n/2")
    build.require(tw_re.dtype == torch.float64 and tw_im.dtype == torch.float64
                  and tw_re.shape == (n - 1,) and tw_im.shape == (n - 1,),
                  f"{name}: twiddles must be float64 (n - 1,)")
    if build.on_cpu(name, values, imap, tw_re, tw_im):
        return encode_tables(values, imap, tw_re, tw_im, scale_n)
    build.require(8 <= n <= _MAX_N,
                  f"{name}: the kernel takes n from 8 to {_MAX_N}, got {n}")

    B, vlen = values.shape
    coeff = torch.empty((B, n), dtype=torch.int64, device=values.device)
    ok = torch.empty((B,), dtype=torch.int32, device=values.device)
    fn = build.entry("sek_encode_f64",
                     [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                     + [ctypes.c_void_p] * 3
                     + [ctypes.c_double, ctypes.c_int]
                     + [ctypes.c_void_p] * 3)
    build.check(fn(build.ptr(values), B, vlen, build.ptr(imap),
                   build.ptr(tw_re), build.ptr(tw_im), float(scale_n),
                   n.bit_length() - 1, build.ptr(coeff), build.ptr(ok),
                   build.stream(coeff)), name)
    launches += 1
    return coeff, ok.bool()
