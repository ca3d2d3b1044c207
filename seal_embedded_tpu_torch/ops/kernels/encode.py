"""Wrapper of kernel KE (``csrc/encode.cu``): bit-exact CKKS encode in
IEEE f64, one thread block per batch row.

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

# Shared memory one block may use on Hopper (232,448 bytes): rows whose
# re + im planes (16 bytes per coefficient) exceed it run in two halves.
_MAX_SMEM = 232448


def encode_f64(values, imap, tw_re, tw_im, scale_n: float):
    """values float32 (B, vlen <= n/2); imap int32 (n,); tw_re, tw_im
    float64 (n - 1,) (ops.encode.ifft_tables_flat); scale_n = scale / n.
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

    B, vlen = values.shape
    dev = values.device
    coeff = torch.empty((B, n), dtype=torch.int64, device=dev)
    ok = torch.empty((B,), dtype=torch.int32, device=dev)
    nseg = 1 if 16 * n <= _MAX_SMEM else 2
    scratch = ([torch.empty((B, n), dtype=torch.float64, device=dev)
                for _ in range(2)] if nseg == 2 else [])
    null = ctypes.c_void_p(None)
    fn = build.entry("sek_encode_f64",
                     [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                     + [ctypes.c_void_p] * 3
                     + [ctypes.c_double, ctypes.c_int, ctypes.c_int]
                     + [ctypes.c_void_p] * 5)
    sc = [build.ptr(t) for t in scratch] or [null, null]
    build.check(fn(build.ptr(values), B, vlen, build.ptr(imap),
                   build.ptr(tw_re), build.ptr(tw_im), float(scale_n),
                   n.bit_length() - 1, nseg, build.ptr(coeff), build.ptr(ok),
                   *sc, build.stream(coeff)), name)
    launches += 1
    return coeff, ok.bool()
