"""Bit-exact CKKS encode in IEEE f64 on torch tensors: the plain version of
kernel KE (``ops/kernels/encode.py``).

Port of ``seal_embedded_tpu/ops/encode.py`` (the reference encode,
device/lib/ckks_common.c:105-215 + fft.c): slot placement through the
index map (generator-3 orbit merged with bit reversal), logn IFFT
butterfly rounds over separate re/im f64 planes, scale by scale/n and
round half away from zero to int64.

Re and im stay two float64 tensors, never a complex dtype: a complex
product may be contracted or reordered and change bits, while eager torch
rounds each real operation separately, as the reference does.  The
twiddles come from Python's ``math.cos`` / ``math.sin`` on the host, as
in the reference.  The JAX package's TPU encodes ('sf' software f64, 'dd'
double-double) exist because a TPU has no IEEE f64; here every mode is
this one path.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..config import CUDA, Parms, bitrev
from ..golden.encode import calc_index_map

ENCODE_MODES = ("sf", "f64", "dd")

# |coeff| bound of the overflow flag: float(0x7FFFFFFFFFFFFFFF) == 2^63.
_I64_BOUND = float(np.float64(0x7FFFFFFFFFFFFFFF))


@lru_cache(maxsize=32)
def index_map_np(n: int) -> np.ndarray:
    """Precomputed index map (ckks_common.c:32-68), int32."""
    return calc_index_map(n, n.bit_length() - 1).astype(np.int32)


@lru_cache(maxsize=32)
def ifft_root_tables(n: int) -> tuple[tuple[np.ndarray, np.ndarray], ...]:
    """Per-round conjugated roots, f64 (re, im), group-indexed.

    Round r (tt = 2^r, h = n >> (r+1)) uses s_j = conj(W^bitrev(h+j, logn))
    for groups j = 0..h-1 (fft.c:119-143), computed with libm cos/sin
    exactly like the reference.
    """
    logn = n.bit_length() - 1
    m = 2 * n
    out = []
    h = n // 2
    for _ in range(logn):
        re = np.zeros(h, dtype=np.float64)
        im = np.zeros(h, dtype=np.float64)
        for j in range(h):
            k = bitrev(h + j, logn) & (m - 1)
            ang = 2.0 * math.pi * float(k) / float(m)
            re[j] = math.cos(ang)
            im[j] = -math.sin(ang)  # conjugate
        out.append((re, im))
        h //= 2
    return tuple(out)


def ifft_root_tables_from_file(path: str, n: int):
    """Per-round IFFT root tables from an adapter-format roots file (the
    SE_IFFT_LOAD_FULL path, fileops.c:226-255): the file's roots from
    index 1 on, in (round, group) order (fft.c:108-126), split into the
    rounds of ifft_root_tables, bit for bit."""
    from ..io.serialize import read_ifft_roots
    raw = read_ifft_roots(path, n)
    re_all, im_all = raw[0::2], raw[1::2]
    out = []
    idx, h = 1, n // 2
    for _ in range(n.bit_length() - 1):
        out.append((re_all[idx:idx + h].copy(), im_all[idx:idx + h].copy()))
        idx, h = idx + h, h // 2
    return tuple(out)


@lru_cache(maxsize=32)
def fft_root_tables(n: int) -> tuple[tuple[np.ndarray, np.ndarray], ...]:
    """Per-round forward (decode) roots (fft.c:183-213): round r has
    h = 2^r groups, s_j = W^bitrev(h+j, logn)."""
    logn = n.bit_length() - 1
    m = 2 * n
    out = []
    h = 1
    for _ in range(logn):
        re = np.zeros(h, dtype=np.float64)
        im = np.zeros(h, dtype=np.float64)
        for j in range(h):
            k = bitrev(h + j, logn) & (m - 1)
            ang = 2.0 * math.pi * float(k) / float(m)
            re[j] = math.cos(ang)
            im[j] = math.sin(ang)
        out.append((re, im))
        h *= 2
    return tuple(out)


@lru_cache(maxsize=32)
def ifft_tables_flat(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The per-round tables concatenated, (n - 1,) f64 each: round r starts
    at offset n - (n >> r), the layout kernel KE reads."""
    rounds = ifft_root_tables(n)
    return (np.concatenate([re for re, _ in rounds]),
            np.concatenate([im for _, im in rounds]))


def scale_over_n(parms: Parms) -> float:
    """scale / n, rounded once in f64 as the reference computes it."""
    return float(np.float64(parms.scale) / np.float64(parms.degree))


def encode_tables(values, imap, tw_re, tw_im, scale_n: float):
    """Encode with explicit tables: the plain version of KE.

    values: float32 (B, vlen <= n/2); imap: int32 (n,) index map; tw_re,
    tw_im: float64 (n - 1,) flattened IFFT roots (ifft_tables_flat);
    scale_n: scale / n.  Returns (coeff int64 (B, n), ok bool (B,)), ok
    False where some |coeff| exceeds 2^63 (the int64 cast of such a row
    is not defined).
    """
    n = imap.shape[0]
    batch = values.shape[:-1]
    vlen = values.shape[-1]
    idx = imap.to(torch.int64)
    v = values.to(torch.float64)
    re = torch.zeros(batch + (n,), dtype=torch.float64, device=values.device)
    re[..., idx[:vlen]] = v
    re[..., idx[n // 2:n // 2 + vlen]] = v
    im = torch.zeros_like(re)

    # IFFT rounds (fft.c:117-144): u' = u + w, w' = (u - w) * s.
    tt, h = 1, n // 2
    while h >= 1:
        off = n - 2 * h
        sre = tw_re[off:off + h].reshape(h, 1)
        sim = tw_im[off:off + h].reshape(h, 1)
        re_v = re.reshape(batch + (h, 2, tt))
        im_v = im.reshape(batch + (h, 2, tt))
        ure, uim = re_v[..., 0, :], im_v[..., 0, :]
        wre, wim = re_v[..., 1, :], im_v[..., 1, :]
        dre, dim = ure - wre, uim - wim
        re = torch.stack([ure + wre, dre * sre - dim * sim],
                         dim=-2).reshape(batch + (n,))
        im = torch.stack([uim + wim, dre * sim + dim * sre],
                         dim=-2).reshape(batch + (n,))
        tt, h = tt * 2, h // 2

    x = re * scale_n
    # C99 round(): half away from zero (ckks_common.c:192).
    coeff = torch.where(x < 0, -torch.floor(-x + 0.5), torch.floor(x + 0.5))
    ok = (torch.abs(coeff) <= _I64_BOUND).all(dim=-1)
    return coeff.to(torch.int64), ok


def table_tensors(n: int, device=None, root_tables=None, imap=None):
    """(imap int32, tw_re f64, tw_im f64) tensors for degree n.

    root_tables: optional per-round IFFT tables ((re, im) per round, the
    JAX package's format, e.g. loaded from an adapter roots file: the
    SE_IFFT_LOAD_FULL path), flattened to KE's (n - 1,) layout; imap:
    optional loaded index map (SE_INDEX_MAP_LOAD).  Both default to the
    computed tables, which are bit-identical."""
    if root_tables is None:
        tw_re, tw_im = ifft_tables_flat(n)
    else:
        tw_re = np.concatenate([np.asarray(re, np.float64)
                                for re, _ in root_tables])
        tw_im = np.concatenate([np.asarray(im, np.float64)
                                for _, im in root_tables])
    imap = index_map_np(n) if imap is None else np.asarray(imap, np.int32)
    return (torch.as_tensor(imap, device=device),
            torch.as_tensor(tw_re, device=device),
            torch.as_tensor(tw_im, device=device))


def encode(values, parms: Parms, root_tables=None, imap=None):
    """values f32 (B, <= n/2) -> (conj_vals_int int64 (B, n), ok (B,)),
    the plain f64 path on whatever device `values` lies; root_tables and
    imap as table_tensors."""
    return encode_tables(values, *table_tensors(parms.degree, values.device,
                                                root_tables, imap),
                         scale_over_n(parms))


def check_encode_mode(mode: str) -> None:
    if mode not in ENCODE_MODES:
        raise ValueError(f"unknown encode mode {mode!r}")


def encode_any(values, parms: Parms, mode: str = "sf", root_tables=None,
               imap=None):
    """Encode through kernel KE's wrapper.  Every mode of the JAX package
    ('sf', 'f64', 'dd') is the one bit-exact IEEE f64 encode here;
    root_tables and imap as table_tensors."""
    from .kernels.encode import encode_f64
    check_encode_mode(mode)
    return encode_f64(values, *table_tensors(parms.degree, values.device,
                                             root_tables, imap),
                      scale_over_n(parms))


class Decoder(nn.Module):
    """Decode oracle for one parameter set (test side, like the
    reference's check_decode_decrypt_inpl), with its tables resident on
    `device` as buffers: the forward-FFT roots of every round,
    concatenated (round r, of 2^r groups, at offset 2^r - 1), and the
    index map's first half.

    forward(pte_signed int64 (..., n)) returns the n/2 real slot values
    (..., n/2), float64: the forward FFT in separate re/im f64 planes
    (fft.c:146-213), then division by the scale and the index map.  The
    JAX package has no kernel for it; here too it is plain torch."""

    def __init__(self, parms: Parms, device=CUDA):
        super().__init__()
        n = parms.degree
        self.degree = n
        self.scale = float(parms.scale)
        rounds = fft_root_tables(n)
        for name, part in (("fft_re", 0), ("fft_im", 1)):
            self.register_buffer(name, torch.as_tensor(
                np.concatenate([r[part] for r in rounds]), device=device))
        self.register_buffer("imap", torch.as_tensor(
            index_map_np(n)[: n // 2].astype(np.int64), device=device))

    def forward(self, pte_signed):
        n = self.degree
        batch = pte_signed.shape[:-1]
        re = pte_signed.to(torch.float64)
        im = torch.zeros_like(re)
        h, tt = 1, n // 2
        while tt >= 1:
            sre = self.fft_re[h - 1:2 * h - 1].reshape(h, 1)
            sim = self.fft_im[h - 1:2 * h - 1].reshape(h, 1)
            re_v = re.reshape(batch + (h, 2, tt))
            im_v = im.reshape(batch + (h, 2, tt))
            ure, uim = re_v[..., 0, :], im_v[..., 0, :]
            wre = re_v[..., 1, :] * sre - im_v[..., 1, :] * sim
            wim = re_v[..., 1, :] * sim + im_v[..., 1, :] * sre
            re = torch.stack([ure + wre, ure - wre],
                             dim=-2).reshape(batch + (n,))
            im = torch.stack([uim + wim, uim - wim],
                             dim=-2).reshape(batch + (n,))
            h, tt = h * 2, tt // 2
        return (re / self.scale)[..., self.imap]


@lru_cache(maxsize=16)
def _decoder(parms: Parms, device: torch.device) -> Decoder:
    return Decoder(parms, device)


def decode(pte_signed, parms: Parms):
    """Decode signed int64 coefficients (..., n) on their device: the
    cached Decoder of (parms, device)."""
    return _decoder(parms, pte_signed.device)(pte_signed)


@lru_cache(maxsize=16)
def make_decoder(parms: Parms, device=CUDA):
    """decode bound to its parameters, compiled per input signature on
    `device` (the card unless told otherwise), as the JAX package's cached
    jit: fn(pte_signed) -> float64 (..., n/2)."""
    from ..graphs import graphed   # graphs imports the kernels, which import this
    return graphed(_decoder(parms, torch.device(device)), device)
