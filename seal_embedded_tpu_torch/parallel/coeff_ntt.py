"""Coefficient-sharded (sequence-parallel) negacyclic NTT on
torch.distributed.

Port of ``seal_embedded_tpu/parallel/coeff_ntt.py``.  One transform of
degree n is sharded over the D ranks of a mesh axis, rank d owning the
contiguous coefficient block d of S = n/D.  The reference's stage loop
(device/lib/ntt.c:140-165, rounds h = 1..n/2 with pair distance
tt = n/2h) maps onto the ranks as:

* the first log2(D) stages have pair distance tt >= S: butterfly partners
  live on another rank, and the whole block sits inside one butterfly
  group, so its root is one scalar;
* the remaining stages are local: the block holds S/(2 tt) whole groups,
  whose roots are a contiguous slice of the bit-reversed Shoup table.

Two communication plans, selected by `variant`:

* "staged": one exchange of the whole block with rank d ^ (tt/S) per
  cross stage, log2(D) exchanges (batch_isend_irecv);
* "4step": one all-to-all transposes the blocks so each rank holds a
  (D, S/D) column panel, the log2(D) cross stages run locally over the
  panel's block axis, and a second all-to-all transposes back: two
  exchanges of S (D-1)/D words per rank.

Both are bit-exact against the single-device NTT (KN's ``ntt_fwd`` and
its plain version ``ops.ntt.ntt_limbs``): the cross stages combine only
elements of equal offset within a block, with the same lazy Harvey
accumulation and the same operation order.  The butterflies are torch
operations, as the JAX package's bodies are jnp; the lazy values, below
4q < 2^32, travel as int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graphs import graphed
from ..ops.modarith import MASK32, mul_mod_shoup_lazy
from ..ops.ntt import ntt_tables
from . import comm
from .mesh import mesh_device

VARIANTS = ("staged", "4step")


def _send_form(v):
    """u32 values in int64 -> the same bits as int32, for the wire."""
    return v.to(torch.int32)


def _recv_form(v):
    return v.to(torch.int64) & MASK32


def _corr(u, two_q: int):
    return torch.where(u >= two_q, u - two_q, u)


def _local_stages(v, op, quot, q: int, h: int, d: int):
    """The stages whose groups lie inside the block: v (R, S) block d,
    h the first of them."""
    R, S = v.shape
    tt = S // 2
    while tt >= 1:
        g = S // (2 * tt)                 # groups in the block
        lo = h + d * g                    # the block's first group
        s_op = op[lo:lo + g].reshape(1, g, 1)
        s_quot = quot[lo:lo + g].reshape(1, g, 1)
        vv = v.reshape(R, g, 2, tt)
        u = _corr(vv[:, :, 0], 2 * q)
        t = mul_mod_shoup_lazy(vv[:, :, 1], s_op, s_quot, q)
        v = torch.stack([u + t, u + 2 * q - t], dim=2).reshape(R, S)
        h, tt = h * 2, tt // 2
    v = torch.where(v >= 2 * q, v - 2 * q, v)
    return torch.where(v >= q, v - q, v)


def _staged(v, op, quot, q: int, n: int, d: int, group):
    """Cross stages as one block exchange each, then the local stages."""
    S = v.shape[1]
    h, tt = 1, n // 2
    while tt >= S:
        bdist = tt // S                   # partner distance in blocks
        recv = _recv_form(comm.exchange(_send_form(v), d ^ bdist, group))
        j = (d * S) // (2 * tt)           # the block's group
        u, w = (v, recv) if d & bdist == 0 else (recv, v)
        u = _corr(u, 2 * q)
        t = mul_mod_shoup_lazy(w, op[h + j], quot[h + j], q)
        v = u + t if d & bdist == 0 else u + 2 * q - t
        h, tt = h * 2, tt // 2
    return _local_stages(v, op, quot, q, h, d)


def _four_step(v, op, quot, q: int, D: int, d: int, group):
    """Transpose, the cross stages over the panel's block axis, transpose
    back, then the local stages."""
    R, S = v.shape
    C = S // D
    # panel[:, b, c] = block b's element at d*C + c.
    sent = v.reshape(R, D, C).permute(1, 0, 2)
    panel = _recv_form(comm.all_to_all(_send_form(sent), group))
    panel = panel.permute(1, 0, 2)                       # (R, D, C)
    h, ttb = 1, D // 2
    while ttb >= 1:
        pv = panel.reshape(R, h, 2, ttb, C)
        u = _corr(pv[:, :, 0], 2 * q)
        t = mul_mod_shoup_lazy(pv[:, :, 1], op[h:2 * h].reshape(1, h, 1, 1),
                               quot[h:2 * h].reshape(1, h, 1, 1), q)
        panel = torch.stack([u + t, u + 2 * q - t], dim=2).reshape(R, D, C)
        h, ttb = h * 2, ttb // 2
    back = _recv_form(comm.all_to_all(_send_form(panel.permute(1, 0, 2)),
                                      group))
    v = back.permute(1, 0, 2).reshape(R, S)
    return _local_stages(v, op, quot, q, h, d)


def ntt_coeff_sharded(mesh, n: int, q: int, axis: str = "data",
                      variant: str = "4step"):
    """The forward NTT mod q of degree n, coefficient-sharded over the
    ranks of `mesh`'s axis `axis`.

    variant: "4step" (two all-to-alls; it becomes "staged" where the panel
    would be thinner than one column, n/D < D, as in the JAX package) or
    "staged" (one exchange per cross stage).  Returns fn(x) for x int64
    (..., n/D), this rank's block of u32 values below 4q: this rank's
    block of the canonical NTT, in bit-reversed order as ops.ntt's.
    Compiled per input signature on the mesh's device (``graphs.graphed``;
    the JAX package's cache keys on the number of batch axes, which the
    signature covers), the all-to-alls or exchanges inside the graph."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    dim = mesh.mesh_dim_names.index(axis)
    D, d = mesh.size(dim), mesh.get_local_rank(axis)
    if n % D or n // D < 2:
        raise ValueError(f"n = {n} does not split into blocks of at least "
                         f"2 over {D} ranks")
    S = n // D
    if variant == "4step" and S < D:
        variant = "staged"
    q = int(q)
    dev = mesh_device(mesh)
    op, quot = (torch.as_tensor(t.astype(np.int64), device=dev)
                for t in ntt_tables(n, q))
    group = mesh.get_group(axis)

    def call(x):
        if x.shape[-1] != S:
            raise ValueError(f"x's last axis must be this rank's block of "
                             f"{S}, got {x.shape[-1]}")
        v = x.reshape(-1, S).to(torch.int64)
        if variant == "staged":
            v = _staged(v, op, quot, q, n, d, group)
        else:
            v = _four_step(v, op, quot, q, D, d, group)
        return v.reshape(x.shape)
    return graphed(call, dev)
