"""Limb-sharded (tensor-parallel) encrypt pipelines on torch.distributed.

Port of ``seal_embedded_tpu/parallel/limbwise.py``.  The RNS limb axis
is embarrassingly parallel once the PRNG layout decouples the per-prime
uniform streams (the "parallel" counter layout of ckks/limbwise.py: prime
i's stream starts at counter i * PARALLEL_COUNTER_STRIDE).  Here each
rank owns L / n_limb primes end to end: its uniform draws (KK), ntt(s)
and the fused NTT of pte with the c0 epilogue (KN), or for asym the
three NTTs and the public-key combine (KA).

Per rank, on a ("data", "limb") mesh, or with data_axis a tuple of axes
(("host", "data") on multihost's mesh):

1. the front end (encode with KE, CBD error with KK; for asym also the
   ternary u, e0 and e1) on its B / (n_data * n_limb) rows, the rows
   ``multihost.shard_inputs`` gives it;
2. one all-gather over the limb group, so that every rank of the group
   holds its data block's rows (sym: pte, the share seed words and the
   encode flag; asym: u, e1, pte and the flag), packed in one int64
   tensor;
3. its primes;
4. sym only: the AND of ok over the limb group (each rank's samplers
   flag its own primes).

Bit-exactness: the outputs are the blocks of the single-device
LimbscanEncryptor(parms, "parallel") (sym) or AsymEncryptor (asym):
counters start at the prime's global index times the stride, and the
queue bound is the whole chain's.
"""

from __future__ import annotations

import torch

from ..ckks.asym import AsymEncryptor
from ..ckks.limbwise import PARALLEL_COUNTER_STRIDE, LimbscanEncryptor
from ..config import Parms
from ..graphs import graphed
from ..ops import sampling as sp
from ..ops.encode import check_encode_mode
from . import comm
from .mesh import Shards, axis_index, block, limb_block, mesh_device


def _layout(mesh, parms, data_axis, limb_axis):
    """(this rank's primes, its data block index, the limb group, the
    index of its front-end block among all ranks' front-end blocks)."""
    limbs = limb_block(mesh, parms, limb_axis)
    d, _ = axis_index(mesh, data_axis)
    l, n_limb = axis_index(mesh, limb_axis)
    return limbs, d, mesh.get_group(limb_axis), d * n_limb + l


def _gather(group, *cols):
    """All-gather the (r, w_i) int64 columns over the limb group as one
    tensor: the data block's rows, split back into the columns."""
    widths = [c.shape[1] for c in cols]
    full = comm.all_gather_rows(torch.cat(cols, dim=1), group)
    return [t.contiguous() for t in torch.split(full, widths, dim=1)]


def make_limb_sharded_encryptor(mesh, parms: Parms,
                                encode_mode: str = "f64",
                                data_axis="data", limb_axis: str = "limb"):
    """Symmetric batched encode + encrypt, the limb axis sharded over
    `limb_axis` and the batch over `data_axis` and `limb_axis`.

    Returns fn(values, sk_signed, share_words, err_words) -> Shards with
    c0, c1 (this rank's primes, its data block's rows), pte and ok (its
    data block's rows) and pt (its own rows).  values, share_words and
    err_words are this rank's rows, sk_signed whole, all on the mesh's
    device.  Every encode_mode is the one bit-exact encode.  Compiled per
    input signature on the mesh's device (``graphs.graphed``), the
    all-gather and the ok reduce inside the graph."""
    check_encode_mode(encode_mode)
    n = parms.degree
    limbs, d, group, front = _layout(mesh, parms, data_axis, limb_axis)
    dev = mesh_device(mesh)
    enc = LimbscanEncryptor(parms, "parallel", device=dev)
    moduli = enc.moduli[limbs]

    def run(values, sk_signed, share_words, err_words):
        pt, pte, ok = enc.encode_with_error(values, err_words)
        pte, share, ok = _gather(group, pte, share_words,
                                 ok[:, None].to(torch.int64))
        a, ok_u = sp.sample_uniform_limbs(share, moduli, n, enc.queue_cap,
                                          PARALLEL_COUNTER_STRIDE,
                                          first=limbs.start)
        c0 = enc.c0_from_pte(pte, a, enc.ntt_secret(sk_signed, limbs),
                             limbs)
        ok = comm.all_and(ok[:, 0].bool() & ok_u, group)
        rows = block(d, pte.shape[0])
        return Shards({"c0": c0, "c1": a, "pte": pte, "pt": pt, "ok": ok},
                      {"c0": (limbs, rows), "c1": (limbs, rows),
                       "pte": (rows,), "ok": (rows,),
                       "pt": (block(front, pt.shape[0]),)})
    return graphed(run, dev)


def make_asym_limb_sharded_encryptor(mesh, parms: Parms,
                                     encode_mode: str = "f64",
                                     data_axis="data",
                                     limb_axis: str = "limb"):
    """Asymmetric batched encode + encrypt, the limb axis sharded: rank l
    of the limb group keeps only pk[l * L/n_limb : (l+1) * L/n_limb]
    resident (an AsymEncryptor on its primes, its key set per call).  The
    per-prime step has no cross-prime PRNG dependency at all
    (ckks_asym.c:205-286), so no special counter layout is needed.

    Returns fn(values, pk0, pk1, seed_words) -> Shards with c0, c1 (this
    rank's primes, its data block's rows), pte and ok (its data block's
    rows) and pt (its own rows); values and seed_words are this rank's
    rows, pk0 and pk1 the whole (L, n) key, int64, all on the mesh's
    device.  Compiled per input signature there (``graphs.graphed``):
    the key's quotients and the all-gather run inside the graph, pk among
    its inputs (the encryptor's key buffers stay unused, so two
    signatures share no key)."""
    check_encode_mode(encode_mode)
    n = parms.degree
    limbs, d, group, front = _layout(mesh, parms, data_axis, limb_axis)
    dev = mesh_device(mesh)
    enc = AsymEncryptor(Parms(n, parms.moduli[limbs], parms.scale),
                        device=dev)

    def run(values, pk0, pk1, seed_words):
        key = enc.key(pk0[limbs], pk1[limbs])
        pt, pte, u, e1, ok = enc.prologue(values, seed_words)
        u, e1, pte, ok = _gather(group, u, e1, pte,
                                 ok[:, None].to(torch.int64))
        c0, c1 = enc.combine(u, e1, pte, key=key)
        rows = block(d, pte.shape[0])
        return Shards({"c0": c0, "c1": c1, "pte": pte, "pt": pt,
                       "ok": ok[:, 0].bool()},
                      {"c0": (limbs, rows), "c1": (limbs, rows),
                       "pte": (rows,), "ok": (rows,),
                       "pt": (block(front, pt.shape[0]),)})
    return graphed(run, dev)
