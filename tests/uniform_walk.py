"""A sequential reference of the walk that KK's uniform role
(seal_embedded_tpu_torch/csrc/keccak.cu keccak_uniform_kernel) makes over
a row, in its own indexing: blocks of 34 words, word 2t and 2t + 1 of a
block in lane t, 32-bit ballots of the rejection flags, a running rank
before each block, per-chunk counts with the chunk boundary between two
lanes, and the kept ranks' ballots.  The tests hold it against the torch
rank-select (ops/sampling.py _rank_select), so the kernel's rule is
checked on masks that real draws seldom give."""

import numpy as np

RATE_WORDS = 34
FULL = 0xFFFFFFFF


def _popc(x: int) -> int:
    return bin(x).count("1")


def _ballot(flags) -> int:
    return sum(1 << t for t, f in enumerate(flags) if f)


def kernel_walk(base, rejected, queue_vals, queue_acc, chunk_n, chunk_k):
    """base, rejected: (B, n); queue_vals, queue_acc: (B, cap).  Returns
    (final values (B, n), consumed (B,), ok (B,)) as the kernel leaves
    them before barrett32."""
    base = np.asarray(base)
    B, n = base.shape
    cap = queue_vals.shape[-1]
    final = base.copy()
    consumed = np.zeros(B, dtype=np.int64)
    ok = np.ones(B, dtype=bool)
    for r in range(B):
        # The warp's queue: accepted draws first, each group in queue order.
        acc = np.concatenate([queue_vals[r][queue_acc[r]],
                              queue_vals[r][~queue_acc[r]]])
        nacc = int(queue_acc[r].sum())
        rej = kept = in_chunk = 0
        chunk_end = chunk_n
        for b in range(-(-n // RATE_WORDS)):
            first = b * RATE_WORDS
            idx = [(first + 2 * t, first + 2 * t + 1) for t in range(32)]
            valid = [t < 17 and idx[t][0] < n for t in range(32)]
            r0 = [valid[t] and bool(rejected[r, idx[t][0]]) for t in range(32)]
            r1 = [valid[t] and bool(rejected[r, idx[t][1]]) for t in range(32)]
            b0, b1 = _ballot(r0), _ballot(r1)
            closes = chunk_end - first <= RATE_WORDS
            tb = (chunk_end - first) // 2 if closes else 32
            open_ = FULL if tb >= 32 else (1 << tb) - 1
            before = here = 0
            if b0 | b1:
                k0, k1 = [False] * 32, [False] * 32
                for t in range(32):
                    below = (1 << t) - 1
                    if t < tb:
                        rank0 = in_chunk + _popc(b0 & below) + _popc(b1 & below)
                    else:
                        rank0 = (_popc(b0 & below & ~open_)
                                 + _popc(b1 & below & ~open_))
                    rank1 = rank0 + r0[t]
                    k0[t] = r0[t] and rank0 < chunk_k
                    k1[t] = r1[t] and rank1 < chunk_k
                kb0, kb1 = _ballot(k0), _ballot(k1)
                for t in range(32):
                    below = (1 << t) - 1
                    m0 = kept + _popc(kb0 & below) + _popc(kb1 & below)
                    m1 = m0 + k0[t]
                    if k0[t] and m0 < cap:
                        final[r, idx[t][0]] = acc[m0]
                    if k1[t] and m1 < cap:
                        final[r, idx[t][1]] = acc[m1]
                kept += _popc(kb0) + _popc(kb1)
                here = _popc(b0) + _popc(b1)
                before = _popc(b0 & open_) + _popc(b1 & open_)
                rej += here
            if closes:
                ok[r] &= in_chunk + before <= chunk_k
                in_chunk = here - before
                chunk_end += chunk_n
            else:
                in_chunk += here
        if 0 < rej <= nacc:
            consumed[r] = np.flatnonzero(queue_acc[r])[rej - 1] + 1
        elif rej > 0:
            ok[r] = False
            consumed[r] = cap + 1
    return final, consumed, ok
