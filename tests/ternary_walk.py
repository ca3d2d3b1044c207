"""A sequential reference of the walk that KK's ternary role
(seal_embedded_tpu_torch/csrc/keccak.cu keccak_ternary_kernel) makes over
a stream's counters, in its own indexing: windows of W consecutive
counters squeezed at once into a ring of W + 32 slots (word k of slot i at
row k, column i), lane t of the walking warp holding bytes 3t .. 3t + 2 of
a block's base, 32-bit ballots of the rejected bytes and of the accepted
refills, the j-th rejected byte given the j-th accepted refill through
`taken`, 32 refills a step, and the next window squeezed when the walk
comes within 33 counters (a block's start) or 32 (a refill step) of the
window's end.  The tests hold it against the C loop (sample.c:218-242) on
real and on made-up bytes, so the kernel's rule is checked on blocks that
real draws seldom give (more than 32 refills)."""

import numpy as np
import torch

from seal_embedded_tpu_torch.ops import keccak as kc

BYTES = 96
LOOK = 32
WORDS = 24
MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1


def _popc(x: int) -> int:
    return bin(x).count("1")


def _ballot(flags) -> int:
    return sum(1 << t for t, f in enumerate(flags) if f)


def _ffs(x: int) -> int:
    return (x & -x).bit_length()


def shake_squeeze(seed_words):
    """squeeze(counters) -> int64 (K, 24): the first 24 u32 words of
    SHAKE-256(seed || counter) for each u64 counter, through
    ops.keccak.shake256_words.  seed_words: int64 (16,)."""
    seed = torch.as_tensor(np.asarray(seed_words, dtype=np.int64))

    def squeeze(counters):
        c = torch.tensor([[v & MASK32, v >> 32] for v in counters],
                         dtype=torch.int64)
        return kc.shake256_words(seed, c, 1, nwords=WORDS).numpy()
    return squeeze


def kernel_walk(squeeze, n: int, c0: int, window: int):
    """The role's draw of one stream at u64 counter c0, its counters
    squeezed by squeeze (as shake_squeeze's).  Returns (u int64 (n,),
    next counter, counters squeezed)."""
    slots = window + LOOK
    ring = np.full((WORDS, slots), -1, dtype=np.int64)
    nblocks = -(-n // BYTES)
    tail = n - (nblocks - 1) * BYTES
    u = np.full(n, 99, dtype=np.int64)
    filled = p = q = 0
    b = need = got = 0
    mid = False
    v = np.zeros((32, 3), dtype=np.int64)
    rank = np.full((32, 3), -1, dtype=np.int64)
    while True:
        offs = range(filled, filled + window)
        words = squeeze([(c0 + o) & MASK64 for o in offs])
        for i, o in enumerate(offs):
            ring[:, o % slots] = words[i]
        filled += window
        while True:
            here = tail if b == nblocks - 1 else BYTES
            if not mid:
                if b == nblocks or filled - p < LOOK + 1:
                    break
                slot = p % slots
                rej = np.zeros((32, 3), dtype=bool)
                for t in range(32):
                    for i in range(3):
                        j = 3 * t + i
                        word = ring[j >> 2, slot]
                        assert word >= 0, "a base read outside the window"
                        v[t, i] = (word >> (8 * (j & 3))) & 0xFF
                        rej[t, i] = j < here and v[t, i] >= 0xFE
                balls = [_ballot(rej[:, i]) for i in range(3)]
                for t in range(32):
                    below = (1 << t) - 1
                    r = sum(_popc(bl & below) for bl in balls)
                    for i in range(3):
                        rank[t, i] = r + int(rej[t, :i].sum()) if rej[t, i] \
                            else -1
                need = sum(_popc(bl) for bl in balls)
                got = 0
                q = p + 1
                mid = need > 0
            if mid:
                if filled - q < LOOK:
                    break
                x = [int(ring[0, (q + t) % slots]) for t in range(32)]
                assert min(x) >= 0, "a refill read outside the window"
                x = [w & 0xFF for w in x]
                acc = [w < 0xFE for w in x]
                a = _ballot(acc)
                k = [got + _popc(a & ((1 << t) - 1)) for t in range(32)]
                taken = {}
                for t in range(32):
                    if acc[t] and k[t] < need:
                        taken[k[t]] = x[t]
                upto = min(need, got + _popc(a))
                for t in range(32):
                    for i in range(3):
                        if got <= rank[t, i] < upto:
                            v[t, i] = taken[int(rank[t, i])]
                if upto < need:
                    got = upto
                    q += LOOK
                    continue
                p = q + _ffs(_ballot([acc[t] and k[t] == need - 1
                                      for t in range(32)]))
                mid = False
            else:
                p += 1
            for t in range(32):
                for i in range(3):
                    j = 3 * t + i
                    if j < here:
                        u[b * BYTES + j] = v[t, i] % 3 - 1
            b += 1
        if b == nblocks:
            return u, (c0 + p) & MASK64, filled


def c_loop(squeeze, n: int, c0: int):
    """The C loop (sample.c:218-242) over the same bytes, one counter at a
    time: (u int64 (n,), next counter, the most refills a block took)."""
    def byte_of(c, j):
        w = int(squeeze([c])[0][j >> 2])
        return (w >> (8 * (j & 3))) & 0xFF

    out, c, most = [], c0, 0
    for j0 in range(0, n, BYTES):
        base = c
        c = (c + 1) & MASK64
        for j in range(min(BYTES, n - j0)):
            x = byte_of(base, j)
            while x >= 0xFE:
                x = byte_of(c, 0)
                c = (c + 1) & MASK64
            out.append(x % 3 - 1)
        most = max(most, (c - base - 1) & MASK64)
    return np.array(out, dtype=np.int64), c, most
