"""SEAL's seeded symmetric ciphertext, sent per prime: each prime's c0,
and c1 = a only as the message's 64-byte shareable seed
(seal_embedded.c:184-194, SE_ENABLE_SYM_SEED_CT; defines.h:62-67 keeps
the 64-byte seed so that the output stays compatible with SEAL's
compressed ciphertexts, whose save writes the seed of c1 in place of c1:
Microsoft SEAL 3.7, Encryptor::encrypt_symmetric).

Per prime of the chain's walk, per message of the batch, one chunk: at the
walk's first prime the message's 64-byte shareable seed followed by c0's n
coefficients as little-endian u32 (64 + 4n bytes), at every later prime c0
alone (4n bytes).  A limb is B chunks; a call sends L limbs.  The call
returns c0 only.  The receiver draws c1 again from the seed, as `complete`
does after the window.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import sampling as sp

KWARGS = {"seed_only": True}     # se_encrypt_streaming's per-prime seed form
KINDS = ("sym",)
RETURNS = ("c0",)
COEFF = np.dtype("<u4")          # uint32 on the little-endian hosts it runs on
SEED = sp.SEED_BYTES


def limb_chunks(batch: int) -> int:
    return batch


class Messages:
    """Message b's (c0 uint32 (L, n), 64-byte shareable seed), read from
    the chunks of one call on demand, copied out of them; a message with a
    chunk missing or of the wrong length reads as an empty array and no
    seed, so each of its coefficients counts as unequal to the
    reference."""

    def __init__(self, chunks, params, batch: int, sizes: list):
        self.chunks = chunks
        self.sizes = sizes
        self.limbs = params.nprimes
        self.batch = batch
        self.size = params.degree * COEFF.itemsize

    def __len__(self) -> int:
        return self.batch

    def __getitem__(self, b: int) -> tuple:
        at = range(b, self.limbs * self.batch, self.batch)
        if any(i >= len(self.sizes)
               or self.sizes[i] != self.size + (j == 0) * SEED
               for j, i in enumerate(at)):
            return np.zeros(0, np.uint32), b""
        first = memoryview(self.chunks[b]).cast("B")
        c0 = np.stack([np.frombuffer(first[SEED:], COEFF)]
                      + [np.frombuffer(memoryview(self.chunks[i]).cast("B"),
                                       COEFF) for i in at[1:]])
        return c0, bytes(first[:SEED])


def read(chunks, params, batch: int) -> tuple:
    """(Messages of the call, bad): bad counts the chunks missing or extra
    against L limbs of B chunks, and those not 64 + 4n bytes long at the
    walk's first limb and 4n after (a first-limb chunk sent without its
    seed is 4n long).  A chunk out of place within a limb shows where its
    bytes are compared (harness.astray, check.py)."""
    size = params.degree * COEFF.itemsize
    sizes = [memoryview(c).nbytes for c in chunks]     # bytes or views
    bad = abs(len(chunks) - params.nprimes * limb_chunks(batch))
    bad += len(sizes[:batch]) - sizes[:batch].count(size + SEED)
    bad += len(sizes[batch:]) - sizes[batch:].count(size)
    return Messages(chunks, params, batch, sizes), bad


def complete(got, params) -> tuple:
    """One kept message's (c0, c1) uint32 (L, n), c1 drawn from its seed
    as reference/ckks.sym_encrypt draws a: one Prng(seed), then
    uniform(prng, n, q) for each prime of the walk, the counter carried
    from prime to prime.  The harness walks the chain forward
    (harness.ORDER), so the walk's primes are the chain's in order.  A
    message that read as empty stays empty in both halves."""
    c0, seed = got
    if c0.shape != (params.nprimes, params.degree):
        return c0, c0
    prng = sp.Prng(seed)
    c1 = np.stack([sp.uniform(prng, params.degree, q)
                   for q in params.moduli])
    return c0, c1.astype(np.uint32)
