"""What decides `correct`: the timed path's ciphertexts against the plain
reference, at the timed sizes.

The window keeps, for a sample of its calls drawn from the seed, one
message each as it reached host memory (every limb's c0 and c1, in the
order the stream yielded them), and the first and last message of its
last call.  Once the window has closed and the program's state is freed,
the reference (``reference/``) encrypts those messages again from the
same inputs (values, seeds, the secret key; for asym the public key it
derives itself from the pk seed), and every coefficient is compared.
Each number below is held to its limit (`LIMITS`); every one is exact,
so every limit is 0.
"""

from __future__ import annotations

import numpy as np

from .reference import ckks
from .reference.params import Params

LIMITS = {
    "failed_messages": 0,     # messages of calls that raised
    "walk_errors": 0,         # limbs out of the chain's order, or ok false
    "coeff_mismatches": 0,    # c0, c1 coefficients unequal to the reference
    "pk_mismatches": 0,       # asym: pk coefficients unequal
}


def reference_rows(p: Params, kind: str, sk, pk, messages,
                   dtype=np.float64):
    """The reference's (c0, c1) int64 (L, R, n) of `messages`, a list of
    (values, shareable seed, private seed)."""
    values = np.stack([m[0] for m in messages])
    seeds = [m[2] for m in messages]
    if kind == "sym":
        return ckks.sym_encrypt(p, sk, values, [m[1] for m in messages],
                                seeds, dtype)
    return ckks.asym_encrypt(p, pk[0], pk[1], values, seeds, dtype)


def numbers(p: Params, kind: str, sk, pk_seed: bytes, kept, messages,
            failed: int, walk_errors: int, program_pk=None) -> dict:
    """The compared numbers: kept[i] = (c0, c1) uint32 (L, n) of
    messages[i] as the program returned them; program_pk the public key
    set-up made (asym)."""
    pk = ckks.public_key(p, sk, pk_seed) if kind == "asym" else None
    out = {"failed_messages": failed, "walk_errors": walk_errors}
    mism = 0
    block = 16      # messages a reference call, to bound its memory
    for at in range(0, len(messages), block):
        c0, c1 = reference_rows(p, kind, sk, pk, messages[at:at + block])
        for j, got in enumerate(kept[at:at + block]):
            for g, want in zip(got, (c0[:, j], c1[:, j])):
                # A limb missing or out of shape counts all of its
                # coefficients.
                mism += (int(np.count_nonzero(g != want))
                         if g.shape == want.shape else want.size)
    out["coeff_mismatches"] = mism
    if kind == "asym":
        out["pk_mismatches"] = sum(
            int(np.count_nonzero(np.asarray(got, np.int64) != want))
            for got, want in zip(program_pk, pk))
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in out.items()}


def correct(nums: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in nums.values())
