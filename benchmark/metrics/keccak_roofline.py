"""keccak_roofline (%): the Keccak role's bound over the device time of
the kernels named keccak_* (csrc/keccak.cu) in the traced segment.

The bound counts the work the role needs for a call's inputs, whoever
computes it: the SHAKE-256 permutations of
* sym, per message: the uniform base draw, ceil(4n / 136) a prime; its
  redraws, n p / (1 - p) a prime expected, p the share of 32-bit words
  at or above the prime's max_multiple (sample.c:39-57); the CBD error's
  n / 16 fills;
* asym, per message: the ternary u's ceil(n / 96) blocks and its
  expected n r / (1 - r) one-byte redraws, r = 2/256; the CBD e0's and
  e1's n / 16 fills each;
at 4,152 integer instructions a permutation, against the bytes in (the
64-byte seeds) and out (sym: a as u32 on every prime, the CBD values a
byte each; asym: u, e0, e1 a byte each) at the HBM rate (peaks.py).
"""

import math

from benchmark import peaks


def rejected(q: int) -> float:
    """The share of 32-bit words the uniform draw mod q redraws."""
    max_multiple = 0xFFFFFFFF - (0xFFFFFFFF % q) - 1
    return (2 ** 32 - max_multiple) / 2 ** 32


def permutations(n: int, moduli, batch: int, kind: str) -> float:
    if kind == "sym":
        per = n / 16
        for q in moduli:
            p = rejected(q)
            per += math.ceil(4 * n / 136) + n * p / (1 - p)
    else:
        r = 2 / 256
        per = math.ceil(n / 96) + n * r / (1 - r) + 2 * n / 16
    return batch * per


def nbytes(n: int, nprimes: int, batch: int, kind: str) -> int:
    if kind == "sym":
        return batch * (2 * 64 + 4 * n * nprimes + n)
    return batch * (64 + 3 * n)


def bound_s(n, moduli, batch, kind, sm_hz) -> float:
    """The least time a call's Keccak role could take."""
    return peaks.bound_s(
        permutations(n, moduli, batch, kind) * peaks.INSTR_PER_PERMUTATION,
        nbytes(n, len(moduli), batch, kind), sm_hz)


def read(obs):
    from benchmark.trace import kernel_name
    seg, sm_hz = obs.segment, obs.card.get("sm_hz")
    if seg is None or not seg.calls or not sm_hz:
        return None
    us = seg.time_us(lambda name: kernel_name(name).startswith("keccak_"))
    if us <= 0:
        return None
    p = obs.params
    bound = bound_s(p.degree, p.moduli, obs.batch, obs.kind, sm_hz)
    return 100.0 * bound * seg.calls / (us * 1e-6)
