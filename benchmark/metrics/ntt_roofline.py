"""ntt_roofline (%): the NTT role's bound over the device time of the
kernels named ntt_kernel and ntt_asym_kernel (csrc/ntt.cu: KN, KA) in
the traced segment.

The bound counts the transforms a call needs, n/2 log2(n) butterflies
each at 4 integer instructions: sym, ntt(pte) for every message and
prime and ntt(s) for every prime; asym, ntt(u), ntt(e1) and ntt(pte) for
every message and prime.  Bytes, each input and output once at the
width it needs, at the HBM rate (peaks.py): sym, pte (int64) and a (u32
a prime) in, c0 (u32 a prime) out, s and ntt(s); asym, pte, u and e1 (a
byte each) and pk0, pk1 in, c0 and c1 out.
"""

from benchmark import peaks


def butterflies(n: int, nprimes: int, batch: int, kind: str) -> int:
    per = n // 2 * (n.bit_length() - 1)
    if kind == "sym":
        return nprimes * (batch + 1) * per
    return 3 * nprimes * batch * per


def nbytes(n: int, nprimes: int, batch: int, kind: str) -> int:
    if kind == "sym":
        return batch * (8 * n + 8 * n * nprimes) + n + 4 * n * nprimes
    return batch * (8 * n + 2 * n + 8 * n * nprimes) + 8 * n * nprimes


def bound_s(n, nprimes, batch, kind, sm_hz) -> float:
    """The least time a call's NTT role could take."""
    return peaks.bound_s(
        butterflies(n, nprimes, batch, kind) * peaks.INSTR_PER_BUTTERFLY,
        nbytes(n, nprimes, batch, kind), sm_hz)


def read(obs):
    from benchmark.trace import kernel_name
    seg, sm_hz = obs.segment, obs.card.get("sm_hz")
    if seg is None or not seg.calls or not sm_hz:
        return None
    us = seg.time_us(lambda name: kernel_name(name) in (
        "ntt_kernel", "ntt_asym_kernel"))
    if us <= 0:
        return None
    p = obs.params
    bound = bound_s(p.degree, p.nprimes, obs.batch, obs.kind, sm_hz)
    return 100.0 * bound * seg.calls / (us * 1e-6)
