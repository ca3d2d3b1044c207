"""A parameter set as the reference reads it from a configuration file."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Params:
    """degree n, the prime chain, the CKKS scale, and each prime's
    first-power negacyclic NTT root (SEAL-Embedded ntt.c:199-292)."""
    degree: int
    moduli: tuple
    scale: float
    roots: tuple

    @property
    def logn(self) -> int:
        return self.degree.bit_length() - 1

    @property
    def nprimes(self) -> int:
        return len(self.moduli)


def from_config(cfg: dict) -> Params:
    """The Params of a configuration file's dict."""
    p = Params(int(cfg["degree"]), tuple(int(q) for q in cfg["moduli"]),
               float(cfg["scale"]), tuple(int(w) for w in cfg["ntt_roots"]))
    if len(p.roots) != len(p.moduli):
        raise ValueError("one NTT root per prime")
    for q, w in zip(p.moduli, p.roots):
        if q % (2 * p.degree) != 1 or pow(w, p.degree, q) != q - 1:
            raise ValueError(f"{w} is no primitive 2n-th root mod {q}")
    return p


def bitrev(x: int, bits: int) -> int:
    """The lowest `bits` bits of x reversed (fft.h:48-55)."""
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r
