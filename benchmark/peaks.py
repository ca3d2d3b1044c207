"""The table of peaks a roofline share is taken against.

One NVIDIA H100 (SXM, NVIDIA's data sheet): 3.35 TB/s of HBM3 at the
full 700 W.  Integer instructions: 64 32-bit logic, shift, funnel-shift
or add results per clock per SM (the CUDA C++ Programming Guide's
throughput table, compute capability 9.0), on every SM at the card's
maximum SM clock, both read on the card (``device.card``).

What a role needs at least, in those instructions:

* a Keccak-f[1600] permutation on 32-bit halves: 24 rounds of theta's
  column parities (20 LOP3), their rotation by one (5 SHF), theta's XORs
  (50 LOP3), rho (47 SHF), chi (50 LOP3) and iota (1 LOP3), 173 a round,
  4,152 (the absorb not counted);
* a Harvey butterfly: the lazy correction and the two adds, 4 (its three
  products go to the FMA pipe).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_SM_CLOCK = 64
INSTR_PER_PERMUTATION = 4152
INSTR_PER_BUTTERFLY = 4


def int_rate(sm_hz: float) -> float:
    """Integer instructions per second of a card whose SMs times their
    maximum clock in Hz is `sm_hz`."""
    return INT_OPS_PER_SM_CLOCK * sm_hz


def bound_s(instructions: float, nbytes: float, sm_hz: float) -> float:
    """The least time the card could take: the larger of the instructions
    at the integer rate and the bytes at the HBM rate."""
    return max(instructions / int_rate(sm_hz), nbytes / HBM_BYTES_PER_S)
