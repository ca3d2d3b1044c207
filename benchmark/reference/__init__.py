"""The plain reference the benchmark holds the program's ciphertexts to.

A NumPy copy of SEAL-Embedded's encode and encrypt (device/lib:
rng.h, sample.c, fft.c, ntt.c, ckks_common.c, ckks_sym.c, ckks_asym.c),
taken from the pure-Python golden model the port carries and vectorised
over messages and butterflies so that n = 16384 with thirteen primes
runs in seconds.  Every operation keeps the golden model's order and
rounding: the encode's complex products are spelt out as the four real
products, so no step can be fused.  It imports nothing but numpy,
hashlib and math, and takes its parameters from a configuration file of
the benchmark, never from the program.
"""
