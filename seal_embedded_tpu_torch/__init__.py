"""seal_embedded_tpu_torch: the PyTorch/CUDA port of seal_embedded_tpu.

CKKS encode and symmetric RLWE encryption with SEAL-Embedded's exact PRNG,
sampler and NTT semantics, on torch tensors.  On a CUDA tensor the hot
functions run hand-written Hopper kernels (``csrc/*.cu``, built at first
use by ``ops/kernels/build.py``); on a CPU tensor they run the plain torch
versions beside them, which the tests hold bit-equal to the JAX package.

Imports torch, numpy and the standard library only: never jax, never
seal_embedded_tpu.
"""

__version__ = "0.1.0"
