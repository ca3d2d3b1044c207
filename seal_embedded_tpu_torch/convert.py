"""Hand the JAX package's inputs to the port.

The tests build one set of numpy arrays and feed both implementations;
these helpers turn the JAX side's parameter object and arrays into the
port's.  Nothing here imports jax or seal_embedded_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Parms


def parms_from_jax(p) -> Parms:
    """The port's Parms from any object with .degree, .moduli and .scale
    (seal_embedded_tpu.config.Parms included)."""
    return Parms(degree=int(p.degree), moduli=tuple(int(q) for q in p.moduli),
                 scale=float(p.scale))


def unpack_sk(sk_packed, n: int) -> np.ndarray:
    """2-bit packed secret key (4 coefficients per byte, most significant
    pair first, value + 1) -> signed int32 (n,) in {-1, 0, 1}."""
    packed = np.frombuffer(bytes(sk_packed), dtype=np.uint8)
    i = np.arange(n)
    shift = (6 - (i % 4) * 2).astype(np.uint8)
    return (((packed[i // 4] >> shift) & 3).astype(np.int32) - 1)


def state_to_device(values, sk_signed, share_words, err_words, device=None):
    """numpy inputs of sym_encrypt_fused -> the port's tensors: values
    float32 (B, vlen), sk int64 (n,), share/err seed words int64 (B, 16)."""
    return (torch.as_tensor(np.asarray(values, dtype=np.float32),
                            device=device),
            torch.as_tensor(np.asarray(sk_signed, dtype=np.int64),
                            device=device),
            torch.as_tensor(np.asarray(share_words, dtype=np.uint32)
                            .astype(np.int64), device=device),
            torch.as_tensor(np.asarray(err_words, dtype=np.uint32)
                            .astype(np.int64), device=device))
