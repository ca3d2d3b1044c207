"""Hand the JAX package's inputs to the port.

The tests build one set of numpy arrays and feed both implementations;
these helpers turn the JAX side's parameter object and arrays into the
port's.  Nothing here imports jax or seal_embedded_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Parms

# Where the port's constructors and factories put their tensors unless
# told otherwise: the card.  Tests on the CPU pass device="cpu".
CUDA = torch.device("cuda")


def parms_from_jax(p) -> Parms:
    """The port's Parms from any object with .degree, .moduli and .scale
    (seal_embedded_tpu.config.Parms included)."""
    return Parms(degree=int(p.degree), moduli=tuple(int(q) for q in p.moduli),
                 scale=float(p.scale))


def context_from_jax(ctx, device):
    """The port's SEContext on `device` from the JAX package's: its parms,
    encrypt type and encode mode, and copies of its numpy sk_signed, pk0
    and pk1 (the encryptor is built and the keys uploaded as
    se_setup_custom does)."""
    from .api import _make_context
    return _make_context(parms_from_jax(ctx.parms), ctx.encrypt_type, device,
                         ctx.sk_signed, ctx.pk0, ctx.pk1, ctx.encode_mode)


def unpack_ternary(packed, n: int) -> np.ndarray:
    """2-bit packed ternary polynomial (4 coefficients per byte, most
    significant pair first, value + 1), as the reference stores the secret
    key and u -> signed int32 (n,) in {-1, 0, 1}."""
    packed = np.frombuffer(bytes(packed), dtype=np.uint8)
    i = np.arange(n)
    shift = (6 - (i % 4) * 2).astype(np.uint8)
    return (((packed[i // 4] >> shift) & 3).astype(np.int32) - 1)


unpack_sk = unpack_ternary


def to_device(array, device):
    """graphs.to_device: an upload that idle compiled entries on the card
    make room for.  Imported here when called, since graphs imports the
    kernel modules, which import CUDA from this module."""
    from .graphs import to_device
    return to_device(array, device)


def _u32_tensor(words, device):
    return to_device(np.asarray(words, dtype=np.uint32).astype(np.int64),
                     device)


def pk_to_device(pk0, pk1, device=CUDA):
    """Public key u32 (L, n) numpy arrays -> int64 tensors on `device`."""
    return _u32_tensor(pk0, device), _u32_tensor(pk1, device)


def asym_state_to_device(values, seed_words, device=CUDA):
    """numpy inputs of asym_encrypt_fused -> the port's tensors: values
    float32 (B, vlen), private seed words int64 (B, 16).  Every upload
    here is an eager allocation (graphs.to_device)."""
    return (to_device(np.asarray(values, dtype=np.float32), device),
            _u32_tensor(seed_words, device))


def state_to_device(values, sk_signed, share_words, err_words,
                    device=CUDA):
    """numpy inputs of sym_encrypt_fused -> the port's tensors: values
    float32 (B, vlen), sk int64 (n,), share/err seed words int64 (B, 16)."""
    return (to_device(np.asarray(values, dtype=np.float32), device),
            to_device(np.asarray(sk_signed, dtype=np.int64), device),
            _u32_tensor(share_words, device), _u32_tensor(err_words, device))
