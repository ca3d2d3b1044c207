"""Hand the JAX package's inputs to the port.

The tests build one set of numpy arrays and feed both implementations;
these helpers turn the JAX side's parameter object and arrays into the
port's.  Nothing here imports jax or seal_embedded_tpu.  A tool above the
API: no module of the port below ``api.py`` imports it.
"""

from __future__ import annotations

import numpy as np

from .api import _make_context
from .config import CUDA, Parms
from .graphs import to_device
from .io.serialize import unpack_ternary_signed

unpack_ternary = unpack_sk = unpack_ternary_signed


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
    return _make_context(parms_from_jax(ctx.parms), ctx.encrypt_type, device,
                         ctx.sk_signed, ctx.pk0, ctx.pk1, ctx.encode_mode)


def _u32_tensor(words, device):
    return to_device(np.asarray(words, dtype=np.uint32).astype(np.int64),
                     device)


def pk_to_device(pk0, pk1, device=CUDA):
    """Public key u32 (L, n) numpy arrays -> int64 tensors on `device`."""
    return _u32_tensor(pk0, device), _u32_tensor(pk1, device)


def asym_state_to_device(values, seed_words, device=CUDA):
    """numpy inputs of asym_encrypt_fused -> the port's tensors: values
    float32 (B, vlen), private seed words int64 (B, 16).  Every upload
    here is graphs.to_device's."""
    return (to_device(np.asarray(values, dtype=np.float32), device),
            _u32_tensor(seed_words, device))


def state_to_device(values, sk_signed, share_words, err_words,
                    device=CUDA):
    """numpy inputs of sym_encrypt_fused -> the port's tensors: values
    float32 (B, vlen), sk int64 (n,), share/err seed words int64 (B, 16)."""
    return (to_device(np.asarray(values, dtype=np.float32), device),
            to_device(np.asarray(sk_signed, dtype=np.int64), device),
            _u32_tensor(share_words, device), _u32_tensor(err_words, device))
