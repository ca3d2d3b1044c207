"""Entry points: a compiled single-card step and the multi-rank dry run.

    python -m seal_embedded_tpu_torch.entry            # fn(*args) on the card
    python -m seal_embedded_tpu_torch.entry dryrun 8   # 8 gloo CPU ranks

The counterpart of ``__graft_entry__.py``: ``entry`` returns the batched
symmetric CKKS encode + encrypt step at the flagship configuration
(n = 4096, 3 primes) with its example inputs, and ``dryrun N`` runs
``parallel/dryrun.py``'s ``main``, the port of ``dryrun_multichip``.
"""

from __future__ import annotations

import sys
from functools import partial

import numpy as np
import torch

from .ckks.sym import sym_encrypt_batch
from .config import CUDA, default_parms
from .convert import state_to_device
from .graphs import graphed

ENTRY_BATCH = 4


def entry(device=CUDA):
    """Returns (fn, example_args): ``sym_encrypt_batch`` at
    default_parms(4096, 3) with the "table" NTT variant, compiled per
    input signature on `device` (one CUDA graph on the card, a direct
    call on the CPU), and B = 4 inputs on `device` drawn from numpy seed
    0 in the JAX entry's order: f32 values (B, n/2), the secret key
    (n,) in {-1, 0, 1}, share and error seeds (B, 16) u32 words held in
    int64."""
    device = torch.device(device)
    parms = default_parms(4096, 3)
    B, n = ENTRY_BATCH, parms.degree
    rng = np.random.default_rng(0)
    values = rng.uniform(-1, 1, (B, n // 2)).astype(np.float32)
    sk = (rng.integers(0, 3, n) - 1).astype(np.int32)
    share = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    err = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    fn = graphed(partial(sym_encrypt_batch, parms=parms,
                         ntt_variant="table"), device)
    return fn, state_to_device(values, sk, share, err, device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "dryrun":
        from .parallel.dryrun import main as dryrun_main
        return dryrun_main(argv[1:])
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", {k: tuple(v.shape) for k, v in out.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
