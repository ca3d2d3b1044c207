"""Config-matrix sweep: the port of ``sweep_configs.py``, the reference's
test_all_configs.sh analog.

    python -m seal_embedded_tpu_torch.sweep [--degree 512] [--batch 4]
                                            [--quick] [--device cuda]

The reference sweeps its compile-time option matrix (data_load x ifft x
ntt x index_map x sk, device/scripts/test_all_configs.sh); this
package's options are runtime, so one process sweeps them:

    pipeline (limb-scan, fused, stream, sym_encrypt_batch table and otf,
    file-loaded tables, asym batch and stream) x layout x order

For every config the full batched encode + encrypt runs and is checked:

* ok flags must all be set;
* configs specified to be bit-identical to the baseline (limb-scan,
  reference layout, forward walk) are compared ciphertext bit for bit:
  fused == limb-scan, stream == scan, loaded tables == computed tables,
  otf roots == table roots; asym batch == asym stream;
* every config (the parallel layout and the reverse walk included, whose
  bytes differ by design) must decrypt and decode back to the cleartext
  within the reference's decode tolerance (ckks_tests_common.c:228);
* the lazy INTT from loaded fast tables decrypts as the canonical one.

Two axes of the JAX sweep have no counterpart here: the encode mode
(every mode is the one bit-exact IEEE f64 encode, kernel KE) and kernel
vs jnp (a CUDA tensor always runs the kernels; nothing puts the plain
versions on the card, and a CPU tensor runs them).  Exit status 0 iff
every config passes; one summary line per config.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys
import tempfile

import numpy as np
import torch

from .ckks.asym import gen_pk_batch, make_asym_encryptor
from .ckks.fast import make_fused_encryptor
from .ckks.limbwise import make_limbscan_encryptor
from .ckks.stream import asym_encrypt_stream, sym_encrypt_stream
from .ckks.sym import make_decryptor, sym_encrypt_batch
from .config import CUDA, PRIMES_27BIT, Parms, default_parms
from .convert import state_to_device
from .graphs import to_device
from .io import serialize
from .ops.encode import ifft_root_tables_from_file, index_map_np, make_decoder

# Largest |decode - value| that passes (ckks_tests_common.c:228).
DECODE_TOLERANCE = 0.1


@dataclasses.dataclass
class Sweep:
    """results: (name, passed, max |decode - value|, bit-equal to the
    baseline or None where not specified); baseline: its (c0, c1)."""
    results: list
    baseline: tuple

    @property
    def ok(self) -> bool:
        return all(passed for _, passed, _, _ in self.results)


def sweep_parms(degree: int) -> Parms:
    """3 primes: the 27-bit chain up to n = 2048, the 30-bit one above."""
    if degree <= 2048:
        return Parms(degree=degree, moduli=PRIMES_27BIT[:3], scale=2.0 ** 20)
    return default_parms(degree, 3)


def sweep_inputs(parms: Parms, batch: int, rng):
    """numpy values, sk, share and err words, drawn from rng in the order
    of the JAX sweep."""
    n = parms.degree
    return (rng.uniform(-1, 1, (batch, n // 2)).astype(np.float32),
            (rng.integers(0, 3, n) - 1).astype(np.int32),
            rng.integers(0, 2 ** 32, (batch, 16)).astype(np.uint32),
            rng.integers(0, 2 ** 32, (batch, 16)).astype(np.uint32))


def run_sweep(degree: int = 512, batch: int = 4, quick: bool = False,
              device=CUDA) -> Sweep:
    """Run the matrix on `device` (the card unless told otherwise);
    --quick trims the limb-scan layout x order product and the stream's
    reverse walk, as the JAX sweep's quick matrix does."""
    dev = torch.device(device)
    parms = sweep_parms(degree)
    n = parms.degree
    rng = np.random.default_rng(0)
    values_np, sk_np, share_np, err_np = sweep_inputs(parms, batch, rng)
    args = state_to_device(values_np, sk_np, share_np, err_np, dev)
    sk = args[1]
    results = []
    decryptor = make_decryptor(parms, device=dev)
    decoder = make_decoder(parms, dev)

    def decode_check(c0, c1):
        c0, c1 = (to_device(np.asarray(c).astype(np.int64), dev)
                  for c in (c0, c1))
        centered = decryptor(c0, c1, sk)
        return max(float(np.abs(decoder(centered[i]).cpu().numpy()
                                - values_np).max())
                   for i in range(parms.nprimes))

    def record(name, c0, c1, ok, bitexact):
        c0, c1 = (np.asarray(c).astype(np.int64) for c in (c0, c1))
        worst = decode_check(c0, c1)
        passed = bool(ok) and worst < DECODE_TOLERANCE
        match = None
        if bitexact:
            match = (np.array_equal(c0, base_ct[0])
                     and np.array_equal(c1, base_ct[1]))
            passed = passed and match
        results.append((name, passed, worst, match))
        print(f"{'PASS' if passed else 'FAIL'}  {name:<58} "
              f"max|dec-v|={worst:.2e}"
              + (f"  bit=={match}" if match is not None else ""))

    def host(out):
        return (out["c0"].cpu().numpy(), out["c1"].cpu().numpy(),
                bool(out["ok"].all()))

    # Baseline: limb-scan / reference / forward.
    base = host(make_limbscan_encryptor(parms, device=dev)(*args))
    base_ct = base[:2]
    record("limbwise layout=reference order=forward [baseline]", *base,
           False)

    # Limb-scan matrix: layout x order, stacked back in chain order.
    for layout, order in itertools.product(["reference", "parallel"],
                                           ["forward", "reverse"]):
        if (layout, order) == ("reference", "forward") or (
                quick and (layout, order) == ("parallel", "reverse")):
            continue
        c0, c1, ok = host(make_limbscan_encryptor(parms, layout, order=order,
                                                  device=dev)(*args))
        if order == "reverse":
            c0, c1 = c0[::-1], c1[::-1]
        record(f"limbwise layout={layout} order={order}", c0, c1, ok, False)

    record("fused", *host(make_fused_encryptor(parms, device=dev)(*args)),
           True)

    for order in ["forward"] if quick else ["forward", "reverse"]:
        limbs = sorted(sym_encrypt_stream(*args, parms, order=order),
                       key=lambda d: d["prime_idx"])
        record(f"stream order={order}", np.stack([d["c0"] for d in limbs]),
               np.stack([d["c1"] for d in limbs]),
               all(d["ok"] for d in limbs), order == "forward")

    for variant in ("table", "otf"):
        record(f"batch ntt={variant}",
               *host(sym_encrypt_batch(*args, parms, variant)), True)

    # Loaded-table data path (SE_INDEX_MAP_LOAD + SE_IFFT_LOAD_FULL,
    # fileops.c:208-255): write the adapter-format index map and IFFT
    # roots, read them back, and run the pipeline on them.
    with tempfile.TemporaryDirectory() as d:
        imap_path = os.path.join(d, f"index_map_{n}.dat")
        roots_path = os.path.join(d, f"ifft_roots_{n}.dat")
        serialize.write_index_map(imap_path, index_map_np(n))
        serialize.write_ifft_roots(roots_path, n, parms.logn)
        imap = serialize.read_index_map(imap_path, n).astype(np.int32)
        tables = ifft_root_tables_from_file(roots_path, n)
    record("batch data=loaded(index_map,ifft_roots)",
           *host(sym_encrypt_batch(*args, parms, root_tables=tables,
                                   imap=imap)), True)

    # Asymmetric: the batch and the per-prime stream agree limb by limb
    # and decrypt + decode within tolerance (ckks_asym.c:205-288).
    ep = to_device(rng.integers(-20, 21, n), dev)
    pk_seed = to_device(rng.integers(0, 2 ** 32, (1, 16)).astype(np.int64),
                        dev)
    pk0, pk1 = gen_pk_batch(sk, pk_seed, ep, parms)
    c0, c1, ok = host(make_asym_encryptor(parms, device=dev)(
        args[0], pk0, pk1, args[3]))
    limbs = sorted(asym_encrypt_stream(args[0], pk0, pk1, args[3], parms),
                   key=lambda d: d["prime_idx"])
    same = (np.array_equal(np.stack([d["c0"] for d in limbs]), c0)
            and np.array_equal(np.stack([d["c1"] for d in limbs]), c1))
    worst = decode_check(c0, c1)
    passed = ok and worst < DECODE_TOLERANCE and same
    results.append(("asym batch==stream", passed, worst, same))
    print(f"{'PASS' if passed else 'FAIL'}  {'asym batch==stream':<58} "
          f"max|dec-v|={worst:.2e}  bit=={same}")

    # The lazy INTT from loaded fast tables (SE_INTT_FAST, intt.c:72-129)
    # decrypts the baseline exactly as the canonical INTT.
    with tempfile.TemporaryDirectory() as d:
        serialize.write_intt_roots(d, parms, fast=True)
        loaded = {}
        for q in parms.moduli:
            pairs = serialize.read_ntt_roots(
                os.path.join(d, f"intt_fast_roots_{n}_{int(q)}.dat"), n,
                fast=True)
            loaded[int(q)] = (pairs[:, 0].copy(), pairs[:, 1].copy())
    bc0, bc1 = (to_device(c, dev) for c in base_ct)
    want = decryptor(bc0, bc1, sk)
    got = make_decryptor(parms, "lazy", loaded, dev)(bc0, bc1, sk)
    passed = bool(torch.equal(got, want))
    results.append(("decrypt intt=lazy(loaded fast tables)", passed, 0.0,
                    passed))
    print(f"{'PASS' if passed else 'FAIL'}  "
          f"{'decrypt intt=lazy(loaded fast tables)':<58} bit=={passed}")

    failed = [name for name, passed, _, _ in results if not passed]
    print(f"\n{len(results) - len(failed)}/{len(results)} configs passed on "
          f"{dev}" + (f"; FAILED: {failed}" if failed else ""))
    return Sweep(results, base_ct)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--degree", type=int, default=512)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return 0 if run_sweep(args.degree, args.batch, args.quick,
                          args.device).ok else 1


if __name__ == "__main__":
    sys.exit(main())
