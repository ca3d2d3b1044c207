#!/usr/bin/env python3
"""Memory and time of the compiled per-prime streams on one card.

    python3 perf_streams.py [--root DIR] [--out FILE]   # needs one card

Runs through the package under DIR (default: this checkout), so that one
chip call can run a parent checkout beside this one.  For each stream of
``CASES`` (sym at n = 16384 with L = 13 and L = 3 at B = 1024, asym at
16384/13 with B = 512, sym at 4096/3 with B = 1024), through its public
entry point (``sym_encrypt_stream``, ``asym_encrypt_stream``):

* the first call, which captures the stream (its earlier entries evicted
  first), host-clock ms;
* the pool: the bytes the capture left reserved (``Entry.resident``, the
  registry's count), and the footprint: the pool plus a call's peak
  allocated above its inputs;
* the streamed ms: host clock from the call to the last limb in host
  memory, median of ``ROUNDS`` after one warm-up call, beside the
  compiled fused batch + its fetch to pinned memory, in rotated rounds;
* every limb against the compiled fused batch's c0 and c1 (a limb that
  differs raises).

Inputs from numpy seed 9; the asym key is uniform in [0, q) per prime.
The last line is one JSON object with every case, the card's name,
power limit and memory.  Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
CASES = (("sym", 16384, 13, 1024), ("sym", 16384, 3, 1024),
         ("asym", 16384, 13, 512), ("sym", 4096, 3, 1024))
ROUNDS = 5
SEED = 9
MIB = 2 ** 20


def case_inputs(kind, parms, batch, dev):
    """The stream's and the fused batch's arguments on `dev`: values,
    sk_signed, share and err words (sym), or values, pk0, pk1 and the
    private seed words (asym)."""
    from seal_embedded_tpu_torch.convert import (asym_state_to_device,
                                                 state_to_device)
    n = parms.degree
    rng = np.random.default_rng(SEED)
    values = rng.uniform(-1, 1, (batch, n // 2)).astype(np.float32)
    sk = (rng.integers(0, 3, n) - 1).astype(np.int32)
    share, err = (rng.integers(0, 2 ** 32, (batch, 16), dtype=np.int64)
                  .astype(np.uint32) for _ in range(2))
    if kind == "sym":
        return state_to_device(values, sk, share, err, dev)
    pk = [torch.as_tensor(np.stack([rng.integers(0, q, n)
                                    for q in parms.moduli]), device=dev)
          for _ in range(2)]
    v, s = asym_state_to_device(values, err, dev)
    return (v, *pk, s)


def fetched(out):
    """c0, c1 of a batch in pinned host memory as int32, waited for."""
    host = []
    for key in ("c0", "c1"):
        h = torch.empty(out[key].shape, dtype=torch.int32, pin_memory=True)
        h.copy_(out[key].to(torch.int32), non_blocking=True)
        host.append(h)
    torch.cuda.synchronize()
    return [h.numpy().view(np.uint32) for h in host]


def rotated_host_ms(fns, rounds=ROUNDS):
    """Median host ms of each fn(), each started on an idle card, after
    one warm-up call each; round i starts at fn i mod len(fns)."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for i in range(rounds):
        for k in range(len(fns)):
            j = (i + k) % len(fns)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[j]()
            times[j].append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(t) for t in times]


def run_case(kind, n, nprimes, batch, dev):
    from seal_embedded_tpu_torch.ckks import stream
    from seal_embedded_tpu_torch.ckks.asym import make_fused_asym_encryptor
    from seal_embedded_tpu_torch.ckks.fast import make_fused_encryptor
    from seal_embedded_tpu_torch.config import default_parms

    parms = default_parms(n, nprimes)
    args = case_inputs(kind, parms, batch, dev)
    if kind == "sym":
        cached = stream.sym_stream(parms, "forward", dev)
        fused = make_fused_encryptor(parms, device=dev)

        def streamed():
            return list(stream.sym_encrypt_stream(*args, parms))
    else:
        cached = stream.asym_stream(parms, "forward", dev)
        fused = make_fused_asym_encryptor(parms, device=dev)

        def streamed():
            return list(stream.asym_encrypt_stream(*args, parms))
    cached.chain.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    limbs = streamed()
    first_ms = (time.perf_counter() - t0) * 1e3
    entry, = cached.chain.entries.values()
    c0, c1 = fetched(fused(*args))
    for j, limb in enumerate(limbs):
        if not (np.array_equal(limb["c0"], c0[j])
                and np.array_equal(limb["c1"], c1[j])):
            raise AssertionError(f"{kind} {n}/{nprimes}: limb {j} differs "
                                 "from the fused batch")
    del limbs, c0, c1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    streamed()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    ms, batch_ms = rotated_host_ms([streamed,
                                    lambda: fetched(fused(*args))])
    row = {"kind": kind, "n": n, "L": nprimes, "B": batch,
           "first_ms": first_ms, "pool_mib": entry.resident / MIB,
           "footprint_mib": (entry.resident + peak) / MIB,
           "streamed_ms": ms, "batch_fetch_ms": batch_ms}
    cached.chain.clear()
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("perf_streams: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = []
    for case in CASES:
        row = run_case(*case, dev)
        rows.append(row)
        print(f"[streams] {args.root}: {row['kind']} n={row['n']} "
              f"L={row['L']} B={row['B']}: every limb equal to the fused "
              f"batch; first call {row['first_ms']:.1f} ms; pool "
              f"{row['pool_mib']:.1f} MiB, footprint "
              f"{row['footprint_mib']:.1f} MiB; streamed "
              f"{row['streamed_ms']:.3f} ms vs fused batch + fetch "
              f"{row['batch_fetch_ms']:.3f} ms (host clock to the last limb "
              f"in host memory, medians of {ROUNDS} rotated rounds); {smi}",
              flush=True)
    line = json.dumps({"root": args.root, "cases": rows, "card": smi,
                       "total_mib": torch.cuda.get_device_properties(
                           dev).total_memory / MIB})
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
