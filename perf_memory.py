#!/usr/bin/env python3
"""Memory and call cost of the compiled fused sym factory on one card.

    python3 perf_memory.py [--root DIR] [--hold]     # needs one card

Runs through the package under DIR (default: this checkout), so that one
chip call can run a parent checkout beside this one:

* **The call's cost**: ``make_fused_encryptor(default_parms(4096, 3))`` at
  B = 1024 on a live signature, called three ways in rotated rounds: the
  whole call ``fn(*args)``; the call as it was before the device registry
  (``before_registry``: the same argument checks and signature, the entry
  looked up in the function's own table under a lock, ``Entry.replay``);
  and ``Entry.replay`` alone.  Medians of CUDA-event ms (the card idles
  while the host works, so the host's part counts).
* **The sequence**: ``make_fused_encryptor(default_parms(16384, 13))`` at
  B = 1024, 2048, 3072, 4096, 5120 and 1024 again, as a user who encrypts
  a dataset in growing batches would.  Each batch alone fits the card.
  After each call it prints B, the call's host-clock ms to a finished
  card (the first call of a signature captures it) and memory_reserved.
  A call that runs out of memory (torch.OutOfMemoryError, or the error of
  a capture that ran out) ends the sequence, and its line says at which B
  and at what memory_reserved.

* **Held outputs** (``--hold``, in place of the two parts above): the
  same factory at 16384/13 captures B = 1024, 2048 and 3072 (each output
  dropped: the last two signatures stay idle), then runs 16 calls at
  B = 1024 and keeps every output, as ``outs.append(fn(x))`` does.  Each
  output is 3,584 MiB: under ``jax.jit`` the card holds all 16 beside
  one call's working set.  After each call it prints k, the call's ms,
  the registry's evictions so far and memory_reserved; a call that runs
  out of memory ends the loop, and its line says at which k.

Inputs come from numpy seed 9.  The last line is one JSON object with
the parts run, the card's name, power limit and memory.  Exits 0 whether
the sequence or the loop ran out or not: it records what happens and
checks no bits.  ``chip_smoke.py`` phase 12 runs the parts through
``run_sequence``, ``call_cost`` and ``run_held``, with golden rows at
both ends of every batch.  Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
SEQUENCE = (1024, 2048, 3072, 4096, 5120, 1024)
SEQUENCE_N, SEQUENCE_L = 16384, 13
CALL_N, CALL_L, CALL_B = 4096, 3, 1024
ROUNDS = 30
HOLD_FIRST = (1024, 2048, 3072)
HOLD_B, HOLD_CALLS = 1024, 16
SEED = 9
MIB = 2 ** 20


def timed_call(fn, args):
    """(fn(*args), host-clock ms to a finished card, the peak
    memory_reserved in the call: since the capture's warm-up began, for a
    call that captures)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - start) * 1e3,
            torch.cuda.max_memory_reserved())


def run_sequence(fn, inputs_of, report, batches=SEQUENCE) -> None:
    """fn(*inputs_of(batch)) for each batch in turn, then report(i, batch,
    args, out, ms, peak) (see timed_call).  An error, such as running out
    of memory, propagates."""
    for i, batch in enumerate(batches):
        args = inputs_of(batch)
        out, ms, peak = timed_call(fn, args)
        report(i, batch, args, out, ms, peak)
        del out, args


def run_held(fn, inputs_of, report, first=HOLD_FIRST, batch=HOLD_B,
             calls=HOLD_CALLS) -> list:
    """fn(*inputs_of(b, None)) once for each b of `first`, each output
    dropped (their signatures captured, then idle), then `calls` calls
    fn(*inputs_of(batch, k)), every output kept, and report(k, args, out,
    ms, peak) after each (see timed_call).  Returns the outputs kept.  An
    error, such as running out of memory, propagates."""
    for b in first:
        timed_call(fn, inputs_of(b, None))
    held = []
    for k in range(calls):
        args = inputs_of(batch, k)
        out, ms, peak = timed_call(fn, args)
        held.append(out)
        report(k, args, out, ms, peak)
    return held


def before_registry(g, args: tuple, lock):
    """g(*args) on a live entry as Graphed.__call__ ran it before the
    device registry: the argument checks and the signature, the entry
    looked up in g's own table under `lock`, then Entry.replay."""
    from seal_embedded_tpu_torch import graphs
    tensors = graphs.tensors_of(args, {})
    g._check_devices(tensors)
    sig = graphs.signature(args, {})
    with lock:
        entry = g.entries.get(sig)
    return entry.replay(tensors, torch.cuda.current_stream(g.device))


def rotated_cuda_ms(fns: dict, rounds: int) -> dict:
    """Median CUDA-event ms of each of fns, called in rounds whose order
    rotates by one each round, so that the host's drift falls on all
    alike; each is called twice first."""
    names = list(fns)
    times = {k: [] for k in names}
    for f in fns.values():
        f(), f()
    for r in range(rounds):
        for k in names[r % len(names):] + names[:r % len(names)]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in times.items()}


def call_cost(g, args: tuple, rounds: int = ROUNDS) -> dict:
    """The compiled function g on args (captured first if it is not): the
    median CUDA-event ms of the whole call g(*args) ("call"), of
    before_registry ("before_registry") and of its entry's Entry.replay
    ("replay"), in rotated rounds."""
    from seal_embedded_tpu_torch import graphs
    g(*args)
    entry = g.entries[graphs.signature(args, {})]
    tensors = graphs.tensors_of(args, {})
    stream = torch.cuda.current_stream(g.device)
    lock = threading.Lock()
    return rotated_cuda_ms({
        "call": lambda: g(*args),
        "before_registry": lambda: before_registry(g, args, lock),
        "replay": lambda: entry.replay(tensors, stream)}, rounds)


def inputs(batch: int, n: int, dev, seed: int = SEED):
    """values, sk_signed, share and err words for `batch` messages at
    degree n, on `dev`, from numpy seed `seed`."""
    from seal_embedded_tpu_torch.convert import state_to_device
    rng = np.random.default_rng(seed)
    values = rng.uniform(-1, 1, (batch, n // 2)).astype(np.float32)
    sk = (rng.integers(0, 3, n) - 1).astype(np.int32)
    share, err = (rng.integers(0, 2 ** 32, (batch, 16), dtype=np.int64)
                  .astype(np.uint32) for _ in range(2))
    return state_to_device(values, sk, share, err, dev)


def held_outputs(root: str, dev, smi: str, total: int) -> dict:
    """--hold: run_held through the fused sym factory at 16384/13, each
    held call's inputs from numpy seed SEED + k; where it ran out."""
    from seal_embedded_tpu_torch import graphs
    from seal_embedded_tpu_torch.ckks.fast import make_fused_encryptor
    from seal_embedded_tpu_torch.config import default_parms

    fn = make_fused_encryptor(default_parms(SEQUENCE_N, SEQUENCE_L),
                              device=dev)
    reg = graphs.registry_for(dev)
    calls, stopped = [], None

    def report(k, _args, _out, ms, peak):
        reserved = torch.cuda.memory_reserved(dev)
        calls.append({"k": k, "ms": ms, "evictions": reg.evictions,
                      "reserved_mib": reserved / MIB, "peak_mib":
                      peak / MIB})
        print(f"[memory] {root}: held call {k} B={HOLD_B}: {ms:.1f} ms "
              f"(host clock, card finished), {k + 1} outputs held, "
              f"{reg.evictions} evictions so far, memory_reserved "
              f"{reserved / MIB:.1f} MiB of {total / MIB:.1f}; {smi}")

    held = []
    try:
        held = run_held(fn, lambda b, k: inputs(
            b, SEQUENCE_N, dev, SEED if k is None else SEED + k), report)
    except RuntimeError as exc:
        # torch.OutOfMemoryError, or the error of a capture that ran out.
        k = len(calls)
        reserved = torch.cuda.memory_reserved(dev)
        stopped = {"k": k, "reserved_mib": reserved / MIB,
                   "error": f"{type(exc).__name__}: "
                            f"{str(exc).splitlines()[0]}"}
        print(f"[memory] {root}: held call {k} ran out of memory with {k} "
              f"outputs held, memory_reserved {reserved / MIB:.1f} MiB of "
              f"{total / MIB:.1f}: {stopped['error']}; {smi}")
    del held
    return {"first": HOLD_FIRST, "batch": HOLD_B, "calls": calls,
            "stopped": stopped}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--hold", action="store_true",
                    help="run the held-output loop only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("perf_memory: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from seal_embedded_tpu_torch.ckks.fast import make_fused_encryptor
    from seal_embedded_tpu_torch.config import default_parms

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    total = torch.cuda.get_device_properties(dev).total_memory
    if args.hold:
        print(json.dumps({"root": args.root, "hold": held_outputs(
            args.root, dev, smi, total), "card": smi,
            "total_mib": total / MIB}))
        return 0

    fn = make_fused_encryptor(default_parms(CALL_N, CALL_L), device=dev)
    cost = call_cost(fn, inputs(CALL_B, CALL_N, dev))
    print(f"[memory] {args.root}: sym n={CALL_N} L={CALL_L} B={CALL_B}, a "
          f"live signature: the whole call {cost['call']:.4f} ms, as before "
          f"the registry {cost['before_registry']:.4f} ms, Entry.replay "
          f"{cost['replay']:.4f} ms (CUDA events, medians of {ROUNDS} "
          f"rotated rounds); {smi}")
    del fn

    calls, stopped = [], None

    def report(i, batch, _args, _out, ms, peak):
        reserved = torch.cuda.memory_reserved(dev)
        calls.append({"batch": batch, "ms": ms, "reserved_mib":
                      reserved / MIB, "peak_mib": peak / MIB})
        print(f"[memory] {args.root}: call {i} B={batch} {ms:.1f} ms (host "
              f"clock, card finished), memory_reserved after "
              f"{reserved / MIB:.1f} MiB, peak in the call "
              f"{peak / MIB:.1f} of {total / MIB:.1f}; {smi}")

    fn = make_fused_encryptor(default_parms(SEQUENCE_N, SEQUENCE_L),
                              device=dev)
    try:
        run_sequence(fn, lambda b: inputs(b, SEQUENCE_N, dev), report)
    except RuntimeError as exc:
        # torch.OutOfMemoryError, or the error a capture that ran out of
        # memory ends with.
        reserved = torch.cuda.memory_reserved(dev)
        i = len(calls)
        stopped = {"call": i, "batch": SEQUENCE[i],
                   "reserved_mib": reserved / MIB,
                   "error": f"{type(exc).__name__}: "
                            f"{str(exc).splitlines()[0]}"}
        print(f"[memory] {args.root}: call {i} B={SEQUENCE[i]} ran out of "
              f"memory at memory_reserved {reserved / MIB:.1f} MiB of "
              f"{total / MIB:.1f}: {stopped['error']}; {smi}")
    print(json.dumps({"root": args.root, "call_cost_ms": cost,
                      "sequence": SEQUENCE, "calls": calls,
                      "stopped": stopped, "card": smi,
                      "total_mib": total / MIB}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
