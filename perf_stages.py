#!/usr/bin/env python3
"""Stage profile and batch times of the port's sym and asym headlines on
one NVIDIA GPU.

    python3 perf_stages.py [--root DIR] [--tag NAME] [--out FILE]  # one card

Imports ``seal_embedded_tpu_torch`` from DIR (default: the directory of
this file), so the same script times another checkout of the package,
such as a parent commit unpacked with ``git archive``: compare two
checkouts inside one call, in turns (parent, change, change, parent).
At n = 4096, L = 3, B = 1024, on inputs made from seed 0:

* the sym batch (``SymEncryptor``) and the asym batch (``AsymEncryptor``
  with a pk from ``gen_pk_batch``): CUDA-event ms per batch (median of
  10), host-clock ms to a finished card (median of 10), peak device
  memory over one batch; from a ``torch.profiler`` trace of 5 batches in
  a row (device activity only), busy ms (the union of the device
  intervals) and the span from the first one's start to the last one's
  end; the device idle share, 1 - busy / the CUDA-event ms (a traced
  batch runs slower on the host, so 1 - busy / span overstates it, and
  is printed as ``trace_idle_share``); then, from a second trace with a
  ``record_function`` range around each stage's calls, device ms per
  stage (each kernel belongs to the innermost stage whose device-side
  range holds its start);
* single steps through their wrappers (CUDA events), alone (the
  profiler's time of the port's own kernels), the port's kernel launches
  per call (from the same trace) and the peak device memory above what
  was allocated when the call started: KK's base squeeze (1024 streams x
  121 blocks), the CBD draw, and KE at n = 4096 and at n = 16384, B =
  1024 each.

Prints the card's name and power limit, then one JSON object per
measurement; with --out, also writes them all to FILE as one object.
Imports no jax.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from benchmark.trace import union_us

HERE = pathlib.Path(__file__).resolve().parent
N, L, B = 4096, 3, 1024
ITERS = 10
PROFILED_BATCHES = 5
MARKED_TRACES = 3
# The port's kernels as the profiler names them (csrc/*.cu).
PORT_KERNELS = ("keccak_", "ntt_kernel", "ntt_asym_kernel", "encode_",
                "calib_kernel")


def cuda_ms(fn, iters=ITERS):
    """Median CUDA-event ms of fn() after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, iters=ITERS):
    """Median host-clock ms of fn() to a finished card, each call started
    on an idle card, after one warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def peak_mib(fn, above_start=False):
    """Peak device MiB over one call of fn; with above_start, above the
    memory allocated when it starts."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if above_start else 0
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def trace(run, cpu=True):
    """The device-side events (start us, end us, name) of run(), sorted,
    from torch.profiler (with its CPU activity when `cpu`: the
    record_function ranges need it)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def port_kernels(fns, iters=ITERS, kinds=PORT_KERNELS):
    """The port's own kernel events of `iters` calls of each fn, one list
    per fn, from one trace in which marker kernels (torch.cuda._sleep's
    spin kernel) on the same stream separate the fns.  A trace can drop
    events near its start: a marker, or some of the first fn's kernels
    (in chip_smoke.py's runs, 4 of KK base's 10 launches; in later runs
    one of its 10, or one of the rank-select's 870 kernels, in every
    retrace).  So a lead marker goes first, then a decoy stretch of
    `iters` calls of the first fn whose events are not kept, and a trace
    is taken again, up to MARKED_TRACES in all, when its markers do not
    part the decoy and the fns or when a fn's kernel events are not a
    multiple of iters.  kinds: the names of the kernels kept; None keeps
    every device event but the markers (a fn of torch passes, such as the
    rank-select)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()

    def run():
        torch.cuda._sleep(1000)
        for fn in (fns[0], *fns):
            torch.cuda._sleep(1000)
            for _ in range(iters):
                fn()
        torch.cuda._sleep(1000)
    seen = []
    for _ in range(MARKED_TRACES):
        parts = parted(trace(run))
        groups = [[e for e in group
                   if kinds is None or any(k in e[2] for k in kinds)]
                  for group in parts[1:]]
        counts = [len(group) for group in groups]
        if len(parts) == len(fns) + 1 and all(c and c % iters == 0
                                              for c in counts):
            return groups
        seen.append(counts)
    short = [{name: c for name, c in collections.Counter(
        e[2][:48] for e in group).items() if c % iters}
        for group in groups if len(group) % iters]
    raise RuntimeError(f"the profiler's traces held {seen} kernel events "
                       f"per group after the decoy; want {len(fns)} "
                       f"groups, each a multiple of {iters}; the last "
                       f"trace's kernels whose counts are not: {short}")


def parted(events):
    """The events between marker kernels, one list per stretch that holds
    any: every fn of port_kernels runs kernels, so the empty stretches
    are the gaps before and after its lead marker and after its last."""
    groups = [[]]
    for ev in events:
        if "spin_kernel" in ev[2]:
            groups.append([])
        else:
            groups[-1].append(ev)
    return [g for g in groups if g]


def kernel_alone_ms(fns, iters=ITERS, kinds=PORT_KERNELS):
    """Device ms per call of each fn spent in the port's own kernels: the
    kernel alone, without the wrapper's host work or any torch pass (with
    kinds None, in every kernel the fn runs: port_kernels)."""
    return [sum(end - start for start, end, _ in group) / iters / 1e3
            for group in port_kernels(fns, iters, kinds)]


def timeline(fn, labels=()):
    """Over PROFILED_BATCHES calls of fn: busy ms, span ms and idle share
    of the device, and device ms per stage of `labels` (the names of the
    record_function ranges around the stages).  Without labels the trace
    leaves out the profiler's CPU activity, which costs host time.  A
    trace that saw no device work (on the card the profiler once lost
    every event of phase 8's) is taken again, up to MARKED_TRACES in
    all."""
    fn()
    torch.cuda.synchronize()

    def run():
        # Each call's output is dropped before the next: at n = 16384, L =
        # 13, B = 1024 five batches' outputs would hold 18 GB.
        for _ in range(PROFILED_BATCHES):
            fn()
    for _ in range(MARKED_TRACES):
        evs = trace(run, cpu=bool(labels))
        kernels = [e for e in evs if e[2] not in labels]
        if kernels:
            break
    else:
        raise RuntimeError(f"the profiler saw no device work in "
                           f"{MARKED_TRACES} traces")
    ranges = [e for e in evs if e[2] in labels]
    per_stage = collections.defaultdict(float)
    for start, end, _ in kernels:
        inside = [r for r in ranges if r[0] <= start < r[1]]
        label = (min(inside, key=lambda r: r[1] - r[0])[2] if inside
                 else "(no stage)")
        per_stage[label] += end - start
    span = max(e[1] for e in kernels) - min(e[0] for e in kernels)
    busy = union_us([(s, e) for s, e, _ in kernels])
    scale = 1e-3 / PROFILED_BATCHES
    return {"stages_ms": {k: v * scale for k, v in sorted(
                per_stage.items(), key=lambda kv: -kv[1])},
            "kernel_sum_ms": sum(e - s for s, e, _ in kernels) * scale,
            "busy_ms": busy * scale, "span_ms": span * scale,
            "trace_idle_share": 1.0 - busy / span,
            "stage_ranges_seen": len(ranges)}


def instrument(pkg, points):
    """Wrap each existing (module, attribute) in a record_function range
    named by its label; returns the labels of the points found."""
    found = set()
    for modname, attr, label in points:
        owner = importlib.import_module(f"{pkg}.{modname.split(':')[0]}")
        if ":" in modname:
            owner = getattr(owner, modname.split(":")[1])
        orig = getattr(owner, attr, None)
        if orig is None:
            continue

        def wrapped(*args, _orig=orig, _label=label, **kwargs):
            name = _label(*args, **kwargs) if callable(_label) else _label
            with torch.profiler.record_function(name):
                return _orig(*args, **kwargs)
        setattr(owner, attr, wrapped)
        found.update(SQUEEZES if callable(label) else [label])
    return found


SQUEEZES = ("KK squeeze, many blocks", "KK squeeze, 1 block")


def squeeze_label(*args, **kwargs):
    """The stage of a sampling._squeeze call, by its nblocks."""
    nblocks = args[2] if len(args) > 2 else kwargs["nblocks"]
    return SQUEEZES[0] if nblocks > 1 else SQUEEZES[1]


STAGES = [
    ("ckks.fast:EncryptorBase", "encode", "encode (KE)"),
    ("ops.sampling", "sample_cbd", "CBD"),
    ("ops.sampling", "sample_ternary", "ternary"),
    ("ops.sampling", "sample_ternary_exact", "ternary"),
    ("ops.sampling", "sample_uniform", "uniform draw"),
    ("ops.sampling", "_squeeze", squeeze_label),
    ("ops.sampling", "_rank_select", "rank-select"),
    ("ops.sampling", "barrett32", "barrett32"),
    ("ckks.fast:SymEncryptor", "ntt_secret", "ntt(s)"),
    ("ckks.fast:SymEncryptor", "c0_from_pte", "c0 (KN from pte)"),
    ("ckks.asym", "ntt_asym_from_signed", "KA"),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("perf_stages.py needs a CUDA device")
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    pkg = "seal_embedded_tpu_torch"
    mod = {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "config", "ckks.fast", "ckks.asym", "ops.sampling", "ops.encode",
        "ops.kernels.keccak", "ops.kernels.encode")}
    assert pathlib.Path(mod["config"].__file__).resolve().is_relative_to(
        pathlib.Path(args.root).resolve()), mod["config"].__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    parms = mod["config"].default_parms(N, L)
    sp = mod["ops.sampling"]
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, device=dev)

    values = t(rng.uniform(-1, 1, (B, N // 2)).astype(np.float32))
    sk = t(rng.integers(0, 3, N) - 1)
    share = t(rng.integers(0, 2 ** 32, (B, 16)))
    err = t(rng.integers(0, 2 ** 32, (B, 16)))
    results = {"tag": args.tag, "root": args.root, "device": smi}

    # Single steps.
    ctr = t(rng.integers(0, 2 ** 32, (B, 2)))
    squeeze = mod["ops.kernels.keccak"].keccak_squeeze
    steps = {"KK base squeeze (1024 x 121 blocks)":
             lambda: squeeze(share, ctr, -(-4 * N // 136))}
    steps["CBD draw (1024, 4096)"] = lambda: sp.sample_cbd(
        err, sp.counter_zero((B,), dev), N)
    for n in (N, 16384):
        tabs = mod["ops.encode"].table_tensors(n, dev)
        sn = mod["ops.encode"].scale_over_n(mod["config"].default_parms(n, L))
        v = t(rng.uniform(-1, 1, (B, n // 2)).astype(np.float32))
        steps[f"KE encode ({B}, {n})"] = (
            lambda v=v, tabs=tabs, sn=sn:
                mod["ops.kernels.encode"].encode_f64(v, *tabs, sn))
    events = port_kernels(list(steps.values()))
    for (name, fn), group in zip(steps.items(), events):
        results[name] = {
            "wrapper_ms": cuda_ms(fn),
            "kernel_alone_ms": sum(e - s for s, e, _ in group) / ITERS / 1e3,
            "launches_per_call": len(group) / ITERS,
            "peak_mib_above_start": peak_mib(fn, above_start=True)}
    del steps, events, v, tabs   # out of the batches' peaks

    # Batches.
    ep = t(rng.integers(-20, 21, N))
    enc = mod["ckks.fast"].SymEncryptor(parms, dev)
    pk = mod["ckks.asym"].gen_pk_batch(sk, share[0], ep, parms)
    aenc = mod["ckks.asym"].AsymEncryptor(parms, *pk, dev)
    batches = {"sym batch": lambda: enc(values, sk, share, err),
               "asym batch": lambda: aenc(values, err)}
    for name, fn in batches.items():
        r = results[name] = {"cuda_event_ms": cuda_ms(fn),
                             "host_clock_ms": host_ms(fn),
                             "peak_mib": peak_mib(fn)}
        r["enc_per_s"] = B / r["cuda_event_ms"] * 1e3
        tl = timeline(fn)
        r.update({k: tl[k] for k in ("busy_ms", "span_ms",
                                     "trace_idle_share")})
        r["idle_share"] = 1.0 - r["busy_ms"] / r["cuda_event_ms"]
    labels = instrument(pkg, STAGES)
    for name, fn in batches.items():
        tl = timeline(fn, labels)
        results[name].update(stages_ms=tl["stages_ms"],
                             stage_ranges_seen=tl["stage_ranges_seen"],
                             instrumented_span_ms=tl["span_ms"])

    for name, value in results.items():
        print(json.dumps({name: value}))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
