#!/usr/bin/env python3
"""Where a benchmark cell's call spends its time, from the port's spans.

    python3 perf_spans.py --workload CELL --seed N [--seconds S]
                          [--rounds R] [--device cuda|cpu] [--out FILE]

Runs one cell of BENCHMARK.json as ``benchmark/run.py`` does (its
``Cell``: set-up through the API, WARMUP_CALLS warm-up calls, the seeds
of the window made before it), with the span recorder of
``seal_embedded_tpu_torch/utils/timing.py`` on from the first line, so
that set-up's spans (``kernels.load``, ``registry.capture``) are kept.
Then R rounds of two windows of S / (2 R) seconds each, one with the
recorder off and one with it on, so that the recorder's cost is read
against the host's drift; and, on a card, the traced segments of
``benchmark/trace.py``, with the host and of the card alone, each with
the recorder on and then off: the host segment's idle gaps named by the
host's innermost event, and once more by the innermost span with the
device events that carry a span's name (the profiler's copies of
``record_function`` on the card's timeline) left out.

Per window call, from the spans of the windows with the recorder on:
``seed_pack_ms`` (``api.seed_pack``), ``upload_ms`` (``api.upload``),
``launch_ms`` (``chain.run`` less its ``fetch.queue``),
``fetch_queue_ms``, ``fetch_wait_ms`` (``fetch.wait``, the limbs'
``wait_ms``), ``view_ms`` (``fetch.view``), ``send_ms`` (``api.send``),
``redo_ms`` (``stream.redo``: an asym call's rows whose ternary queue
fell short, encrypted again; ``redo_calls`` counts the calls that had
one), ``call_self_ms`` (``api.call`` less its children), ``prologue_dev_ms``,
``step_dev_ms`` and ``copy_dev_ms`` (the card's ``dev.*`` intervals
summed over the call's limbs); per limb, the step's and the copy's
device ms, and the card's idle time before each step (``step_gap_ms``:
the ring's wait and the host's launch); where ``api.call``'s self time
lies, between which of its children (``call_self_by_place``); from
set-up, ``capture_s`` (``registry.capture`` less the ``kernels.load``
inside it).  Beside them, ``input_paths``: how many seed batches of
those windows took each path of ``keccak.input_paths`` (seeds joined or
seed by seed).  The window calls'
host-clock median and mean with the recorder on and off, the card's name
and power limit.
The last line of its output is one JSON object; --out writes it too.
Imports no jax.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

T0 = time.perf_counter()

import torch  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from benchmark import harness, stats  # noqa: E402
from benchmark import trace as tr  # noqa: E402
from benchmark.catalog import Catalog  # noqa: E402
from benchmark.traffic import Sample  # noqa: E402
from seal_embedded_tpu_torch.ops import keccak as kc  # noqa: E402
from seal_embedded_tpu_torch.utils import timing  # noqa: E402

SPAN_METRICS = {            # metric: the span names it sums over a call
    "seed_pack_ms": ("api.seed_pack",),
    "upload_ms": ("api.upload",),
    "fetch_queue_ms": ("fetch.queue",),
    "fetch_wait_ms": ("fetch.wait",),
    "view_ms": ("fetch.view",),
    "send_ms": ("api.send",),
    "prologue_dev_ms": ("dev.prologue",),
    "step_dev_ms": ("dev.step",),
    "copy_dev_ms": ("dev.copy",),
    "redo_ms": ("stream.redo",),
}


def self_ms(span, spans) -> float:
    """A span's ms less its children's."""
    return span.ms - sum(s.ms for s in spans if s.parent == span.id)


def self_places(span, spans) -> dict:
    """Where a span's self time lies: the ms before its first child, between
    each two children ("a>b") and after its last, by place."""
    kids = sorted((s for s in spans if s.parent == span.id),
                  key=lambda s: s.start_ns)
    out = collections.Counter()
    at, last = span.start_ns, "start"
    for k in kids:
        out[f"{last}>{k.name}"] += (k.start_ns - at) * 1e-6
        at, last = k.end_ns, k.name
    out[f"{last}>end"] += (span.end_ns - at) * 1e-6
    return out


def per_call(spans) -> dict:
    """The metrics of SPAN_METRICS and launch_ms, call_self_ms, call_ms,
    each the mean over the calls whose api.call ended, and per limb the
    means of the step's and the copy's device ms and of the card's idle
    time before the step."""
    calls = collections.defaultdict(list)
    for s in spans:
        calls[s.call].append(s)
    rows = collections.defaultdict(list)
    places = collections.Counter()
    limbs = collections.defaultdict(lambda: collections.defaultdict(list))
    for cid, group in calls.items():
        root = [s for s in group if s.name == "api.call"]
        if cid is None or len(root) != 1:
            continue
        for metric, names in SPAN_METRICS.items():
            rows[metric].append(sum(s.ms for s in group if s.name in names))
        runs = [s for s in group if s.name == "chain.run"]
        rows["launch_ms"].append(sum(
            s.ms - sum(c.ms for c in group if c.parent == s.id
                       and c.name == "fetch.queue") for s in runs))
        rows["call_self_ms"].append(self_ms(root[0], group))
        places.update(self_places(root[0], group))
        rows["call_ms"].append(root[0].ms)
        rows["redo_calls"].append(any(s.name == "stream.redo"
                                      for s in group))
        steps = sorted((s for s in group if s.name == "dev.step"),
                       key=lambda s: s.limb)
        prologue = [s for s in group if s.name == "dev.prologue"]
        before = prologue[0].end_ns if prologue else None
        for s in steps:
            limbs[s.limb]["step_ms"].append(s.ms)
            if before is not None:
                limbs[s.limb]["step_gap_ms"].append(
                    (s.start_ns - before) * 1e-6)
            before = s.end_ns
        for s in group:
            if s.name == "dev.copy":
                limbs[s.limb]["copy_ms"].append(s.ms)
    out = {k: statistics.fmean(v) for k, v in rows.items()}
    out["calls"] = len(rows["call_ms"])
    out["redo_calls"] = sum(rows["redo_calls"])
    out["call_self_by_place"] = {k: v / max(out["calls"], 1)
                                 for k, v in places.most_common()}
    out["limbs"] = {j: {k: statistics.fmean(v) for k, v in d.items()}
                    for j, d in sorted(limbs.items())}
    return out


def capture_s(spans) -> dict:
    """Set-up's registry.capture seconds less the kernels.load inside
    them, with both sums and counts."""
    by_id = {s.id: s for s in spans}

    def inside_capture(s):
        while s.parent is not None and s.parent in by_id:
            s = by_id[s.parent]
            if s.name == "registry.capture":
                return True
        return False
    caps = [s for s in spans if s.name == "registry.capture"]
    loads = [s for s in spans if s.name == "kernels.load"]
    nested = sum(s.ms for s in loads if inside_capture(s))
    return {"capture_s": (sum(s.ms for s in caps) - nested) * 1e-3,
            "captures": len(caps), "registry_capture_s":
            sum(s.ms for s in caps) * 1e-3,
            "kernels_load_s": sum(s.ms for s in loads) * 1e-3,
            "kernels_load_in_capture_s": nested * 1e-3,
            "evictions": sum(s.name == "registry.evict" for s in spans)}


def window(cell, seconds, sample, on: bool):
    """One window of the cell with the recorder on or off: its calls, on
    its spans, and the seed packing paths it took (keccak.input_paths)."""
    timing.take_spans()
    paths = kc.input_paths.copy()
    timing.record_spans(on)
    win = cell.window(seconds, sample)
    timing.record_spans(False)
    spans = timing.take_spans()
    paths = kc.input_paths - paths
    if win.errors or win.walk_errors or win.failed:
        raise RuntimeError(f"a window call failed: {win.errors[:1]}")
    return win.calls, spans, paths


def calls_summary(calls) -> dict:
    ms = [c.ms for c in calls]
    return {"count": len(ms), "median_ms": statistics.median(ms),
            "mean_ms": statistics.fmean(ms),
            "p95_ms": stats.percentile(ms, 95),
            "host_ms": statistics.fmean(c.ms - c.wait_ms for c in calls),
            "wait_ms": statistics.fmean(c.wait_ms for c in calls)}


def span_gaps(seg, names) -> list:
    """trace.idle_gaps with each gap named by the innermost host event
    whose name is a span's (else the innermost host event, else
    "python"), and the device events that carry a span's name (the
    profiler's copies of record_function on the card's timeline) left
    out of the device's busy intervals."""
    dev = [e for e in seg.events if e[2] not in names]
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    by = collections.Counter()
    active, nxt = [], 0     # host events begun by the gap's middle
    for (_, gap_start), (gap_end, _) in zip(merged, merged[1:]):
        mid = (gap_start + gap_end) / 2
        while nxt < len(seg.host) and seg.host[nxt][0] <= mid:
            active.append(seg.host[nxt])
            nxt += 1
        active = [h for h in active if h[1] > mid]
        ours = [h for h in active if h[2] in names]
        label = max(ours or active)[2] if active else "python"
        by[label] += (gap_end - gap_start) * 1e-6
    return [[k, v] for k, v in by.most_common(tr.TOP)]


def traced(cell, seconds, device_seconds, names) -> dict:
    """The host-traced segment, then the device-only one, each with the
    recorder on, then off."""
    out = {}
    for host, secs in ((True, seconds), (False, device_seconds)):
        for on in (True, False):
            timing.take_spans()
            timing.record_spans(on)
            seg = tr.segment(cell.call, secs, host=host)
            timing.record_spans(False)
            timing.take_spans()
            named = [e for e in seg.events if e[2] in names]
            got = {"calls": seg.calls, "window_s": seg.window_us * 1e-6,
                   "busy_s": seg.busy_us() * 1e-6,
                   "busy_s_without_named": tr.union_us(
                       [(a, b) for a, b, n in seg.events if n not in names]
                   ) * 1e-6,
                   "device_events_named_as_spans": len(named),
                   "device_ops": tr.device_ops(seg)}
            if host:
                got["idle_gaps"] = tr.idle_gaps(seg)
                got["idle_gaps_by_span"] = span_gaps(seg, names)
            out[("host" if host else "device") + (".on" if on else ".off")
                ] = got
    return out


def card() -> dict:
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
        return {"nvidia_smi": line}
    except (OSError, IndexError, subprocess.SubprocessError):
        return {"nvidia_smi": None}


SPAN_NAMES = {"api.call", "api.seed_pack", "api.upload", "api.send",
              "chain.run", "fetch.queue", "fetch.wait", "fetch.view",
              "stream.redo", "registry.capture",
              "registry.evict", "kernels.load"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=32.0)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--host-trace-seconds", type=float, default=0.5)
    ap.add_argument("--device-trace-seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    a = ap.parse_args()
    timing.record_spans(True)
    cell = harness.Cell(Catalog(), a.workload, a.seed, a.device)
    warm = []
    cell.traffic.prepare(harness.WARMUP_CALLS)
    for _ in range(harness.WARMUP_CALLS):
        w0 = time.perf_counter()
        cell.call()
        warm.append(time.perf_counter() - w0)
    if cell.dev.type == "cuda":
        torch.cuda.synchronize(cell.dev)
    timing.record_spans(False)
    setup = timing.take_spans()
    setup_s = time.perf_counter() - T0
    pace = statistics.median(warm[1:])
    half = a.seconds / (2 * a.rounds)
    cell.prepare(a.seconds + 2 * (a.host_trace_seconds
                                  + a.device_trace_seconds) + 4.0, pace)
    sample = Sample(cell.traffic.batch, cell.traffic.sample_rng)
    gc.collect()            # as benchmark/harness.py before its window
    gc.freeze()
    off_calls, on_calls, on_spans, rounds = [], [], [], []
    paths = collections.Counter()
    for _ in range(a.rounds):
        calls_off, _, _ = window(cell, half, sample, False)
        calls_on, spans, on_paths = window(cell, half, sample, True)
        off_calls += calls_off
        on_calls += calls_on
        on_spans += spans
        paths += on_paths
        rounds.append([calls_summary(calls_off)["median_ms"],
                       calls_summary(calls_on)["median_ms"]])
    result = {"workload": a.workload, "seed": a.seed, "card": card(),
              "setup_s": setup_s, "setup": capture_s(setup),
              "off": calls_summary(off_calls), "on": calls_summary(on_calls),
              "round_medians_off_on": rounds,
              "spans": {**per_call(on_spans), "input_paths": dict(paths)}}
    result["on_over_off"] = {
        k: result["on"][k] / result["off"][k] - 1
        for k in ("median_ms", "mean_ms")}
    if cell.dev.type == "cuda":
        result["traced"] = traced(cell, a.host_trace_seconds,
                                  a.device_trace_seconds, SPAN_NAMES)
    cell.free()
    line = json.dumps(result)
    if a.out:
        pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(a.out).write_text(line + "\n")
    print(line)
    return 0 if math.isfinite(result["on"]["median_ms"]) else 1


if __name__ == "__main__":
    sys.exit(main())
