"""One run of one cell.

1. Load the cell, its configuration and its traffic by name (catalog).
2. Set up through the public API on one card: ``api.se_setup_custom``
   with the secret key and the pk seed made from --seed (for asym the
   card derives the public key).
3. Warm up: WARMUP_CALLS calls of the cell's own batch, which capture
   the stream's graphs and fill the pinned-memory cache.  Then the seed
   lists of every call the window can reach are made (Traffic.prepare):
   SEED_MARGIN times the calls that --seconds hold at the pace of the
   warm-up calls after the first (their median).  A call past those is
   counted (`unprepared`), its seeds made before its clock starts.
4. The window: one caller, a closed loop, calls
   ``ckks.stream.se_encrypt_streaming(ctx, values, share_seeds=...,
   err_seeds=..., order="forward")`` until --seconds have passed.  Each
   call is timed on the host clock from the entry to its last limb in
   host memory, with its inputs already made and the last call's
   outputs released.  Where the traffic names a wire form (``send``),
   the call also hands every chunk of its ciphertexts to a Sink, and
   the kept messages are read from the bytes sent (wire/<form>.py).
5. With --trace 1, traced segments after the window (trace.py), their
   calls' seeds made before them.
6. The program's state freed, the check (check.py).
7. The result line.

Set-up (setup_s) runs from the harness's first line to the window's
first call.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
import traceback

import numpy as np
import torch

from . import check, stats
from . import trace as tr
from .catalog import Catalog
from .reference.params import Params, from_config
from .traffic import Sample, Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "seal_embedded_tpu")
MIB = 2 ** 20
ORDER = "forward"          # the chain's walk order, as the reference sends
WARMUP_CALLS = 8
SEED_MARGIN = 1.5          # calls prepared over those the window should hold
TRACE_SECONDS = 2.0        # the device-only traced segment
HOST_TRACE_SECONDS = 0.5   # the segment that traces the host too
IMPORTED = time.perf_counter()      # torch and numpy imported


@dataclasses.dataclass
class Call:
    start: float       # host clock, s
    end: float
    wait_ms: float     # the host's wait for the limbs' copies
    messages: int      # messages done, every limb in host memory, ok
    send_ms: float = 0.0   # Sink.send_ms: the limbs' first to last chunk

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e3


@dataclasses.dataclass
class Observation:
    """What a per-layer metric reads (metrics/<name>.py, read(obs)): a
    metric added later reads only this, so it carries the whole run."""
    cell: dict
    params: Params
    mix: dict
    calls: list
    window_s: float
    evictions: int           # graphs.Registry evictions over the window
    alloc_retries: int       # the caching allocator's, over the window
    card: dict               # device.card
    segment: tr.Segment | None = None   # the traced device segment

    @property
    def kind(self) -> str:
        return self.mix["encrypt_type"]

    @property
    def batch(self) -> int:
        return int(self.mix["batch"])


@dataclasses.dataclass
class Window:
    calls: list
    window_s: float
    kept: list               # [(call, row, (c0, c1) uint32 (L, n))]
    failed: int
    walk_errors: int
    errors: list
    unprepared: int          # calls whose seeds were made in the window


def walk_errors(out, moduli, batch: int, n: int, arrays=True) -> int:
    """Limbs missing, out of the chain's order, not ok, or, where the
    limbs' arrays are what the call delivers (`arrays`), out of shape."""
    bad = abs(len(out) - len(moduli))
    for j, limb in enumerate(out[:len(moduli)]):
        bad += not (limb["prime_idx"] == j and limb["q"] == moduli[j]
                    and limb["ok"] is True
                    and (not arrays or (
                        limb["c0"].shape == limb["c1"].shape == (batch, n)
                        and limb["c0"].dtype == limb["c1"].dtype
                        == np.uint32)))
    return bad


class Sink:
    """The send callback of a cell whose traffic names a wire form.

    ``send`` only appends each chunk, as handed over, to ``chunks``, and
    reads the host clock (perf_counter_ns) at each limb's first and last
    chunk, found by count (the form's limb_chunks): two clock reads a
    limb.  It is a generator's send, so that a limb's edges lie in the
    loop's shape and no chunk pays a test for them (a function that
    counts and tests each chunk costs some 60% more).  ``reset`` starts
    a call: a fresh callback and lists, the last call's chunks
    released."""

    def __init__(self, limb_chunks: int):
        self.limb_chunks = limb_chunks
        self.reset()

    def reset(self) -> None:
        self.chunks, self.stamps = [], []
        receive = self._receive(self.chunks.append, self.stamps.append)
        next(receive)
        self.send = receive.send

    def _receive(self, append, stamp):
        ns, middle = time.perf_counter_ns, range(self.limb_chunks - 2)
        while True:
            chunk = yield
            stamp(ns())
            append(chunk)
            if self.limb_chunks > 1:
                for _ in middle:
                    append((yield))
                append((yield))
            stamp(ns())

    def send_ms(self) -> float:
        """The call's sum over limbs of its first chunk to its last."""
        s = self.stamps
        return sum(b - a for a, b in zip(s[::2], s[1::2])) * 1e-6


def astray(out, got, row: int) -> int:
    """Limbs whose bytes sent for message `row`, `got` (c0, c1) (L, n),
    differ from the limb the call returned: chunks sent out of place."""
    if got[0].shape != (len(out), got[0].shape[-1]):
        return len(out)
    return sum(not (np.array_equal(got[0][j], limb["c0"][row])
                    and np.array_equal(got[1][j], limb["c1"][row]))
               for j, limb in enumerate(out))


class Cell:
    """A cell's inputs, its context on `dev` and its encrypt call."""

    wire = sink = None      # the traffic's wire form and Sink, if it sends

    def __init__(self, catalog: Catalog, name: str, seed: int, dev):
        t0 = time.perf_counter()
        from seal_embedded_tpu_torch import api
        from seal_embedded_tpu_torch.ckks import stream

        t1 = time.perf_counter()
        self.spec = catalog.cell(name)
        self.config = catalog.config(self.spec["config"])
        self.mix = catalog.traffic(self.spec["traffic"])
        self.params = from_config(self.config)
        self.traffic = Traffic(self.params.degree, self.mix, seed)
        if "send" in self.mix:
            self.wire = catalog.wire(self.mix["send"])
            self.sink = Sink(self.wire.limb_chunks(self.traffic.batch))
            self.encrypt = self._encrypt_sending
        self.dev = torch.device(dev)
        self.api = api
        self.ctx = api.se_setup_custom(
            self.params.degree, self.params.nprimes, self.params.scale,
            self.mix["encrypt_type"], sk=self.traffic.sk,
            pk_seed=self.traffic.pk_seed, device=self.dev)
        if tuple(self.ctx.parms.moduli) != self.params.moduli:
            raise ValueError(f"the program's chain {self.ctx.parms.moduli} "
                             f"is not the configuration's")
        self._encrypt = stream.se_encrypt_streaming
        self.calls = 0
        self.setup_parts = {"import_s": t1 - t0,
                            "inputs_and_api_setup_s": time.perf_counter() - t1}

    def inputs(self) -> tuple:
        """The next call's number and inputs: (k, values, shareable seeds
        or None, private seeds); a sending cell's Sink reset."""
        k = self.calls
        self.calls += 1
        if self.sink is not None:
            self.sink.reset()
        return (k, self.traffic.values(k), *self.traffic.seeds(k))

    def encrypt(self, values, share, err):
        """The timed entry: its limb dicts."""
        return self._encrypt(self.ctx, values, share_seeds=share,
                             err_seeds=err, order=ORDER)

    def _encrypt_sending(self, values, share, err):
        """The timed entry of a cell whose traffic sends: its limb dicts,
        and every chunk handed to the Sink."""
        return self._encrypt(self.ctx, values, share_seeds=share,
                             err_seeds=err, order=ORDER,
                             send=self.sink.send, **self.wire.KWARGS)

    def delivered(self, out) -> tuple:
        """What a call delivered: (walk errors, message(row) -> (message
        row's (c0, c1) uint32 (L, n), its limbs astray)).  From the bytes
        sent where the traffic sends, the form's reader counting their
        faults; else from the limbs returned."""
        moduli, B, n = self.params.moduli, self.traffic.batch, \
            self.params.degree
        if self.wire is None:
            return walk_errors(out, moduli, B, n), \
                lambda row: (_rows(out, row), 0)
        messages, bad = self.wire.read(self.sink.chunks, self.params, B)

        def message(row):
            got = messages[row]
            return got, astray(out, got, row)
        return walk_errors(out, moduli, B, n, arrays=False) + bad, message

    def call(self):
        """The next call of the cell's traffic: its limb dicts."""
        return self.encrypt(*self.inputs()[1:])

    def prepare(self, seconds: float, pace_s: float) -> None:
        """Make the seeds of the calls the next `seconds` can reach, at
        `pace_s` a call, SEED_MARGIN over."""
        self.traffic.prepare(self.calls + 8 + math.ceil(
            SEED_MARGIN * seconds / max(pace_s, 1e-6)))

    def window(self, seconds: float, sample: Sample) -> Window:
        """Calls in a closed loop until `seconds` have passed."""
        B = self.traffic.batch
        calls, kept, errors = [], [], []
        failed = walk = unprepared = 0
        first = self.calls
        start = time.perf_counter()
        while True:
            out = message = None    # the last call's outputs go first
            unprepared += self.calls >= self.traffic.prepared
            k, values, share, err = self.inputs()
            t0 = time.perf_counter()
            try:
                out = self.encrypt(values, share, err)
            except Exception:   # the window runs on; the check fails it
                out = None
                errors.append(traceback.format_exc())
            t1 = time.perf_counter()
            if out is None:
                failed += B
                calls.append(Call(t0, t1, 0.0, 0))
            else:
                bad, message = self.delivered(out)
                pick = sample.offer(k - first)
                keep = [] if pick is None else [pick]
                if t1 - start >= seconds:   # the last call's two ends
                    keep += [(row, None) for row in (0, B - 1)]
                for row, slot in keep:
                    got, stray = message(row)
                    bad += stray
                    if slot is None:
                        kept.append((k, row, got))
                    else:
                        kept[slot:slot + 1] = [(k, row, got)]
                walk += bad
                calls.append(Call(
                    t0, t1, sum(x["wait_ms"] for x in out), 0 if bad else B,
                    self.sink.send_ms() if self.sink else 0.0))
            if t1 - start >= seconds:
                break
        return Window(calls, t1 - start, kept, failed, walk, errors,
                      unprepared)

    def public_key(self):
        return (self.ctx.pk0.copy(), self.ctx.pk1.copy())

    def free(self) -> None:
        """Drop the program's state on the card: the context's keys and
        every compiled graph."""
        from seal_embedded_tpu_torch import graphs
        self.api.se_cleanup(self.ctx)
        graphs.registry_for(self.dev).clear()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()


def _rows(out, row):
    return (np.stack([x["c0"][row] for x in out]),
            np.stack([x["c1"][row] for x in out]))


def _evictions(dev) -> int:
    from seal_embedded_tpu_torch import graphs
    return graphs.registry_for(dev).evictions


def _memory(dev):
    """(peak reserved bytes, allocator retries) of a card; 0s elsewhere."""
    if dev.type != "cuda":
        return 0, 0
    from . import device
    return device.peak_reserved(dev), device.alloc_retries(dev)


def run(catalog: Catalog, name: str, seed: int, seconds: float,
        traced: bool, dev="cuda", t0: float | None = None,
        read_card=None) -> dict:
    """One run of cell `name`: the result line's dict, `checks` last.
    read_card(dev) gives the card's name, power limit and rates
    (device.card), read once the window has closed."""
    t0 = time.perf_counter() if t0 is None else t0
    t_cell = time.perf_counter()
    cell = Cell(catalog, name, seed, dev)
    dev, mix = cell.dev, cell.mix
    t_warm = time.perf_counter()
    cell.traffic.prepare(WARMUP_CALLS)
    warm = []
    for _ in range(WARMUP_CALLS):
        w0 = time.perf_counter()
        cell.call()
        warm.append(time.perf_counter() - w0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_seeds = time.perf_counter()
    pace = stats.percentile(warm[1:] or warm, 50)
    cell.prepare(seconds, pace)
    parts = {"torch_import_s": max(IMPORTED - t0, 0.0),
             "cards_s": t_cell - max(IMPORTED, t0), **cell.setup_parts,
             "warmup_s": t_seeds - t_warm,
             "seeds_s": time.perf_counter() - t_seeds}
    gc.collect()
    gc.freeze()
    sample = Sample(cell.traffic.batch, cell.traffic.sample_rng)
    evictions, retries = _evictions(dev), _memory(dev)[1]
    setup_s = time.perf_counter() - t0
    win = cell.window(seconds, sample)
    peak, retries_after = _memory(dev)
    card = read_card(dev) if read_card else None
    obs = Observation(cell.spec, cell.params, mix, win.calls, win.window_s,
                      _evictions(dev) - evictions, retries_after - retries,
                      card or {})
    result = {"correct": False,
              "attempted": len(win.calls) * cell.traffic.batch,
              "failed": win.failed, "metrics": {}}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": card["kind"] if card else str(dev),
                   "count": 1, "memory_peak_bytes": peak}
    if traced:
        cell.prepare(TRACE_SECONDS + HOST_TRACE_SECONDS + 1.0, pace)
        obs.segment = tr.segment(cell.call, TRACE_SECONDS)
        host = tr.segment(cell.call, HOST_TRACE_SECONDS, host=True)
        device_info["busy_s"] = obs.segment.busy_us() * 1e-6
        device_info["window_s"] = obs.segment.window_us * 1e-6
        result["breakdown"] = {"device_ops": tr.device_ops(obs.segment),
                               "idle_gaps": tr.idle_gaps(host)}
    program_pk = cell.public_key() if mix["encrypt_type"] == "asym" else None
    cell.free()
    if win.errors:
        print(win.errors[0], file=sys.stderr)
    t_check = time.perf_counter()
    messages = [cell.traffic.message(k, row) for k, row, _ in win.kept]
    nums = check.numbers(cell.params, mix["encrypt_type"], cell.traffic.sk,
                         cell.traffic.pk_seed, [g for *_, g in win.kept],
                         messages, win.failed, win.walk_errors, program_pk)
    result["correct"] = check.correct(nums) and bool(win.kept)
    result["metrics"] = (_per_layer(catalog, name, obs) if traced
                         else _end_to_end(catalog, name, obs, setup_s, peak))
    times = [c.ms for c in win.calls]
    gaps = [(b.start - a.end) * 1e3 for a, b in zip(win.calls,
                                                    win.calls[1:])]
    result["calls"] = {"count": len(times), "window_s": win.window_s,
                       "median_ms": stats.percentile(times, 50),
                       "p95_ms": stats.percentile(times, 95),
                       "host_ms": sum(c.ms - c.wait_ms for c in win.calls)
                       / len(times),
                       "wait_ms": sum(c.wait_ms for c in win.calls)
                       / len(times),
                       "gap_ms": sum(gaps) / len(gaps) if gaps else 0.0,
                       "prepared": cell.traffic.prepared,
                       "unprepared": win.unprepared,
                       "setup_s": setup_s, "setup_parts": parts,
                       "messages_checked": len(win.kept),
                       "check_s": time.perf_counter() - t_check}
    result["device"] = device_info
    if card:
        result["card"] = card
    result["checks"] = nums
    return result


def _end_to_end(catalog, name, obs: Observation, setup_s, peak) -> dict:
    done = sum(c.messages for c in obs.calls)
    values = {
        "enc_per_s": (stats.rate(done, obs.window_s), "enc/s"),
        "call_ms_p95": (stats.percentile([c.ms for c in obs.calls], 95),
                        "ms"),
        "peak_mib": (peak / MIB, "MiB"),
        "setup_s": (setup_s, "s"),
    }
    out = {}
    for m in catalog.end_to_end(name):
        value, unit = values[m["name"]]
        out[m["name"]] = {"value": value, "unit": unit}
    return out


def _per_layer(catalog, name, obs: Observation) -> dict:
    out = {}
    for m in catalog.per_layer(name):
        value = catalog.reader(m["name"]).read(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax's, jaxlib's, flax's or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv, t0: float) -> int:
    import argparse

    from . import device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    catalog = Catalog()
    try:
        device.require(int(catalog.cell(args.workload)["chips"]))
    except device.NoCard as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    result = run(catalog, args.workload, args.seed, args.seconds,
                 bool(args.trace), "cuda", t0, device.card)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; it must import neither "
              f"jax nor the JAX package", file=sys.stderr)
        return 3
    print(f"calls {result['calls']}")
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
