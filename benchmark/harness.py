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
   outputs released.
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


def walk_errors(out, moduli, batch: int, n: int) -> int:
    """Limbs missing, out of the chain's order, out of shape, or not ok."""
    bad = abs(len(out) - len(moduli))
    for j, limb in enumerate(out[:len(moduli)]):
        bad += not (limb["prime_idx"] == j and limb["q"] == moduli[j]
                    and limb["ok"] is True
                    and limb["c0"].shape == limb["c1"].shape == (batch, n)
                    and limb["c0"].dtype == limb["c1"].dtype == np.uint32)
    return bad


class Cell:
    """A cell's inputs, its context on `dev` and its encrypt call."""

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
        or None, private seeds)."""
        k = self.calls
        self.calls += 1
        return (k, self.traffic.values(k), *self.traffic.seeds(k))

    def encrypt(self, values, share, err):
        """The timed entry: its limb dicts."""
        return self._encrypt(self.ctx, values, share_seeds=share,
                             err_seeds=err, order=ORDER)

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
        moduli, B, n = self.params.moduli, self.traffic.batch, \
            self.params.degree
        calls, kept, errors = [], [], []
        failed = walk = unprepared = 0
        first = self.calls
        start = time.perf_counter()
        while True:
            out = None      # the last call's outputs go before the clock
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
                bad = walk_errors(out, moduli, B, n)
                walk += bad
                calls.append(Call(t0, t1, sum(x["wait_ms"] for x in out),
                                  0 if bad else B))
                pick = sample.offer(k - first)
                if pick is not None:
                    row, slot = pick
                    kept[slot:slot + 1] = [(k, row, _rows(out, row))]
            if t1 - start >= seconds:
                break
        if out is not None:
            kept += [(k, row, _rows(out, row)) for row in (0, B - 1)]
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
