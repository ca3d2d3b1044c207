#!/usr/bin/env python3
"""The control of the benchmark's check: the reference put in the
program's place, its encode computed in float32, one precision below the
float64 the configurations state.  It has to come out not correct.

    python benchmark/control.py --workload CELL --seeds N [N ...] [--calls K]

For each seed, the cell's own inputs (traffic.py) at its own batch and
degree; the messages a run of K window calls would check (the same
reservoir sample, the same last call's two ends); their ciphertexts
computed by the reference in float32, then judged by check.py exactly as
a run's outputs are.  Prints one JSON line a seed with the compared
numbers, and exits 1 if any seed came out correct.  Needs no card: the
reference is NumPy.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import check  # noqa: E402
from benchmark.catalog import Catalog  # noqa: E402
from benchmark.reference import ckks  # noqa: E402
from benchmark.reference.params import from_config  # noqa: E402
from benchmark.traffic import Sample, Traffic  # noqa: E402


def sampled(traffic: Traffic, calls: int) -> list:
    """(call, row) of the messages a window of `calls` calls checks."""
    sample = Sample(traffic.batch, traffic.sample_rng)
    kept = []
    for k in range(calls):
        pick = sample.offer(k)
        if pick is not None:
            row, slot = pick
            kept[slot:slot + 1] = [(k, row)]
    return kept + [(calls - 1, 0), (calls - 1, traffic.batch - 1)]


def control(catalog: Catalog, name: str, seed: int, calls: int,
            dtype=np.float32) -> dict:
    """The compared numbers of the control on `seed`."""
    spec = catalog.cell(name)
    mix = catalog.traffic(spec["traffic"])
    p = from_config(catalog.config(spec["config"]))
    traffic = Traffic(p.degree, mix, seed)
    kind = mix["encrypt_type"]
    messages = [traffic.message(k, row) for k, row in
                sampled(traffic, calls)]
    pk = (ckks.public_key(p, traffic.sk, traffic.pk_seed)
          if kind == "asym" else None)
    c0, c1 = check.reference_rows(p, kind, traffic.sk, pk, messages, dtype)
    got = [(c0[:, j].astype(np.uint32), c1[:, j].astype(np.uint32))
           for j in range(len(messages))]
    return check.numbers(p, kind, traffic.sk, traffic.pk_seed, got,
                         messages, 0, 0, pk)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    catalog = Catalog()
    passed = 0
    for seed in args.seeds:
        nums = control(catalog, args.workload, seed, args.calls)
        ok = check.correct(nums)
        passed += ok
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": ok, "checks": nums}))
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
