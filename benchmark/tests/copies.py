"""Temporary copies of the benchmark for the tests.

The copy holds BENCHMARK.json and benchmark/, with the asym cell added
back: the program's bounded ternary refills fail it at random, so it is
kept out of BENCHMARK.json (PERF.md, Open questions), while the harness,
the check and the control still serve asym traffic.
"""

import json
import shutil

from benchmark.catalog import REPO, Catalog

ASYM_CELL = {"name": "n4096.asym.b1024", "config": "seal-default-n4096",
             "traffic": "asym.b1024", "chips": 1,
             "why": "public key only, 1024 messages a call"}


def copy(root, **traffic) -> Catalog:
    """A copy under `root`, each traffic file updated with `traffic`."""
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"].append(ASYM_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for path in (root / "benchmark/traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(traffic)
        path.write_text(json.dumps(mix))
    return Catalog(root)
