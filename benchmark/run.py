#!/usr/bin/env python3
"""The benchmark's one command, from the root of a checkout:

    python benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Prints, as the last line of its output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 a `breakdown`,
and last the compared numbers with their limits (`checks`), which also
close its standard error.  Exits non-zero, with no result, without a
card, or if anything it ran imported jax or the JAX package.
"""

import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
