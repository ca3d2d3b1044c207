"""The benchmark of seal_embedded_tpu_torch, the PyTorch and CUDA port.

    python benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

`BENCHMARK.json` at the repository's root names the cells, each a
configuration (``configs/<name>.json``) under a traffic mix
(``traffic/<name>.json``), and the metrics; each per-layer metric is read
by ``metrics/<name>.py``.  The harness finds all of them by name, so a
cell, a configuration or a metric is added by adding files.  It imports
neither jax nor the JAX package.
"""
