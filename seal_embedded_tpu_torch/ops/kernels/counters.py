"""The kernel wrappers' launch counters, by name.

Each wrapper adds one to its counter where it launches its kernel.  A
CUDA graph replays launches without running the wrappers, so
``graphs.py`` records each counter's change during a capture and adds it
on every replay; ``chip_smoke.py`` reads the same map to show which
kernels a run went through.
"""

from __future__ import annotations

from . import calibrate, encode, keccak, ntt

# name -> (wrapper module, attribute)
COUNTERS = {"keccak": (keccak, "launches"),
            "keccak_cbd": (keccak, "cbd_launches"),
            "ntt": (ntt, "launches"), "ntt_pte": (ntt, "pte_launches"),
            "ntt_asym": (ntt, "asym_launches"),
            "encode": (encode, "launches"), "calib": (calibrate, "launches")}


def read() -> dict[str, int]:
    return {k: getattr(module, attr) for k, (module, attr) in COUNTERS.items()}


def restore(counts: dict[str, int]) -> None:
    """Set every counter to its value in `counts`."""
    for k, (module, attr) in COUNTERS.items():
        setattr(module, attr, counts[k])


def reset() -> None:
    restore(dict.fromkeys(COUNTERS, 0))


def since(before: dict[str, int]) -> dict[str, int]:
    """Each counter's change since `before` (a read())."""
    now = read()
    return {k: now[k] - before[k] for k in COUNTERS}


def add(deltas: dict[str, int]) -> None:
    """Add `deltas` (a since()) to the counters."""
    for k, (module, attr) in COUNTERS.items():
        setattr(module, attr, getattr(module, attr) + deltas[k])
