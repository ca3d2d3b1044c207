"""The kernel wrappers' launch counters, by name, and the other tallies
a CUDA graph must account for.

Each wrapper adds one to its counter where it launches its kernel.
Other layers register a map of tallies of their own, {kind: [numbers]}
(``parallel/comm.py``: its collectives' calls and bytes).  A CUDA graph
replays launches and collectives without running the Python that counts
them, so ``graphs.py`` records what a capture added to all of them
(``tallies``, ``tallies_since``), puts them back (``restore``) and adds
that change on every replay (``add``); ``chip_smoke.py`` reads the
counters to show which kernels a run went through.
"""

from __future__ import annotations

from . import calibrate, encode, keccak, ntt

# name -> (wrapper module, attribute)
COUNTERS = {"keccak": (keccak, "launches"),
            "keccak_cbd": (keccak, "cbd_launches"),
            "keccak_uniform": (keccak, "uniform_launches"),
            "keccak_ternary": (keccak, "ternary_launches"),
            "ntt": (ntt, "launches"), "ntt_pte": (ntt, "pte_launches"),
            "ntt_asym": (ntt, "asym_launches"),
            "encode": (encode, "launches"), "calib": (calibrate, "launches")}

# name -> a function that returns the registered map (looked up at each
# use, so a module may rebind its map).
MAPS: dict = {}


def register(name: str, get) -> None:
    """Account for the map get() returns as the counters are."""
    MAPS[name] = get


def _copy(tally: dict) -> dict:
    return {kind: list(v) for kind, v in tally.items()}


def read() -> dict[str, int]:
    return {k: getattr(module, attr) for k, (module, attr) in COUNTERS.items()}


def tallies() -> dict:
    """read(), with a copy of each registered map under its name."""
    return {**read(), **{name: _copy(get()) for name, get in MAPS.items()}}


def restore(counts: dict) -> None:
    """Set every counter to its value in `counts`, and each registered map
    that `counts` holds (a tallies()) to its copy there, in place."""
    for k, (module, attr) in COUNTERS.items():
        setattr(module, attr, counts[k])
    for name, get in MAPS.items():
        if name in counts:
            tally = get()
            tally.clear()
            tally.update(_copy(counts[name]))


def reset() -> None:
    restore(dict.fromkeys(COUNTERS, 0))


def since(before: dict[str, int]) -> dict[str, int]:
    """Each counter's change since `before` (a read())."""
    now = read()
    return {k: now[k] - before[k] for k in COUNTERS}


def tallies_since(before: dict) -> dict:
    """since(), with each registered map's change since `before` (a
    tallies()) under its name: the kinds that changed, element-wise."""
    out = since(before)
    for name, get in MAPS.items():
        was = before.get(name, {})
        out[name] = {kind: [a - b for a, b in zip(v, was.get(kind) or
                                                  [0] * len(v))]
                     for kind, v in get().items() if v != was.get(kind)}
    return out


def add(deltas: dict) -> None:
    """Add `deltas` (a since() or a tallies_since()) to the counters and
    to the registered maps it holds."""
    for k, (module, attr) in COUNTERS.items():
        setattr(module, attr, getattr(module, attr) + deltas[k])
    for name, get in MAPS.items():
        tally = get()
        for kind, v in deltas.get(name, {}).items():
            now = tally.setdefault(kind, [0] * len(v))
            now[:] = [a + b for a, b in zip(now, v)]
