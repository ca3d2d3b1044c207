"""The end-to-end arithmetic: rates over the window, tails over all
calls."""

from __future__ import annotations

import math


def rate(done: int, window_s: float) -> float:
    """Work completed per second of the window: all of it over all the
    time."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return done / window_s


def percentile(values, pct: float) -> float:
    """The pct-th percentile of all values, linear between the two nearest
    ranks (numpy's default, statistics' "inclusive")."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * pct / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

