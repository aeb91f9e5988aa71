"""The benchmark's metric arithmetic: rates over the whole window, tails over
every step of it."""

from __future__ import annotations

import math


def per_item(window_s: float, items: int) -> float | None:
    """Seconds an item: the whole window's wall over every item completed in
    it (never a median of chunks)."""
    return window_s / items if items else None


def rate(work: float, window_s: float) -> float | None:
    """Work a second: all the work of the window over its whole wall."""
    return work / window_s if work and window_s > 0 else None


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0-100) of every value, by linear
    interpolation between order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

