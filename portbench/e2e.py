"""The end-to-end arithmetic: rates over a whole window, tails over all
operations, and the spread of a metric over runs.

A rate counts the work of every operation that returned inside the
window and divides by the window's whole length, so time spent between
operations, or in one that the window's end cut off, counts against it.
A percentile is the nearest-rank one over every operation that returned
inside the window.
"""
from __future__ import annotations

import math
import statistics


def in_window(records, t_end: float) -> list:
    """The records of operations that returned by ``t_end``."""
    return [r for r in records if r["t1"] <= t_end]


def rate(records, key: str, window_s: float, scale: float = 1.0) -> float:
    """Sum of ``key`` over ``records`` / ``scale`` per second of window."""
    return sum(r[key] for r in records) / scale / window_s


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    return vals[max(0, math.ceil(q / 100 * len(vals)) - 1)]


def spread(values) -> float:
    """Inter-quartile distance over the median, as
    ``statistics.quantiles(values, n=4)`` places the quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
