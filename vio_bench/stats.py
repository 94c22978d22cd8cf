"""The benchmark's arithmetic: rates over a window, the union of device
busy intervals, and the quartile spread that sets a bound. Plain Python."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def rate(count: int, seconds: float) -> float:
    """count / seconds over a window that must have a length."""
    if not seconds > 0:
        raise ValueError(f"a rate over a window of {seconds!r} s")
    return count / seconds


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (any order, any
    overlap)."""
    iv = sorted((float(a), float(b)) for a, b in intervals if b > a)
    total = 0.0
    cur_a = cur_b = None
    for a, b in iv:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        elif b > cur_b:
            cur_b = b
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float, end: float
         ) -> List[Tuple[float, float]]:
    """The idle stretches of [start, end) that no interval covers."""
    out = []
    t = start
    for a, b in sorted((float(a), float(b)) for a, b in intervals if b > a):
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, with Python's statistics.quantiles(n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
