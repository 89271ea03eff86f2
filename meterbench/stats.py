"""Small statistics the harness computes itself: percentiles of all
samples and the union of time intervals."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between the closest ranks (numpy's default rule)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals) -> list[tuple[float, float]]:
    """Merge ``[(start, end)]`` into disjoint, sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted((float(s), float(e)) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that the merged intervals leave free."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]

