"""Percentiles over all samples, and the spread the bounds are set from."""

from __future__ import annotations

import statistics

__all__ = ["percentile", "spread"]


def percentile(values, q: float) -> float:
    """The q-th percentile (0 <= q <= 100) of every value, interpolated
    linearly between the two nearest order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    if not 0 <= q <= 100:
        raise ValueError(f"q must be in [0, 100], got {q}")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median, with the quartiles of ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
