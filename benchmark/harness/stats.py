"""Plain statistics of a run's samples."""

from __future__ import annotations


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between order statistics (numpy's default)."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("no values")
    if len(v) == 1:
        return v[0]
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

