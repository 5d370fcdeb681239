"""The benchmark's own arithmetic of host timings: window rates and
percentiles over every sample."""
from __future__ import annotations

import math
from typing import Sequence


def rate_s(window_s: float, count: int) -> float:
    """Seconds per call over a window: the whole window over every call
    completed in it."""
    if count <= 0:
        raise ValueError("no call completed in the window")
    return window_s / count


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every sample, linear between the
    two nearest order statistics (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

