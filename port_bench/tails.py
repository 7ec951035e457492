"""Order statistics shared by the metric readers."""

from __future__ import annotations

import math


def percentile(values, q: float):
    """Nearest-rank ``q``-th percentile (the smallest value with at least q%
    of the sample at or below it); None for an empty sample."""
    vals = sorted(values)
    if not vals:
        return None
    return vals[max(0, math.ceil(q / 100.0 * len(vals)) - 1)]


def median(values):
    return percentile(values, 50.0)
