"""Window arithmetic: rates and tails over all the work of a window."""

from __future__ import annotations

import math
from typing import Sequence


def rate(units: float, seconds: float) -> float:
    """Work completed over the whole window's time."""
    if seconds <= 0:
        raise ValueError("an empty window has no rate")
    return units / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by the nearest rank:
    the smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[k - 1])
