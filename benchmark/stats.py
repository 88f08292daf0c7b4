"""Statistics of a window's calls."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], pct: float):
    """(the `pct` percentile by the nearest rank, the samples beyond it)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    rank = max(1, math.ceil(pct / 100.0 * len(xs)))
    return xs[rank - 1], len(xs) - rank


def rate(n: int, t_open: float, t_close: float) -> float:
    """Work done over the whole window, its closing sync included."""
    return n / (t_close - t_open)
