"""The window's arithmetic: a rate over the whole window and a percentile
over all of its steps or requests."""

from __future__ import annotations

import math
from typing import Sequence


def rate(work: float, t_start: float, t_last_end: float) -> float:
    """Work done divided by the time from the window's start to the end of
    its last completed step."""
    span = t_last_end - t_start
    if span <= 0 or work <= 0:
        raise ValueError(f"no completed work in the window (work {work}, span {span} s)")
    return work / span


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) of all values, interpolated linearly
    between the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values: Sequence[float]) -> float:
    return percentile(values, 50.0)

