"""The arithmetic of the measured window.

A rate is all the work of the window over all of its time, the time
from the start of its first call to the end of its last.  A tail is a
percentile of every call of the window, never of medians of chunks.
"""

from __future__ import annotations

import math


class Window:
    """The calls of one measured window: each call's start and end on
    the host's clock (seconds) and the work it did (image pixels)."""

    def __init__(self):
        self.starts: list[float] = []
        self.ends: list[float] = []
        self.work: list[float] = []

    def add(self, start: float, end: float, work: float) -> None:
        self.starts.append(start)
        self.ends.append(end)
        self.work.append(work)

    @property
    def calls(self) -> int:
        return len(self.starts)

    @property
    def seconds(self) -> float:
        """From the first call's start to the last call's end."""
        return self.ends[-1] - self.starts[0] if self.starts else 0.0

    @property
    def call_seconds(self) -> list[float]:
        return [e - s for s, e in zip(self.starts, self.ends)]

    def rate(self) -> float | None:
        """Work over the window's seconds; None for an empty window."""
        if not self.starts or self.seconds <= 0:
            return None
        return sum(self.work) / self.seconds


def percentile(values: list[float], q: float) -> float | None:
    """The nearest-rank q-th percentile (0 < q <= 100) of all values:
    the smallest value with at least q% of the values at or below it."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]
