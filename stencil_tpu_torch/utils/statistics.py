"""Benchmark statistics.

Counterpart of ``stencil_tpu/utils/statistics.py`` (reference
bin/statistics.hpp:6, statistics.cpp:7-55): min/max/avg/stddev/med and the
index-based **trimean** ``(x[n/4] + 2*x[n/2] + x[3n/4]) / 4`` that heads the
drivers' CSV rows.  Sample stddev (n-1), NaN on empty, and ``med()`` returns
the average of the two middle elements for even n.
"""

from __future__ import annotations

import math
from typing import List


class Statistics:
    def __init__(self):
        self._xs: List[float] = []

    def clear(self) -> None:
        self._xs.clear()

    def insert(self, x: float) -> None:
        self._xs.append(float(x))

    def __len__(self) -> int:
        return len(self._xs)

    def count(self) -> int:
        return len(self._xs)

    def min(self) -> float:
        return min(self._xs) if self._xs else math.nan

    def max(self) -> float:
        return max(self._xs) if self._xs else math.nan

    def avg(self) -> float:
        return sum(self._xs) / len(self._xs) if self._xs else math.nan

    def stddev(self) -> float:
        """Sample stddev, n-1 denominator (statistics.cpp:48-55)."""
        if len(self._xs) < 2:
            return math.nan
        m = self.avg()
        return math.sqrt(sum((x - m) ** 2 for x in self._xs) / (len(self._xs) - 1))

    def med(self) -> float:
        if not self._xs:
            return math.nan
        xs = sorted(self._xs)
        n = len(xs)
        if n % 2:
            return xs[n // 2]
        return (xs[n // 2 - 1] + xs[n // 2]) / 2

    def trimean(self) -> float:
        """(x[q] + 2*x[2q] + x[3q]) / 4 with q = n//4 (statistics.cpp:25-34)."""
        if not self._xs:
            return math.nan
        xs = sorted(self._xs)
        q = len(xs) // 4
        return (xs[q] + 2 * xs[2 * q] + xs[3 * q]) / 4
