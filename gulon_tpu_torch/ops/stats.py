"""Streaming summary statistics (count / mean / variance) with monoidal merge.

Counterpart of the reference's ``SummaryStats`` (a Welford
single-point builder plus Chan's parallel merge; see reference
``core/.../MathUtils.scala:5-60``). Used for k-means step-size reporting and
for aggregating recall@k across queries in the evaluation harness. A copy
of ``gulon_tpu/ops/stats.py``: host-side plain floats and numpy.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class SummaryStats:
    """Count, mean and (population) variance of a stream of floats.

    Merge (``+``) follows Chan et al.'s parallel update, so stats computed on
    shards can be combined exactly (up to float error), matching the monoid
    instance at reference ``MathUtils.scala:9-41``.
    """

    count: int = 0
    mean: float = 0.0
    m2: float = 0.0  # sum of squared deviations from the mean

    @property
    def variance(self) -> float:
        if self.count == 0:
            return float("nan")
        return self.m2 / self.count

    @property
    def stddev(self) -> float:
        return math.sqrt(self.variance) if self.count > 0 else float("nan")

    def __add__(self, other: "SummaryStats") -> "SummaryStats":
        if self.count == 0:
            return other
        if other.count == 0:
            return self
        n = self.count + other.count
        delta = other.mean - self.mean
        mean = self.mean + delta * (other.count / n)
        m2 = self.m2 + other.m2 + delta * delta * (self.count * other.count / n)
        return SummaryStats(n, mean, m2)

    def update(self, x: float) -> "SummaryStats":
        """Welford single-point update (reference ``MathUtils.scala:43-57``)."""
        n = self.count + 1
        delta = x - self.mean
        mean = self.mean + delta / n
        m2 = self.m2 + delta * (x - mean)
        return SummaryStats(n, mean, m2)

    @staticmethod
    def of(values) -> "SummaryStats":
        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size == 0:
            return SummaryStats()
        mean = float(arr.mean())
        m2 = float(((arr - mean) ** 2).sum())
        return SummaryStats(int(arr.size), mean, m2)

    @staticmethod
    def zero() -> "SummaryStats":
        return SummaryStats()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"SummaryStats(count={self.count}, mean={self.mean:.6g}, "
            f"stddev={self.stddev:.6g})"
        )
