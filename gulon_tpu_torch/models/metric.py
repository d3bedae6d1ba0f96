"""Distance metric: L2 or Cosine.

Cosine is implemented exactly as in the reference (``Metric.scala:3-9``):
"normalize inputs at ingest, normalize queries at query time, then use L2".
Protobuf enum values match ``index.proto``: L2 = 0, COSINE = 1.
"""

from __future__ import annotations

import enum


class Metric(enum.Enum):
    L2 = 0
    COSINE = 1

    @property
    def normalized(self) -> bool:
        return self is Metric.COSINE

    @staticmethod
    def parse(name: str) -> "Metric":
        try:
            return Metric[name.strip().upper()]
        except KeyError:
            raise ValueError(f"unknown metric {name!r} (expected l2|cosine)")

    @property
    def proto_value(self) -> int:
        return self.value

    @staticmethod
    def from_proto(value: int) -> "Metric":
        return Metric(value)
