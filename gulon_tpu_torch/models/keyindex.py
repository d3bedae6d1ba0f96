"""String key <-> row index maps (host-side numpy).

Counterpart of reference ``KeyIndex.scala``:

- ``SortedKeyIndex``: binary search over globally sorted keys
  (``KeyIndex.scala:14-28``);
- ``GroupedKeyIndex``: keys sorted within each group, ``group_offsets`` are
  the *internal* group boundaries (length = num_groups - 1, matching the
  ``centroids.length == offsets.length + 1`` invariant of
  ``Index.scala:241-242``). The reference looks keys up by binary-searching
  each group in turn — O(G log(N/G)) per probe (``KeyIndex.scala:30-53``);
  here a lazily built global sort permutation makes lookup one O(log N)
  bisect regardless of partition count (ties resolve to the lowest row,
  i.e. the earliest group, matching the reference's group-order scan).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _as_key_array(keys) -> np.ndarray:
    arr = np.asarray(keys, dtype=object)
    if arr.ndim != 1:
        raise ValueError("keys must be 1-D")
    return arr


def _bisect(keys: np.ndarray, key: str, lo: int, hi: int) -> int:
    """Binary search in keys[lo:hi]; returns index or -1."""
    while lo < hi:
        mid = (lo + hi) // 2
        v = keys[mid]
        if v < key:
            lo = mid + 1
        elif v > key:
            hi = mid
        else:
            return mid
    return -1


@dataclasses.dataclass(frozen=True)
class SortedKeyIndex:
    keys: np.ndarray  # [n] object (str), globally sorted

    def __post_init__(self):
        object.__setattr__(self, "keys", _as_key_array(self.keys))

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, i: int) -> str:
        return self.keys[i]

    def lookup(self, key: str) -> Optional[int]:
        i = _bisect(self.keys, key, 0, len(self.keys))
        return None if i < 0 else i


@dataclasses.dataclass(frozen=True)
class GroupedKeyIndex:
    keys: np.ndarray  # [n] object (str), sorted within each group
    group_offsets: np.ndarray  # [num_groups - 1] int32, internal boundaries

    def __post_init__(self):
        object.__setattr__(self, "keys", _as_key_array(self.keys))
        object.__setattr__(
            self,
            "group_offsets",
            np.asarray(self.group_offsets, dtype=np.int32),
        )

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, i: int) -> str:
        return self.keys[i]

    @property
    def num_groups(self) -> int:
        return len(self.group_offsets) + 1

    def group_bounds(self, g: int):
        """Row range [start, end) of group g (``Index.scala:262-266``)."""
        start = 0 if g == 0 else int(self.group_offsets[g - 1])
        end = (
            len(self.keys)
            if g == len(self.group_offsets)
            else int(self.group_offsets[g])
        )
        return start, end

    def group_of(self, row: int) -> int:
        """Group containing a row (binary search on offsets)."""
        return int(np.searchsorted(self.group_offsets, row, side="right"))

    def lookup(self, key: str) -> Optional[int]:
        cache = getattr(self, "_lookup_cache", None)
        if cache is None:
            # stable sort: equal keys keep ascending row order, so the hit
            # below is the earliest group's occurrence — same answer as the
            # reference's sequential per-group scan (KeyIndex.scala:40-52)
            order = np.argsort(self.keys, kind="stable")
            cache = (self.keys[order], order)
            object.__setattr__(self, "_lookup_cache", cache)
        sorted_keys, order = cache
        i = int(np.searchsorted(sorted_keys, key, side="left"))
        if i < len(sorted_keys) and sorted_keys[i] == key:
            return int(order[i])
        return None
