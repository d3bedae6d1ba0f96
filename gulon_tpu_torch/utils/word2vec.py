"""Keyed embedding matrices and their coarse grouping (host-side numpy).

Counterpart of reference ``WordVectors.scala``: the read-order matrix
(``WordVectors.Unindexed``) and its grouping by coarse cluster
(``WordVectors.Grouped``), which the IVF build uses. The word2vec text
readers come with the command-line slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WordVectors:
    """Keyed embedding matrix in read order (``WordVectors.Unindexed``)."""

    keys: np.ndarray  # [n] object (str)
    vectors: np.ndarray  # [n, d] f32

    def __post_init__(self):
        if len(self.keys) != len(self.vectors):
            raise ValueError("keys and vectors must have equal length")

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def dimension(self) -> int:
        return int(self.vectors.shape[1])

    def sorted(self) -> "WordVectors":
        """Sort by key, permuting rows (``WordVectors.scala:60-68``)."""
        order = np.argsort(self.keys, kind="stable")
        return WordVectors(self.keys[order], self.vectors[order])

    def normalized(self) -> "WordVectors":
        norms = np.linalg.norm(self.vectors, axis=1, keepdims=True)
        safe = np.where(norms > 0, norms, 1.0)
        return WordVectors(self.keys, np.where(norms > 0, self.vectors / safe, self.vectors))

    def grouped(self, centroids, assignments) -> "GroupedWordVectors":
        """Group rows by coarse cluster (``WordVectors.scala:24-58``).

        Rows sort stably by (cluster, key); empty clusters are dropped (and
        the surviving centroids renumbered), matching the reference's
        ``WordVectors.grouped``.
        """
        centroids = np.asarray(centroids, np.float32)
        assignments = np.asarray(assignments)
        if len(assignments) != len(self):
            raise ValueError("assignments must cover every row")
        order = np.lexsort((self.keys, assignments))
        keys_g = self.keys[order]
        x_g = self.vectors[order]
        assign_g = assignments[order]
        used = np.unique(assign_g)  # ascending
        remap = np.zeros(int(assignments.max()) + 1 if len(self) else 1,
                         np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        group_ids = remap[assign_g]
        change = np.nonzero(np.diff(group_ids))[0] + 1
        return GroupedWordVectors(
            keys=keys_g,
            vectors=x_g,
            centroids=centroids[used],
            group_ids=group_ids.astype(np.int32),
            group_offsets=change.astype(np.int32),
        )


@dataclasses.dataclass(frozen=True)
class GroupedWordVectors:
    """Rows grouped by coarse cluster (``WordVectors.Grouped``).

    ``group_offsets`` are the *internal* boundaries (num_groups - 1 entries,
    the ``centroids == offsets + 1`` invariant of ``Index.scala:241-242``).
    """

    keys: np.ndarray  # [n] object, sorted within each group
    vectors: np.ndarray  # [n, d] f32, grouped row order
    centroids: np.ndarray  # [G, d] f32, empty clusters dropped
    group_ids: np.ndarray  # [n] i32
    group_offsets: np.ndarray  # [G - 1] i32

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def num_groups(self) -> int:
        return len(self.centroids)

    def cluster_of(self, row: int) -> int:
        """Group containing ``row`` (``WordVectors.scala:110-113``)."""
        return int(self.group_ids[row])

    def residuals(self) -> np.ndarray:
        """``vector - its centroid`` (``WordVectors.scala:115-138``; computed
        on demand — the reference caches via WeakReference, same idea)."""
        return self.vectors - self.centroids[self.group_ids]
