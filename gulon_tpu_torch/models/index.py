"""Public index API: ``Index`` base + ``Result``.

Counterpart of the reference's sealed ``Index`` trait (``Index.scala:11-46``)
and ``Index.Result`` (``Index.scala:56-94``): results are parallel arrays of
(key, squared distance) sorted ascending; ``query_by_word`` queries with the
*approximate reconstruction* of the word's vector, exactly like
``Index.scala:44-46``.

The batch-first API is the primary surface — ``query`` is a batch of one.
A copy of ``gulon_tpu/models/index.py`` (host-side numpy), so the port
stands alone, with one addition: the query preparation the PQ indices
share (:meth:`Index._prepare_queries`).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from gulon_tpu_torch.ops.distance import normalize_rows
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class Result:
    """Nearest neighbours of one query, closest first."""

    keys: np.ndarray  # [k] object (str)
    distances: np.ndarray  # [k] f32, squared L2

    def __len__(self) -> int:
        return len(self.keys)

    def __iter__(self):
        return zip(self.keys, self.distances)

    def __getitem__(self, i):
        return self.keys[i], float(self.distances[i])


class Index(abc.ABC):
    """An approximate nearest-neighbour index over keyed vectors."""

    # the port's: the names of the fields an index builds from its rows on
    # first use (kernel operands, caches, memoized statistics)
    _LAZY_OPERANDS = ()

    def _adopt_operands(self, view: "Index") -> None:
        """Take the lazy operands ``view`` (this index with other knobs,
        ``dataclasses.replace``) has built and this index lacks, so views
        made afterwards start from them (``utils/aot.py``)."""
        for name in self._LAZY_OPERANDS:
            if getattr(self, name) is None:
                setattr(self, name, getattr(view, name))

    @property
    @abc.abstractmethod
    def dimension(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def size(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def key_index(self):
        ...

    @abc.abstractmethod
    def batch_query(self, k: int, vectors) -> List[Result]:
        """Approximate k nearest neighbours for each row of ``vectors``."""

    def query_arrays(self, k: int, vectors):
        """Serving fast path: ([Q, k] squared distances, [Q, k] row ids)
        as device arrays — no per-query Result assembly on the host.
        Resolve ids to keys with ``index.key_index.keys[ids]``.
        """
        raise NotImplementedError

    def _prepare_queries(self, vectors) -> torch.Tensor:
        """The port's: queries as a PQ index's scans take them, ``[Q,
        dimension]`` f32 on the index's ``device``, normalized for a
        normalizing ``metric`` (``Index.scala:268-269, :324-331``) and
        rotated by the OPQ ``rotation`` where there is one."""
        with tracing.span("gulon.query.prepare"):
            with tracing.span("gulon.wait.upload_queries"):
                q = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
            if q.ndim != 2 or q.shape[1] != self.dimension:
                raise ValueError(
                    f"queries must be [Q, {self.dimension}], got {tuple(q.shape)}"
                )
            if self.metric.normalized:
                q = normalize_rows(q)
            if self.rotation is not None:
                q = matmul(q, self.rotation, "highest")
            return q

    def query(self, k: int, vector) -> Result:
        vec = np.asarray(vector, np.float32).reshape(1, -1)
        return self.batch_query(k, vec)[0]

    @abc.abstractmethod
    def lookup(self, word: str) -> Optional[np.ndarray]:
        """Approximate (reconstructed) vector of ``word``."""

    def query_by_word(self, k: int, word: str) -> Optional[Result]:
        vec = self.lookup(word)
        if vec is None:
            return None
        return self.query(k, vec)

    def warmup(self, k: int = 10, batch_sizes: Sequence[int] = (1, 1024)):
        """Run the query path once for the given (batch, k) shapes, so
        first-call costs (kernel builds, lazily built operands) land at
        startup rather than on the first request.
        """
        for b in batch_sizes:
            q = np.zeros((b, self.dimension), np.float32)
            self.batch_query(k, q)

    def _make_results(
        self, dists: np.ndarray, ids: np.ndarray
    ) -> List[Result]:
        """Build host Results from device (distance, row-id) arrays."""
        dists = np.asarray(dists)
        ids = np.asarray(ids)
        keys = np.asarray(self.key_index.keys, dtype=object)
        # One vectorized gather for the whole batch (per-query fancy
        # indexing costs ~0.3 ms/query on a 1-core host at batch 1024)
        valid = (ids >= 0) & np.isfinite(dists)  # [Q, k]
        keys_all = keys[np.where(valid, ids, 0)]  # [Q, k] object
        out = []
        for q in range(dists.shape[0]):
            # Drop padding / unprobed slots (id -1 or +inf distance); the
            # reference heap likewise only ever holds scanned candidates.
            v = valid[q]
            if v.all():
                out.append(Result(keys=keys_all[q], distances=dists[q]))
            else:
                out.append(
                    Result(keys=keys_all[q][v], distances=dists[q][v])
                )
        return out
