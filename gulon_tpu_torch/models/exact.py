"""Exact brute-force index over raw float vectors (counterpart of
``gulon_tpu/models/exact.py``; the reference's ``exactNearestNeighbours``,
``Index.scala:209-229``, as a first-class index with the PQ indices' API).

Scan strategies:

- ``"pallas"``: the fused dense kernel, K2 (``csrc/dense_scan.cu``) over
  the bf16 operand or K3 over the int8 operand (``operand="int8"``), with
  a rescore of ``rescore_factor * k`` block winners; on CPU tensors the
  kernels' plain PyTorch twins. The name is the JAX package's, so strategy
  values carry over;
- ``"xla"``: the tiled ``exact_scan`` (every row ranked exactly);
- ``"auto"`` (default): pallas when the vectors live on a CUDA device and
  the kernel's limits hold (k <= 128, N >= 256*k), xla otherwise.

Persistence is npz, the JAX package's format: a file saved by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from gulon_tpu_torch.models import update as up
from gulon_tpu_torch.models.index import Index, Result
from gulon_tpu_torch.models.keyindex import SortedKeyIndex
from gulon_tpu_torch.models.metric import Metric
from gulon_tpu_torch.ops import scan as scan_ops
from gulon_tpu_torch.ops.distance import normalize_rows, sq_norms
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE


@dataclasses.dataclass
class ExactIndex(Index):
    _key_index: SortedKeyIndex
    vectors: torch.Tensor  # [N, D] f32 (normalized at build for Cosine)
    metric: Metric
    tile_rows: int = scan_ops.DEFAULT_TILE_ROWS
    precision: str = "default"
    topk_impl: str = "approx"
    recall_target: float = 0.95
    scan_strategy: str = "auto"  # "auto"|"xla"|"pallas"
    # the kernel route over-fetches rescore_factor * k block winners
    rescore_factor: int = 4
    # True: re-rank from the f32 rows (exact distances); False: from the
    # kernel operand (bf16 rows, or dequantized int8 rows)
    exact_rescore: bool = True
    # kernel operand: "bf16" (K2) or "int8" (K3, half the operand bytes);
    # int8 falls back to bf16 when the corpus norms do not fit its encoding
    operand: str = "bf16"
    _data_t: Optional[torch.Tensor] = None  # lazy [N, Dp] bf16 operand
    _data_i8: Optional[tuple] = None  # lazy (data_i8, meta), (None, None) = unfit
    _norms: Optional[torch.Tensor] = None  # lazy [N] f32 ||x||^2

    _LAZY_OPERANDS = ("_data_t", "_data_i8", "_norms")

    @property
    def key_index(self) -> SortedKeyIndex:
        return self._key_index

    @property
    def dimension(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def size(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def resolved_operand(self) -> str:
        """The operand the kernel route serves: ``operand``, except that
        ``"int8"`` reads ``"bf16"`` for a corpus whose norms do not fit the
        int8 encoding (the JAX package's rule). Builds the int8 operand
        on first use."""
        if self.operand == "int8" and self._int8_operand() is None:
            return "bf16"
        return self.operand

    def batch_query(self, k: int, vectors) -> List[Result]:
        dists, ids = self.query_arrays(k, vectors)
        return self._make_results(dists.cpu().numpy(), ids.cpu().numpy())

    def resolve_strategy(self, k: int) -> str:
        """The scan strategy a ``query_arrays(k, ...)`` call takes (the
        ``auto`` policy of ``gulon_tpu/models/exact.py:94-103``, with "on
        a TPU" read as "vectors on a CUDA device")."""
        if self.scan_strategy != "auto":
            return self.scan_strategy
        k_eff = min(k, self.size)
        if self.device.type == "cuda" and k_eff <= 128 and self.size >= 256 * k_eff:
            return "pallas"
        return "xla"

    def _norms_of_rows(self) -> torch.Tensor:
        if self._norms is None:
            self._norms = sq_norms(self.vectors)
        return self._norms

    def _int8_operand(self):
        """``(data_i8, meta)``, or None for a corpus the int8 encoding
        refuses; the attempt is a full-corpus pass, so it is remembered."""
        from gulon_tpu_torch.ops.cuda.dense import prepare_data_i8

        if self._data_i8 is None:
            try:
                d8, meta, _ = prepare_data_i8(self.vectors, self._norms_of_rows())
                self._data_i8 = (d8, meta)
            except ValueError:
                self._data_i8 = (None, None)
        return None if self._data_i8[0] is None else self._data_i8

    def query_arrays(self, k: int, vectors):
        """([Q, k] squared distances, [Q, k] int32 row ids) as tensors on
        the index's device."""
        scan_ops.resolve_precision(self.precision)
        q = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        if q.ndim != 2 or q.shape[1] != self.dimension:
            raise ValueError(
                f"queries must be [Q, {self.dimension}], got {tuple(q.shape)}"
            )
        if self.metric.normalized:
            q = normalize_rows(q)
        k_eff = min(k, self.size)
        strategy = self.resolve_strategy(k)
        if strategy == "pallas":
            from gulon_tpu_torch.ops.cuda.dense import (
                dense_scan_fused,
                dense_scan_fused_i8,
                prepare_data,
            )

            if self.exact_rescore and self.rescore_factor < 1:
                # rescore 0 disables the re-rank, which would silently
                # report approximate distances from an index named Exact
                raise ValueError(
                    "exact_rescore=True requires rescore_factor >= 1 "
                    "(rescore_factor=0 disables re-ranking; set "
                    "exact_rescore=False for raw kernel distances)"
                )
            norms = self._norms_of_rows()
            rows = self.vectors if self.exact_rescore else None
            if self.resolved_operand == "int8":
                d8, meta = self._data_i8
                return dense_scan_fused_i8(
                    q, d8, meta, norms, k=k_eff, rescore_rows=rows,
                    rescore=self.rescore_factor,
                )
            if self._data_t is None:
                self._data_t = prepare_data(self.vectors, norms)
            return dense_scan_fused(
                q, self._data_t, norms, k=k_eff, rescore_rows=rows,
                rescore=self.rescore_factor,
            )
        if strategy != "xla":
            raise ValueError(
                f"unknown exact scan strategy {self.scan_strategy!r} "
                "(expected auto|xla|pallas)"
            )
        return scan_ops.exact_scan(
            q, self.vectors, k=k_eff, tile_rows=self.tile_rows,
            precision=self.precision, topk_impl=self.topk_impl,
            recall_target=self.recall_target,
        )

    def lookup(self, word: str) -> Optional[np.ndarray]:
        row = self._key_index.lookup(word)
        if row is None:
            return None
        return self.vectors[row].cpu().numpy()

    def add(self, keys, vectors) -> "ExactIndex":
        """A new index with ``(keys, vectors)`` merged in key order (an
        extra over the reference; ``gulon_tpu/models/update.py``). The
        lazy kernel operands rebuild on the new index's first query."""
        keys_new, x = up.validate_add(keys, vectors, self.dimension)
        xd = torch.from_numpy(x).to(self.device)
        if self.metric.normalized:
            xd = normalize_rows(xd)
        merged_keys, order = up.merge_sorted_order(self._key_index.keys, keys_new)
        merged = torch.cat([self.vectors, xd])[torch.from_numpy(order).to(self.device)]
        return self._replace_rows(merged_keys, merged)

    def remove(self, keys) -> "ExactIndex":
        """A new index without the given keys (all occurrences);
        ``KeyError`` for absent keys, ``ValueError`` on emptying."""
        keep = up.removal_mask(self._key_index.keys, keys)
        rows = torch.from_numpy(np.flatnonzero(keep)).to(self.device)
        return self._replace_rows(self._key_index.keys[keep], self.vectors[rows])

    def _replace_rows(self, keys: np.ndarray, vectors: torch.Tensor) -> "ExactIndex":
        return dataclasses.replace(
            self, _key_index=SortedKeyIndex(keys), vectors=vectors,
            **dict.fromkeys(self._LAZY_OPERANDS),
        )

    def save(self, path) -> None:
        # through an open handle: np.savez appends ".npz" to bare paths
        with open(path, "wb") as f:
            np.savez_compressed(
                f,
                keys=np.asarray(self.key_index.keys, dtype=np.str_),
                vectors=self.vectors.cpu().numpy(),
                metric=np.int32(self.metric.proto_value),
            )

    @staticmethod
    def load(path, *, device=DEFAULT_DEVICE) -> "ExactIndex":
        with np.load(path, allow_pickle=False) as z:
            keys = z["keys"].astype(object)
            vectors = torch.from_numpy(z["vectors"].astype(np.float32)).to(device)
            metric = Metric.from_proto(int(z["metric"]))
        return ExactIndex(SortedKeyIndex(keys), vectors, metric)


def build_exact_index(
    keys, vectors, metric: Metric = Metric.L2, *, device=DEFAULT_DEVICE
) -> ExactIndex:
    """Sort keys (stable) and place the raw vectors on ``device``; Cosine
    normalizes the rows on the host first."""
    x = np.asarray(vectors, np.float32)
    keys = np.asarray(keys, dtype=object)
    if len(keys) != len(x):
        raise ValueError("keys and vectors must have equal length")
    if metric.normalized:
        norms = np.linalg.norm(x, axis=1, keepdims=True)
        x = np.where(norms > 0, x / np.where(norms > 0, norms, 1.0), x)
    order = np.argsort(keys, kind="stable")
    return ExactIndex(
        _key_index=SortedKeyIndex(keys[order]),
        vectors=torch.from_numpy(np.ascontiguousarray(x[order])).to(device),
        metric=metric,
    )
