"""Flat full-scan PQ index (counterpart of ``gulon_tpu/models/flat.py``,
reference ``SortedIndex``, ``Index.scala:310-337``).

Keys are globally sorted; the whole code matrix is scanned per query
batch. Scan strategies:

- ``"pallas"``: the fused scan kernel K1 (``csrc/adc_scan.cu``), whose
  JAX counterpart is the Pallas kernel; the name is kept so strategy
  values carry over between the packages. On CPU tensors it runs K1's
  plain PyTorch twin;
- ``"decode"``: gather-decode + matmul per row tile, no kernel limits;
- ``"lut"``: per-query lookup-table scan, the cheapest for tiny batches;
- ``"cached"``: scans a decoded copy of the codes built by
  :meth:`FlatIndex.enable_cache`; on a CUDA device inside the kernel's
  limits through the dense kernel K2 (``csrc/dense_scan.cu``) over the
  cache with hi/lo norm lanes, otherwise through ``cached_scan``;
- ``"auto"`` (default): <= 4 queries -> lut (decode for packed codes); a
  cache built -> cached; unpacked codes on a CUDA device and inside the
  kernel's limits -> pallas; otherwise decode.

An OPQ ``rotation`` (``ops/opq.py``) rotates the queries at full f32
before any strategy and is undone by :meth:`FlatIndex.lookup`.
:meth:`FlatIndex.add` and :meth:`FlatIndex.remove` return a new index
whose lazy operands are all cleared. :meth:`FlatIndex.pack_memory` packs
2- and 4-bit codes row-major into bytes (``ops/scan.py::pack_rows``); only
``decode`` reads them, unpacking a tile at a time, as in the JAX package.
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
from gulon_tpu_torch.ops.cuda.adc import K1Operands, pack_codes_t, scan_top_k
from gulon_tpu_torch.ops.cuda.dense import dense_scan_fused, prepare_data
from gulon_tpu_torch.ops.distance import normalize_rows
from gulon_tpu_torch.ops.pq import ProductQuantizer
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.utils import tracing

# Below this many queries the LUT scan moves less data than decode.
_AUTO_LUT_MAX_QUERIES = 4


def _augment_cache(cache: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Dense-kernel operand over a decoded cache: ``[N, D] -> [N,
    padded_dim(D)]`` bf16 with hi/lo norm lanes, on the cache's device."""
    return prepare_data(cache, norms)


@dataclasses.dataclass
class FlatIndex(Index):
    _key_index: SortedKeyIndex
    pq: ProductQuantizer
    codes: torch.Tensor  # [N, m] codes, on the index's device
    recon_norms: torch.Tensor  # [N] f32
    metric: Metric
    scan_strategy: str = "auto"  # "auto"|"decode"|"lut"|"cached"|"pallas"
    tile_rows: int = scan_ops.DEFAULT_TILE_ROWS
    # "default" = TF32 allowed on CUDA, "highest" = full f32
    precision: str = "default"
    # accepted for parity with the JAX package; the port's top-k is exact
    topk_impl: str = "approx"
    recall_target: float = 0.95
    # >1: the pallas scan over-fetches k*rerank_factor candidates and
    # rescores them exactly in f32; 0 = auto from code degeneracy
    rerank_factor: int = 0
    # ranked candidates the fused kernel keeps per 128-row block (1..4);
    # 0 = auto from code degeneracy
    pallas_winners: int = 0
    # [N, m*dsub] decoded codes for the "cached" strategy (enable_cache)
    decoded_cache: Optional[torch.Tensor] = None
    # 0 = codes are [N, m]; 2/4 = row-packed uint8 (see pack_memory)
    packed_width: int = 0
    # [D, D] learned OPQ rotation (ops/opq.py): the codes quantize
    # x @ rotation, queries rotate in _prepare_queries, lookup un-rotates;
    # None = plain PQ. Orthogonal, so reported distances are unchanged
    rotation: Optional[torch.Tensor] = None
    # K1's operands over the rows (ops/cuda/adc.py::K1Operands), built
    # lazily
    _k1_operands: Optional[K1Operands] = None
    # dense-kernel operand over the decoded cache (norm lanes appended),
    # built lazily on CUDA; it replaces decoded_cache once built
    _cache_aug: Optional[torch.Tensor] = None
    # memoized auto knobs (rerank_factor/pallas_winners == 0)
    _auto_rerank: Optional[int] = None
    _auto_dup: Optional[float] = None

    # the fields above that are built on first use from the rows
    _LAZY_OPERANDS = (
        "decoded_cache", "_k1_operands", "_cache_aug", "_auto_rerank", "_auto_dup",
    )

    @property
    def key_index(self) -> SortedKeyIndex:
        return self._key_index

    @property
    def dimension(self) -> int:
        return self.pq.dimension

    @property
    def size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def batch_query(self, k: int, vectors) -> List[Result]:
        dists, ids = self.query_arrays(k, vectors)
        return self._make_results(dists.cpu().numpy(), ids.cpu().numpy())

    def resolve_strategy(self, num_queries: int, k: int) -> str:
        """The scan strategy a ``query_arrays(k, [num_queries, D])`` call
        takes (the ``auto`` policy of ``gulon_tpu/models/flat.py:146-156``,
        with "on a TPU" read as "codes on a CUDA device")."""
        if self.scan_strategy != "auto":
            return self.scan_strategy
        k_eff = min(k, self.size)
        if num_queries <= _AUTO_LUT_MAX_QUERIES and not self.packed_width:
            return "lut"  # lut needs unpacked codes; packed stays on decode
        if self._has_cache():
            return "cached"
        if (self.device.type == "cuda" and not self.packed_width
                and self._kernel_bounds_ok(k_eff)):
            return "pallas"
        return "decode"

    def query_arrays(self, k: int, vectors):
        """([Q, k] squared distances, [Q, k] int32 row ids) as tensors on
        the index's device."""
        with tracing.span("gulon.query"):
            return self._query(k, vectors)

    def _query(self, k: int, vectors):
        scan_ops.resolve_precision(self.precision)
        q = self._prepare_queries(vectors)
        with tracing.span("gulon.query.route"):
            k_eff = min(k, self.size)
            strategy = self.resolve_strategy(q.shape[0], k)
            k_scan = k_eff
            rerank = 1
            if strategy in ("pallas", "cached"):
                rerank = self.resolved_rerank_factor()
            if strategy in ("pallas", "cached") and rerank > 1:
                k_scan = min(self.size, k_eff * rerank)
                if strategy == "pallas":
                    # stay inside the kernel's k <= 128 / n >= 256*k envelope
                    k_scan = min(k_scan, 128, max(k_eff, self.size // 256))
        if strategy == "decode":
            with tracing.span("gulon.scan.decode"):
                dists, ids = scan_ops.adc_scan_decode(
                    q, self.pq.codebooks, self.codes, self.recon_norms,
                    bounds=self.pq.bounds, k=k_eff, tile_rows=self.tile_rows,
                    precision=self.precision, topk_impl=self.topk_impl,
                    recall_target=self.recall_target, packed_width=self.packed_width,
                )
        elif strategy == "lut":
            if self.packed_width:
                raise ValueError(
                    "lut strategy needs unpacked codes (index.pack_memory()"
                    " was called); use scan_strategy='decode'"
                )
            with tracing.span("gulon.scan.lut"):
                dists, ids = scan_ops.adc_scan_lut(
                    self.pq.lut(q),
                    self.codes,
                    torch.ones((self.size,), dtype=torch.bool, device=self.device),
                    k=k_eff, tile_rows=self.tile_rows, topk_impl=self.topk_impl,
                    recall_target=self.recall_target,
                )
        elif strategy == "pallas":
            if self.packed_width:
                raise ValueError(
                    "pallas strategy needs unpacked codes; use "
                    "scan_strategy='decode' after pack_memory()"
                )
            if not self._kernel_bounds_ok(k_scan):
                # tiny corpus / large k / large K: the decode scan
                return dataclasses.replace(self, scan_strategy="decode")._query(k, vectors)
            dists, ids = scan_top_k(
                self._k1(), q, k=k_scan, winners=self.resolved_pallas_winners()
            )
        elif strategy == "cached":
            if self.packed_width and not self._has_cache():
                raise ValueError(
                    "cached strategy needs unpacked codes; build the cache "
                    "before pack_memory()"
                )
            with tracing.span("gulon.scan.cached"):
                q_pad = scan_ops._q_pad(q, self.pq.bounds, self.pq.pad_width)
                if (
                    self.device.type == "cuda"
                    and self.topk_impl != "exact"  # "exact" ranks every row
                    and k_scan <= 128
                    and self.size >= 256 * k_scan
                ):
                    if self._cache_aug is None:
                        if self.decoded_cache is None:
                            self.enable_cache()
                        self._cache_aug = _augment_cache(
                            self.decoded_cache, self.recon_norms
                        )
                        # the operand IS the cache now: hold one copy
                        self.decoded_cache = None
                    # the operand rescore (x4 over-fetch) repairs 128-row
                    # block collisions in cached_scan's bf16 distance class
                    dists, ids = dense_scan_fused(
                        q_pad, self._cache_aug, self.recon_norms, k=k_scan,
                        rescore=max(rerank, 4),
                    )
                else:
                    if self.decoded_cache is None:
                        self.enable_cache()
                    dists, ids = scan_ops.cached_scan(
                        q_pad, self.decoded_cache, self.recon_norms, k=k_scan,
                        tile_rows=self.tile_rows, topk_impl=self.topk_impl,
                        recall_target=self.recall_target,
                    )
        else:
            raise ValueError(f"unknown scan strategy {strategy!r}")
        if k_scan > k_eff:
            dists, ids = scan_ops.rescore_exact(
                q, self.pq.codebooks, self.codes, self.recon_norms, ids,
                bounds=self.pq.bounds, k=k_eff, packed_width=self.packed_width,
            )
        return dists, ids

    def _k1(self) -> K1Operands:
        """K1's operands over the rows, centered, built on first use."""
        if self._k1_operands is None:
            self._k1_operands = K1Operands(
                self.pq.codebooks, pack_codes_t(self.codes, self.pq.num_clusters),
                self.recon_norms, bounds=self.pq.bounds, num_rows=self.size,
                center_scores=True,
            )
        return self._k1_operands

    def resolved_rerank_factor(self) -> int:
        """The effective rerank factor: the explicit knob, or (at 0) an
        auto value from code degeneracy, memoized (see
        ``gulon_tpu/models/flat.py:296-322``). Rows sharing one code tuple
        have equal scan distances, and block-granular selection returns
        at most ``pallas_winners`` of such a cohort per block; corpora that
        collapse onto few codes need over-fetch + exact rescore."""
        if self.rerank_factor:
            return self.rerank_factor
        if self._auto_rerank is None:
            dup = self._code_duplication()
            if dup <= 1.25:
                self._auto_rerank = 1
            else:
                self._auto_rerank = int(min(12, max(4, round(dup))))
        return self._auto_rerank

    def resolved_pallas_winners(self) -> int:
        """Effective per-block winner count: the explicit knob, or (at 0)
        ``ceil(128 * dup / N)`` clamped to 1..4 — the expected members of
        an equal-distance cohort that share one 128-row block."""
        if self.pallas_winners:
            return self.pallas_winners
        dup = self._code_duplication()
        if dup <= 1.25 or self.size == 0:
            return 1
        per_block = 128.0 * dup / self.size
        return int(min(4, max(1, -(-per_block // 1))))

    def _code_duplication(self) -> float:
        """Rows per distinct code over a row sample (memoized)."""
        if self._auto_dup is None:
            n = self.size
            if n == 0:
                self._auto_dup = 1.0
            else:
                sample = min(n, 65536)  # a packed index unpacks only these
                with tracing.span("gulon.wait.code_sample"):
                    codes = self._unpacked_codes(self.codes[:sample]).cpu().numpy()
                distinct = np.unique(codes, axis=0).shape[0]
                self._auto_dup = sample / max(distinct, 1)
        return self._auto_dup

    def _has_cache(self) -> bool:
        """Either cache representation counts: the decoded matrix or the
        dense-kernel operand it turns into on CUDA."""
        return self.decoded_cache is not None or self._cache_aug is not None

    def _kernel_bounds_ok(self, k_eff: int) -> bool:
        return (
            self.size >= 256 * min(k_eff, 128)
            and k_eff <= 128
            and self.pq.num_clusters <= 1024
        )

    def enable_cache(self, dtype=None, chunk: int = 16384) -> None:
        """Materialize the decoded corpus for the ``"cached"`` strategy:
        bf16 when the codes live on a CUDA device (2 bytes a dimension),
        f32 on the CPU, decoded ``chunk`` rows at a time by the exact
        gather."""
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        m, dsub = self.pq.num_quantizers, self.pq.pad_width
        cache = torch.empty((self.size, m * dsub), dtype=dtype, device=self.device)
        for start in range(0, self.size, chunk):
            stop = min(start + chunk, self.size)
            cache[start:stop] = scan_ops.decode_tile(
                self.pq.codebooks, self._unpacked_codes(self.codes[start:stop])
            ).to(dtype)
        self.decoded_cache = cache
        self._cache_aug = None  # the dense-kernel operand rebuilds lazily

    def pack_memory(self) -> None:
        """Pack 2- and 4-bit codes into bytes in device memory (2-4x less),
        unpacked a tile at a time inside the scan
        (``gulon_tpu/models/flat.py:414-428``). Only ``decode`` reads
        packed codes, so the strategy becomes ``decode``; ``lut``,
        ``pallas`` and ``cached`` without a cache raise ``ValueError``.
        Codes wider than 4 bits raise ``ValueError``."""
        width = self.pq.code_bits
        if self.packed_width:
            return
        if width > 4:
            raise ValueError(
                f"in-memory packing needs code width <= 4 bits, got {width}"
            )
        width = 4 if width > 2 else 2
        self.codes = scan_ops.pack_rows(self.codes, width)
        self.packed_width = width
        self.scan_strategy = "decode"

    def _unpacked_codes(self, codes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``codes`` (default: all of them) as ``[rows, m]`` codes of the
        quantizer's storage type, unpacked when the index is packed."""
        codes = self.codes if codes is None else codes
        if not self.packed_width:
            return codes
        return scan_ops.unpack_tile(
            codes, self.pq.num_quantizers, self.packed_width
        ).to(self.pq.dtype_codes)

    def add(self, keys, vectors) -> "FlatIndex":
        """A new index with ``(keys, vectors)`` merged into the key sort
        (``gulon_tpu/models/flat.py:437-470``). New rows are encoded with
        the existing codebooks (frozen-PQ add, ``models/update.py``), after
        the metric's normalization and the rotation; an extra over the
        reference, which builds indices whole."""
        keys_new, x = up.validate_add(keys, vectors, self.dimension)
        xd = torch.from_numpy(x).to(self.device)
        if self.metric.normalized:
            xd = normalize_rows(xd)
        if self.rotation is not None:
            xd = matmul(xd, self.rotation, "highest")
        codes_new = self.pq.encode(xd)
        merged_keys, order = up.merge_sorted_order(self._key_index.keys, keys_new)
        order = torch.from_numpy(order).to(self.device)
        norms_new = self.pq.reconstruction_norms(codes_new)
        return self._replace_rows(
            merged_keys,
            torch.cat([self._unpacked_codes(), codes_new])[order],
            torch.cat([self.recon_norms, norms_new])[order],
        )

    def remove(self, keys) -> "FlatIndex":
        """A new index without the given keys (all occurrences);
        ``KeyError`` for absent keys, ``ValueError`` on emptying."""
        keep = up.removal_mask(self._key_index.keys, keys)
        rows = torch.from_numpy(np.flatnonzero(keep)).to(self.device)
        return self._replace_rows(
            self._key_index.keys[keep], self._unpacked_codes()[rows],
            self.recon_norms[rows],
        )

    def _replace_rows(
        self, keys: np.ndarray, codes: torch.Tensor, norms: torch.Tensor
    ) -> "FlatIndex":
        """The index over new ``[N, m]`` codes: every lazy operand covers
        the old rows, so all of them are cleared and rebuild on first use (a
        stale kernel operand would serve the old rows); a packed index's
        codes are packed again."""
        if self.packed_width:
            codes = scan_ops.pack_rows(codes, self.packed_width)
        return dataclasses.replace(
            self,
            _key_index=SortedKeyIndex(keys),
            codes=codes,
            recon_norms=norms,
            **dict.fromkeys(self._LAZY_OPERANDS),
        )

    def _adopt_operands(self, view: "FlatIndex") -> None:
        super()._adopt_operands(view)
        if self._cache_aug is not None:
            self.decoded_cache = None  # the operand IS the cache (query_arrays)

    def lookup(self, word: str) -> Optional[np.ndarray]:
        row = self._key_index.lookup(word)
        if row is None:
            return None
        rec = self.pq.decode(self._unpacked_codes(self.codes[row : row + 1]))
        if self.rotation is not None:
            # the codes live in the rotated basis; map back
            rec = matmul(rec, self.rotation.T, "highest")
        return rec.cpu().numpy()[0]
