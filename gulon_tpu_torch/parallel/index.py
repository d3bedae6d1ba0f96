"""Mesh-sharded index wrappers (counterpart of ``gulon_tpu/parallel/index.py``).

The code matrix (and the IVF row metadata) shards row-wise over a
:class:`~gulon_tpu_torch.parallel.mesh.Mesh`; queries and codebooks are
copied to each shard's device; every ``query_arrays`` runs each shard's
scan on its device and merges the per-shard top-k. Query results match
the single-device classes (same math, same ids, up to near-ties where the
128-row blocks of the fused kernels fall differently), so
:func:`shard_index` is a placement transform.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from gulon_tpu_torch.models.exact import ExactIndex
from gulon_tpu_torch.models.flat import FlatIndex, _augment_cache
from gulon_tpu_torch.models.index import Index, Result
from gulon_tpu_torch.models.ivf import (
    IVFIndex,
    LimitGroups,
    _ivf_scan,
    _next_pow2,
    _pallas_ivf_query,
    _plan_entry_schedule,
    _probe_kind,
    _rank_and_probe,
    _regroup_pairs,
    _scan_entries_codes,
    _PALLAS_BLOCK,
    partition_layout,
)
from gulon_tpu_torch.ops import scan as scan_ops
from gulon_tpu_torch.ops.cuda.adc import K1Operands, pack_codes_t
from gulon_tpu_torch.ops.distance import normalize_rows, sq_norms
from gulon_tpu_torch.ops.topk import smallest_k
from gulon_tpu_torch.parallel import ops as pops
from gulon_tpu_torch.parallel.mesh import ROWS, Mesh, replicate, shard_rows


class _Sharded(Index):
    """What the sharded classes share: the base index's key index,
    geometry and lookup, and functional updates that re-shard the base
    index's result on the same mesh (its lazy operands rebuild)."""

    @property
    def key_index(self):
        return self.base.key_index

    @property
    def dimension(self) -> int:
        return self.base.dimension

    @property
    def size(self) -> int:
        return self.base.size

    @property
    def metric(self):
        return self.base.metric

    def add(self, keys, vectors):
        return shard_index(self.base.add(keys, vectors), self.mesh)

    def remove(self, keys):
        return shard_index(self.base.remove(keys), self.mesh)

    def batch_query(self, k: int, vectors) -> List[Result]:
        dists, ids = self.query_arrays(k, vectors)
        return self._make_results(dists.cpu().numpy(), ids.cpu().numpy())

    def lookup(self, word: str) -> Optional[np.ndarray]:
        return self.base.lookup(word)


@dataclasses.dataclass
class ShardedFlatIndex(_Sharded):
    """Row-sharded counterpart of :class:`FlatIndex` (same query results).

    A base index with a decoded cache (``enable_cache``) has it sharded
    too; ``scan_strategy="cached"`` on the base then selects the sharded
    cache scan (K2 per shard on CUDA shards)."""

    base: FlatIndex
    mesh: Mesh
    codes_sharded: list  # row shards [n_loc, m] (padded with code 0)
    norms_sharded: list  # row shards [n_loc] f32 (+inf padding)
    codebooks_rep: list  # [m, K, dsub] on each shard's device
    cache_sharded: Optional[list] = None  # row shards [n_loc, m*dsub]
    # each shard's K1 operands (ops/cuda/adc.py::K1Operands over
    # pack_codes_t of its rows, as FlatIndex holds its own), built on the
    # shard's first kernel scan; None for shards of other processes
    k1_sharded: Optional[list] = None
    # lazy row shards of K2's [n_loc, Dp] bf16 operand over the cache
    cache_aug_sharded: Optional[list] = None
    # cached-strategy scan: None = auto (K2 per shard on CUDA shards within
    # its envelope, the tiled cache scan otherwise); True/False force
    dense_cached: Optional[bool] = None

    _LAZY_OPERANDS = ("k1_sharded", "cache_aug_sharded")

    @staticmethod
    def shard(index: FlatIndex, mesh: Mesh) -> "ShardedFlatIndex":
        # the sharded scans read [N, m] codes: packing (pack_memory) is a
        # single-device layout, so a packed index unpacks here
        codes = index._unpacked_codes()
        if index.decoded_cache is None and index._cache_aug is not None:
            # the single-device dense route turned the cache into its
            # operand; rebuild the plain decode to shard it
            index.enable_cache()
        return ShardedFlatIndex(
            base=index,
            mesh=mesh,
            codes_sharded=shard_rows(codes, mesh, 0),
            norms_sharded=shard_rows(index.recon_norms, mesh, float("inf")),
            codebooks_rep=replicate(index.pq.codebooks, mesh),
            cache_sharded=(
                shard_rows(index.decoded_cache, mesh, 0)
                if index.decoded_cache is not None else None
            ),
        )

    def query_arrays(self, k: int, vectors):
        base = self.base
        q = base._prepare_queries(vectors)
        k_eff = min(k, self.size)
        if base.scan_strategy == "cached":
            if self.cache_sharded is None:
                raise ValueError(
                    "sharded cached strategy needs enable_cache() before shard_index()"
                )
            local_n = pops._local_n(self.cache_sharded)
            use_dense = self.dense_cached
            if use_dense is None:
                use_dense = (
                    self.mesh.on_cuda
                    and base.topk_impl != "exact"  # "exact" ranks every row
                    and k_eff <= 128
                    and local_n >= 256 * k_eff
                )
            q_pad = scan_ops._q_pad(q, base.pq.bounds, base.pq.pad_width)
            if use_dense:
                # the kernel's operand rescore (bf16 re-rank) plays the
                # rerank_factor role within each shard: the single-device
                # f32 rescore needs the whole code matrix
                return pops.sharded_dense_scan(
                    q_pad, self._dense_cache_operand(), self.norms_sharded,
                    mesh=self.mesh, k=k_eff,
                    rescore=max(base.resolved_rerank_factor(), 4),
                )
            q_pad = replicate(q_pad, self.mesh)
            return pops.scan_and_merge(
                self.mesh, k_eff,
                lambda r: scan_ops.cached_scan(
                    q_pad[r], self.cache_sharded[r],
                    self.norms_sharded[r], k=k_eff, tile_rows=base.tile_rows,
                    topk_impl=base.topk_impl, recall_target=base.recall_target,
                ),
                local_n,
            )
        # the single-device kernel knobs (models/flat.py): block winners and
        # the rerank over-fetch, clamped to the per-shard kernel envelope
        rerank_k = 0
        rerank = base.resolved_rerank_factor()
        if rerank > 1:
            local_n = pops._local_n(self.codes_sharded)
            rerank_k = min(local_n, k_eff * rerank, 128, max(k_eff, local_n // 256))
            if rerank_k <= k_eff:
                rerank_k = 0
        return pops.scan_flat_shards(
            q, self.codebooks_rep, self.codes_sharded, self.norms_sharded, self._k1,
            mesh=self.mesh, bounds=base.pq.bounds, k=k_eff, tile_rows=base.tile_rows,
            precision=base.precision, topk_impl=base.topk_impl,
            recall_target=base.recall_target, winners=base.resolved_pallas_winners(),
            rerank_k=rerank_k,
        )

    def _k1(self, r: int) -> K1Operands:
        """Shard ``r``'s K1 operands, centered, built on first use."""
        if self.k1_sharded is None:
            self.k1_sharded = [None] * len(self.codes_sharded)
        if self.k1_sharded[r] is None:
            codes = self.codes_sharded[r]
            self.k1_sharded[r] = K1Operands(
                self.codebooks_rep[r], pack_codes_t(codes, self.base.pq.num_clusters),
                self.norms_sharded[r], bounds=self.base.pq.bounds,
                num_rows=codes.shape[0], center_scores=True,
            )
        return self.k1_sharded[r]

    def _dense_cache_operand(self) -> list:
        """Row shards of K2's bf16 operand over the sharded cache, built
        once; the +inf padding norms become the finite ``_BIG`` lane
        (``prepare_data`` clamps), which loses every block min."""
        if self.cache_aug_sharded is None:
            self.cache_aug_sharded = [
                None if c is None else _augment_cache(c, n)
                for c, n in zip(self.cache_sharded, self.norms_sharded)
            ]
        return self.cache_aug_sharded


@dataclasses.dataclass
class ShardedIVFIndex(_Sharded):
    """Partition-aware sharded counterpart of :class:`IVFIndex`.

    Whole partitions go to each shard (greedy size balancing), so the
    masked scan, the fused-kernel scan (K1 per shard) and the sublinear
    bucketed scan all run shard by shard, with one merge. Query results
    match the single-device class."""

    base: IVFIndex
    mesh: Mesh
    codes_sharded: list  # row shards [n_loc, m], partition-aware layout
    row_const_sharded: list  # row shards [n_loc] f32 (+inf padding)
    group_ids_sharded: list  # row shards [n_loc] int32
    loc2glob_sharded: list  # row shards [n_loc] int32: local row -> row (-1)
    codebooks_rep: list
    part_shard: np.ndarray  # [P] the shard holding each partition
    local_starts: np.ndarray  # [P] first row of partition p on its shard
    # lazy per-shard partition-padded K1 layouts: (K1 operands over the
    # layout, partition of each 128-row block [npad/128], padded row ->
    # global row [npad]) per shard, npad common to all
    _pallas_sh: Optional[list] = None

    _LAZY_OPERANDS = ("_pallas_sh",)

    @staticmethod
    def shard(index: IVFIndex, mesh: Mesh) -> "ShardedIVFIndex":
        sizes = index.partition_sizes().astype(np.int64)
        num_p = len(sizes)
        n_shards = mesh.shape[ROWS]
        # greedy balance: biggest partitions first onto the lightest shard
        order = np.argsort(-sizes, kind="stable")
        part_shard = np.zeros(num_p, np.int32)
        local_starts = np.zeros(num_p, np.int64)
        load = np.zeros(n_shards, np.int64)
        for p in order:
            s = int(np.argmin(load))
            part_shard[p] = s
            local_starts[p] = load[s]
            load[s] += sizes[p]
        pad_rows = max(int(sizes.max()) if num_p else 1, 512)
        n_loc = int(load.max()) + pad_rows

        g_starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        codes_np = index.codes.cpu().numpy()
        rc_np = index.row_const.cpu().numpy()
        m = codes_np.shape[1]
        codes_s = np.zeros((n_shards, n_loc, m), codes_np.dtype)
        rc_s = np.full((n_shards, n_loc), np.inf, np.float32)
        gid_s = np.zeros((n_shards, n_loc), np.int32)
        l2g_s = np.full((n_shards, n_loc), -1, np.int32)
        for p in range(num_p):
            s, ls, gs, sz = (
                int(part_shard[p]), int(local_starts[p]), int(g_starts[p]), int(sizes[p]),
            )
            codes_s[s, ls : ls + sz] = codes_np[gs : gs + sz]
            rc_s[s, ls : ls + sz] = rc_np[gs : gs + sz]
            gid_s[s, ls : ls + sz] = p
            l2g_s[s, ls : ls + sz] = np.arange(gs, gs + sz, dtype=np.int32)

        def place(a):
            return shard_rows(a.reshape((n_shards * n_loc,) + a.shape[2:]), mesh)

        return ShardedIVFIndex(
            base=index,
            mesh=mesh,
            codes_sharded=place(codes_s),
            row_const_sharded=place(rc_s),
            group_ids_sharded=place(gid_s),
            loc2glob_sharded=place(l2g_s),
            codebooks_rep=replicate(index.pq.codebooks, mesh),
            part_shard=part_shard,
            local_starts=local_starts,
        )

    def _resolve(self, num_q: int, k_eff: int) -> str:
        strategy = self.base.scan_strategy
        if strategy == "auto":
            # the single-device policy (each shard scans its part); the
            # kernel route where the mesh's shards are on CUDA devices
            strategy = self.base._resolve_auto(num_q, k_eff)
            if strategy in ("pallas", "masked"):
                strategy = "pallas" if self.mesh.on_cuda else "masked"
        if strategy not in ("masked", "pallas", "gathered", "bucketed"):
            raise ValueError(
                f"unknown ivf scan strategy {strategy!r} "
                "(expected auto|masked|pallas|gathered|bucketed)"
            )
        if strategy == "pallas" and not self.base._pallas_eligible(k_eff):
            return "masked"
        return strategy

    def query_arrays(self, k: int, vectors):
        base = self.base
        q = base._prepare_queries(vectors)  # normalize + rotation
        kind = _probe_kind(base.strategy)
        sizes = torch.from_numpy(base.partition_sizes()).to(q.device)
        group_term, qn, cdist, probe_mask = _rank_and_probe(
            q, base.centroids, sizes, kind=kind, count=base.strategy.count
        )
        k_eff = min(k, self.size)
        strategy = self._resolve(int(q.shape[0]), k_eff)
        if strategy in ("bucketed", "gathered"):
            # sublinear probing shards like the masked scan: gathered
            # requests also run the (more general) bucketed scan
            return self._bucketed_arrays(q, qn, cdist, group_term, probe_mask, k_eff)
        # every shard's copy of the query-side inputs before any scan
        # (parallel/ops.py)
        q, qn, group_term, probe_mask = (
            replicate(t, self.mesh) for t in (q, qn, group_term, probe_mask)
        )
        if strategy == "pallas":
            return self._pallas_arrays(q, qn, group_term, probe_mask, k_eff)

        def shard_fn(r):
            d, ids = _ivf_scan(
                q[r], self.codebooks_rep[r], self.codes_sharded[r],
                self.row_const_sharded[r], self.group_ids_sharded[r],
                group_term[r], probe_mask[r], bounds=base.pq.bounds,
                k=k_eff, tile_rows=base.tile_rows, precision=base.precision,
                topk_impl=base.topk_impl,
            )
            return d, self._global_rows(r, ids)

        return pops.scan_and_merge(self.mesh, k_eff, shard_fn)

    def _global_rows(self, r: int, ids: torch.Tensor) -> torch.Tensor:
        l2g = self.loc2glob_sharded[r]
        # clamped as the JAX package's gather clamps: a NaN query row's
        # local ids may pass the shard's last row (``_streaming_topk``)
        safe = torch.clamp(ids.long(), 0, l2g.shape[0] - 1)
        return torch.where(ids >= 0, l2g[safe], -1)

    def _pallas_layouts(self) -> list:
        """Per-shard partition-padded K1 layouts (built once): each shard's
        partitions in their local order through
        :func:`~gulon_tpu_torch.models.ivf.partition_layout`, with one
        ``npad`` for every shard; row maps hold global row ids."""
        if self._pallas_sh is None:
            base = self.base
            sizes = base.partition_sizes().astype(np.int64)
            psz = -(-sizes // _PALLAS_BLOCK) * _PALLAS_BLOCK
            order = np.argsort(self.local_starts, kind="stable")
            parts = [order[self.part_shard[order] == r] for r in range(self.mesh.shape[ROWS])]
            npad = max([int(psz[p].sum()) for p in parts] + [_PALLAS_BLOCK])
            layouts = [None] * len(parts)
            for r in self.mesh.local_rows:
                codes_t, rc_pal, blocks, rmap = partition_layout(
                    self.codes_sharded[r], self.row_const_sharded[r], sizes[parts[r]],
                    parts[r], base.pq.num_clusters, npad, num_parts=base.num_partitions,
                )
                k1 = K1Operands(self.codebooks_rep[r], codes_t, rc_pal,
                                bounds=base.pq.bounds, num_rows=npad)
                layouts[r] = (k1, blocks, self._global_rows(r, rmap))
            self._pallas_sh = layouts
        return self._pallas_sh

    def _pallas_arrays(self, q, qn, group_term, probe_mask, k_eff):
        """K1 per shard over its partition-padded layout, the block-constant
        group term and probe mask applied to its winners, then the merge.
        The query-side inputs are per-shard replicas."""
        layouts = self._pallas_layouts()
        base = self.base

        def shard_fn(r):
            k1, blocks, rmap = layouts[r]
            return _pallas_ivf_query(
                q[r], qn[r], group_term[r], probe_mask[r], k1, blocks, rmap,
                k=k_eff, winners=base.pallas_winners, rescore=base.pallas_rescore,
                probe=(_probe_kind(base.strategy), base.strategy.count),
            )

        return pops.scan_and_merge(self.mesh, k_eff, shard_fn)

    def _bucketed_arrays(self, q, qn, cdist, group_term, probe_mask, k_eff):
        """The bucketed entry scan per shard over the probe pairs of its
        partitions (a pair lives on exactly one shard, so the shards'
        regrouped results are disjoint), then the merge."""
        base = self.base
        sizes_np = base.partition_sizes()
        num_p = len(sizes_np)
        if isinstance(base.strategy, LimitGroups):
            num_probe = min(base.strategy.count, num_p)
        else:
            raw = int(probe_mask.sum(dim=1).max())
            num_probe = min(_next_pow2(max(raw, 1)), num_p)
        masked_cdist = torch.where(probe_mask, cdist, float("inf"))
        probe_d, probe_ids = smallest_k(masked_cdist, num_probe)
        probe_np = torch.where(torch.isinf(probe_d), -1, probe_ids).cpu().numpy()

        pmax = int(sizes_np.max()) if num_p else 1
        rcap = min(512, _next_pow2(pmax))
        flat_p = probe_np[probe_np >= 0]
        max_occ = int(np.bincount(flat_p).max()) if flat_p.size else 1
        qcap = min(64, max(8, _next_pow2(max_occ)))
        kk = min(k_eff, rcap)
        q_sub, qn, group_term = (
            replicate(t, self.mesh) for t in (base._q_subspace(q), qn, group_term)
        )

        def shard_fn(r):
            dev = self.mesh.row_device(r)
            on_r = (probe_np >= 0) & (self.part_shard[np.maximum(probe_np, 0)] == r)
            plan = _plan_entry_schedule(
                np.where(on_r, probe_np, -1), sizes_np.astype(np.int64),
                self.local_starts, rcap, qcap, kk,
            )
            e_start, e_size, e_part, e_bucket, pair_slots = (
                torch.from_numpy(a).to(dev) for a in plan
            )
            cand_v, cand_i = _scan_entries_codes(
                q_sub[r], qn[r], group_term[r], self.codebooks_rep[r],
                self.codes_sharded[r], self.row_const_sharded[r],
                e_start, e_size, e_part, e_bucket,
                rcap=rcap, qcap=qcap, kk=kk, precision=base.precision,
                topk_impl=base.topk_impl,
            )
            d, ids = _regroup_pairs(cand_v, cand_i, pair_slots, k=k_eff)
            return d, self._global_rows(r, ids)

        return pops.scan_and_merge(self.mesh, k_eff, shard_fn)


@dataclasses.dataclass
class ShardedExactIndex(_Sharded):
    """Row-sharded counterpart of :class:`ExactIndex`.

    On CUDA shards (or with ``scan_strategy="pallas"`` on the base) each
    shard runs K2 over a bf16 operand built at shard time; otherwise the
    tiled matmul scan."""

    base: ExactIndex
    mesh: Mesh
    vectors_sharded: list  # row shards [n_loc, D] f32 (zero padding)
    norms_sharded: list  # row shards [n_loc] f32 (+inf padding)
    # row shards of K2's [n_loc, Dp] bf16 operand; padding rows get the
    # finite _BIG norm lane (+inf would turn the lane-packed score NaN)
    data_aug_sharded: Optional[list] = None

    _LAZY_OPERANDS = ("data_aug_sharded",)

    @staticmethod
    def shard(index: ExactIndex, mesh: Mesh) -> "ShardedExactIndex":
        x = index.vectors
        sharded = ShardedExactIndex(
            base=index,
            mesh=mesh,
            vectors_sharded=shard_rows(x, mesh, 0),
            norms_sharded=shard_rows(sq_norms(x), mesh, float("inf")),
        )
        # the operand is a second copy of the corpus: built only where the
        # kernel route can run (the tiled scan reads vectors_sharded)
        if mesh.on_cuda or index.scan_strategy == "pallas":
            sharded._dense_operand()
        return sharded

    def _dense_operand(self) -> list:
        if self.data_aug_sharded is None:
            from gulon_tpu_torch.ops.cuda.dense import prepare_data

            self.data_aug_sharded = [
                None if v is None else prepare_data(v, n)
                for v, n in zip(self.vectors_sharded, self.norms_sharded)
            ]
        return self.data_aug_sharded

    def query_arrays(self, k: int, vectors):
        base = self.base
        scan_ops.resolve_precision(base.precision)
        q = torch.as_tensor(vectors, dtype=torch.float32, device=base.device)
        if q.ndim != 2 or q.shape[1] != self.dimension:
            raise ValueError(f"queries must be [Q, {self.dimension}], got {tuple(q.shape)}")
        if base.metric.normalized:
            q = normalize_rows(q)
        k_eff = min(k, self.size)
        local_n = pops._local_n(self.vectors_sharded)
        strategy = base.scan_strategy
        if strategy == "auto":
            # the single-device envelope, per shard
            kernel_ok = k_eff <= 128 and local_n >= 256 * k_eff
            strategy = "pallas" if self.mesh.on_cuda and kernel_ok else "xla"
        if strategy == "pallas":
            return pops.sharded_dense_scan(
                q, self._dense_operand(), self.norms_sharded,
                rescore_rows=self.vectors_sharded if base.exact_rescore else None,
                mesh=self.mesh, k=k_eff, rescore=base.rescore_factor,
            )
        if strategy != "xla":
            raise ValueError(
                f"unknown exact scan strategy {base.scan_strategy!r} (expected auto|xla|pallas)"
            )
        return pops.sharded_exact_scan(
            q, self.vectors_sharded, self.norms_sharded, mesh=self.mesh, k=k_eff,
            tile_rows=base.tile_rows, precision=base.precision,
            topk_impl=base.topk_impl, recall_target=base.recall_target,
        )


def shard_index(
    index: Union[FlatIndex, IVFIndex, ExactIndex], mesh: Mesh
) -> Union[ShardedFlatIndex, ShardedIVFIndex, ShardedExactIndex]:
    """Place an index row-sharded on a mesh. Query results are unchanged."""
    if isinstance(index, FlatIndex):
        return ShardedFlatIndex.shard(index, mesh)
    if isinstance(index, IVFIndex):
        return ShardedIVFIndex.shard(index, mesh)
    if isinstance(index, ExactIndex):
        return ShardedExactIndex.shard(index, mesh)
    raise TypeError(f"cannot shard {type(index)!r}")
