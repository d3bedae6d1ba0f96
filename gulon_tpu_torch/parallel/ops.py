"""Sharded compute: per-shard scans with a top-k merge, and mesh builds
(counterpart of ``gulon_tpu/parallel/ops.py``).

Where the JAX package runs one SPMD program under ``shard_map``, the port
loops over this process's row shards in one thread: each shard's scan is
launched on its own device (K1 and K2 on CUDA devices, their plain
versions or the tiled scans elsewhere), every launch is issued before any
result crosses a device, and the per-shard ``[Q, k]`` winners then meet
in one merge, the functional ``TopKHeap.merge`` (``TopKHeap.scala:44-53``):
``O(Q * k * shards)`` values. Besides those, only the queries cross
devices, and before the first launch: a cross-device copy is
ordered after the work already queued on its source device, so a copy
issued after shard 0's scan would hold the other devices back until it
ends.

The mesh builds shard rows over every device (``sharded_encode``) and run
Lloyd's k-means with rows data-parallel and subspaces over ``"sub"``
(``sharded_fit_kmeans``); the partial segment sums add up in shard order
on the lead device, so two runs give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gulon_tpu_torch.ops import scan as scan_ops
from gulon_tpu_torch.ops.cuda.adc import K1Operands, scan_top_k
from gulon_tpu_torch.ops.distance import sq_norms
from gulon_tpu_torch.ops.kmeans import (
    KMeansConfig,
    KMeansResult,
    _assign_blocked,
    _means,
    _segment_sums,
    draw_init_indices,
    kmeans_pp_indices,
)
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.ops.topk import smallest_k
from gulon_tpu_torch.parallel.mesh import (
    ROWS,
    SUB,
    Mesh,
    all_reduce_sum,
    gather_shards,
    replicate,
)


def _merge_over_rows(local_d: Sequence[torch.Tensor], local_ids: Sequence[torch.Tensor],
                     k: int, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shards' ``[Q, k]`` winners side by side in shard order
    (``[Q, S*k]``), reduced to the k smallest; equal values keep the
    lowest position, as ``lax.top_k`` does."""
    all_d = gather_shards(mesh, local_d, dim=1)
    all_i = gather_shards(mesh, local_ids, dim=1)
    vals, pos = smallest_k(all_d, k)
    return vals, torch.gather(all_i, 1, pos.long())


def _globalize_ids(local_ids: torch.Tensor, shard: int, local_n: int) -> torch.Tensor:
    """Local row ids -> global, keeping the -1 "empty slot" sentinel."""
    return torch.where(local_ids >= 0, local_ids + shard * local_n, -1)


def _local_n(sharded: Sequence[Optional[torch.Tensor]]) -> int:
    """Rows of a shard (every shard has as many)."""
    return next(t for t in sharded if t is not None).shape[0]


def scan_and_merge(mesh: Mesh, k: int, shard_fn: Callable[[int], tuple],
                   local_n: Optional[int] = None):
    """``shard_fn(r) -> ([Q, k] dists, [Q, k] ids)`` for each of this
    process's row shards, then the merge. Ids are local rows of ``local_n``
    rows a shard, or already global when ``local_n`` is None. Every
    shard's work is issued before the merge copies anything."""
    d_parts, i_parts = [], []
    for r in mesh.local_rows:
        d, ids = shard_fn(r)
        d_parts.append(d)
        i_parts.append(ids if local_n is None else _globalize_ids(ids, r, local_n))
    return _merge_over_rows(d_parts, i_parts, k, mesh)


def sharded_adc_scan(
    queries: torch.Tensor,  # [Q, D] f32
    codebooks: Sequence[torch.Tensor],  # [m, K, dsub] f32 on each shard's
    #   device (replicate())
    codes: Sequence[torch.Tensor],  # row shards [n_loc, m] (padded with code 0)
    recon_norms: Sequence[torch.Tensor],  # row shards [n_loc] f32, +inf padding
    codes_t: Optional[Sequence[torch.Tensor]] = None,  # row shards of the
    #   pretransposed kernel operand [m, n_loc] (pack_codes_t per shard)
    *,
    mesh: Mesh,
    bounds,
    k: int,
    tile_rows: int = scan_ops.DEFAULT_TILE_ROWS,
    precision: str = "default",
    topk_impl: str = "approx",
    recall_target: float = 0.95,
    winners: int = 1,  # per-128-row-block winner count (FlatIndex.pallas_winners)
    rerank_k: int = 0,  # > k: each shard's kernel over-fetches rerank_k and
    #   rescores them exactly (f32 ADC) to k before the merge
    force_kernel: bool = False,  # the kernel route on CPU shards too (its
    #   plain version), as force_pallas runs interpret mode in the JAX package
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded ADC scan: the fused kernel K1 per shard (CUDA shards,
    within its envelope ``k <= 128``, ``K <= 1024``, ``n_loc >= 256*k``)
    over operands built for the call, or the decode scan, then the merge.
    Returns ``([Q, k] dists, [Q, k] global row ids)`` on the lead device."""

    def k1_of(r):
        if codes_t is None:
            return K1Operands(codebooks[r], codes[r], recon_norms[r], bounds=bounds,
                              center_scores=True)
        return K1Operands(codebooks[r], codes_t[r], recon_norms[r], bounds=bounds,
                          num_rows=codes_t[r].shape[1], center_scores=True)

    return scan_flat_shards(
        queries, codebooks, codes, recon_norms, k1_of, mesh=mesh, bounds=bounds, k=k,
        tile_rows=tile_rows, precision=precision, topk_impl=topk_impl,
        recall_target=recall_target, winners=winners, rerank_k=rerank_k,
        force_kernel=force_kernel,
    )


def scan_flat_shards(
    queries: torch.Tensor,
    codebooks: Sequence[torch.Tensor],
    codes: Sequence[torch.Tensor],
    recon_norms: Sequence[torch.Tensor],
    k1_of: Callable[[int], K1Operands],  # shard -> its K1 operands
    *,
    mesh: Mesh,
    bounds,
    k: int,
    tile_rows: int,
    precision: str,
    topk_impl: str,
    recall_target: float,
    winners: int,
    rerank_k: int,
    force_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sharded_adc_scan` with each shard's K1 operands from
    ``k1_of`` (a sharded index's held ones), asked for only where the
    kernel route runs."""
    local_n = _local_n(codes)
    queries = replicate(queries, mesh)
    k_codes = codebooks[mesh.local_rows[0]].shape[1]
    k_scan = rerank_k if rerank_k > k else k
    use_kernel = (
        (mesh.on_cuda or force_kernel)
        and k_scan <= 128
        and k_codes <= 1024
        and local_n >= 256 * k_scan
    )
    if not use_kernel:
        k_scan = k  # the rerank over-fetch repairs the kernel route only

    def shard_fn(r):
        q, cb = queries[r], codebooks[r]
        if use_kernel:
            d, ids = scan_top_k(k1_of(r), q, k=k_scan, winners=winners)
        else:
            d, ids = scan_ops.adc_scan_decode(
                q, cb, codes[r], recon_norms[r], bounds=bounds, k=k,
                tile_rows=tile_rows, precision=precision, topk_impl=topk_impl,
                recall_target=recall_target,
            )
        if k_scan > k:
            # each shard's k best exact distances: the merged top-k is the
            # global exact top-k
            d, ids = scan_ops.rescore_exact(
                q, cb, codes[r], recon_norms[r], ids, bounds=bounds, k=k
            )
        return d, ids

    return scan_and_merge(mesh, k, shard_fn, local_n)


def sharded_exact_scan(
    queries: torch.Tensor,  # [Q, D] f32
    data: Sequence[torch.Tensor],  # row shards [n_loc, D]
    data_norms: Sequence[torch.Tensor],  # row shards [n_loc] f32, +inf padding
    *,
    mesh: Mesh,
    k: int,
    tile_rows: int = scan_ops.DEFAULT_TILE_ROWS,
    precision: str = "highest",
    topk_impl: str = "exact",
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded brute-force top-k: the tiled matmul scan per shard over
    the shard's own norms (padding rows +inf), then the merge."""
    scan_ops._check_topk_impl(topk_impl)
    local_n = _local_n(data)
    num_q = queries.shape[0]
    queries = replicate(queries, mesh)

    def shard_fn(r):
        dev = mesh.row_device(r)
        q, x, xn = queries[r], data[r], data_norms[r]
        qn = sq_norms(q)

        def dist_tile(start, stop):
            ip = matmul(q, x[start:stop].T, precision)
            return qn[:, None] + xn[None, start:stop] - 2.0 * ip

        tr = min(tile_rows, max(local_n, 1))
        return scan_ops._streaming_topk(
            dist_tile, local_n, tr, num_q, k, dev, topk_impl=topk_impl
        )

    return scan_and_merge(mesh, k, shard_fn, local_n)


def sharded_dense_scan(
    queries: torch.Tensor,  # [Q, D] f32 (subspace-padded layout for the
    #   cached decode, raw vectors for the exact index)
    data_aug: Sequence[torch.Tensor],  # row shards [n_loc, Dp] bf16 K2
    #   operand (prepare_data; padding rows carry a finite _BIG norm lane,
    #   never +inf)
    norms: Sequence[torch.Tensor],  # row shards [n_loc] f32 (read by the f32
    #   rescore only; padding entries are never gathered)
    rescore_rows: Optional[Sequence[torch.Tensor]] = None,  # row shards
    #   [n_loc, D] f32: exact-f32 re-rank rows (ExactIndex.exact_rescore)
    *,
    mesh: Mesh,
    k: int,
    rescore: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded fused dense scan: K2 per shard (its plain version on
    CPU shards), with its over-fetch rescore, then the merge. Needs
    ``n_loc >= 256 * min(k, 128)`` and ``k <= 128``; callers gate and take
    :func:`sharded_exact_scan` outside that."""
    from gulon_tpu_torch.ops.cuda.dense import dense_scan_fused

    local_n = _local_n(data_aug)
    queries = replicate(queries, mesh)

    def shard_fn(r):
        return dense_scan_fused(
            queries[r], data_aug[r], norms[r], k=k,
            rescore=rescore,
            rescore_rows=None if rescore_rows is None else rescore_rows[r],
        )

    return scan_and_merge(mesh, k, shard_fn, local_n)


def _positions(mesh: Mesh) -> List[Tuple[int, int]]:
    """This process's ``(row, sub)`` grid positions, in grid order."""
    rows, sub = mesh.devices.shape
    return [(r, s) for r in range(rows) for s in range(sub)
            if mesh.owners[r, s] == mesh.rank]


def sharded_encode(
    pq,
    x,
    mesh: Mesh,
    *,
    chunk: int = 1 << 20,
    block_rows: int = 65536,
    precision: Optional[str] = None,
) -> np.ndarray:
    """Mesh-parallel bulk encode: rows shard over every device of the mesh
    (both axes), each device encodes its rows with its copy of the
    codebooks, and ``x`` (host array or tensor) streams through the mesh
    ``chunk`` rows at a time, never the whole corpus through one device,
    at ``precision`` or else the quantizer's ``encode_precision``.
    Returns the ``[N, m]`` codes as a host array, in every process."""
    positions = _positions(mesh)
    n_dev, sub = mesh.size, mesh.devices.shape[1]
    codebooks = {}
    for r, s in positions:
        dev = mesh.devices[r, s]
        if dev not in codebooks:
            codebooks[dev] = dataclasses.replace(pq, codebooks=pq.codebooks.to(dev))
    out_dtype = np.uint8 if pq.dtype_codes == torch.uint8 else np.int32
    out = np.empty((len(x), pq.num_quantizers), out_dtype)
    for start in range(0, len(x), chunk):
        xc = x[start : start + chunk]
        xc = xc.to(torch.float32) if isinstance(xc, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(xc, np.float32))
        rows = xc.shape[0]
        n_pad = (-rows) % n_dev
        if n_pad:
            xc = torch.cat([xc, xc.new_zeros((n_pad, xc.shape[1]))])
        per = xc.shape[0] // n_dev
        # every piece is placed before any encode is issued
        devs = [mesh.devices[r, s] for r, s in positions]
        pieces = [xc[(r * sub + s) * per : (r * sub + s + 1) * per].to(dev)
                  for (r, s), dev in zip(positions, devs)]
        parts = [codebooks[dev].encode(piece, block_rows, precision)
                 for dev, piece in zip(devs, pieces)]
        codes = gather_shards(mesh, parts, dim=0)
        out[start : start + rows] = codes[:rows].cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# Distributed k-means: rows data-parallel x subspaces over "sub"
# ---------------------------------------------------------------------------


def sharded_fit_kmeans(
    x,
    config: KMeansConfig,
    mesh: Mesh,
    *,
    init_indices=None,
) -> KMeansResult:
    """Lloyd's k-means over a ``(rows x sub)`` mesh.

    ``x`` is ``[n, d]`` or stacked ``[m, n, d]`` (host array or tensor).
    Row shards cover ``"rows"``, stacked subspaces split over ``"sub"``; a
    subspace count that ``sub`` does not divide (the coarse k-means, m=1)
    flattens the mesh so every device takes rows. Each iteration's segment
    sums are per-shard partials added in shard order on the lead device,
    then summed across processes; empty clusters become zeros and each
    subspace stops at its own assignment fixpoint, as in ``fit_kmeans``.

    The init is ``fit_kmeans``'s draw over the whole input (``init_indices``
    ``[m, k]`` replaces it, as there); k-means++ seeds from a row subsample
    of ``max(k*64, 65536)`` rows drawn with ``np.random.default_rng(seed)``,
    the JAX package's draw, with the port's own D^2 seeding on it.
    Returns centroids and assignments on the mesh's lead device."""
    if config.init not in ("sample", "kmeans++"):
        raise ValueError(f"unknown init {config.init!r} (expected 'sample' or 'kmeans++')")
    x = x.to(torch.float32) if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x, np.float32))
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    m, n, d = x.shape
    k = config.k
    if m % mesh.shape[SUB] != 0:
        mesh = mesh.flattened()
    lead = mesh.lead_device

    if init_indices is not None:
        idx = torch.as_tensor(np.asarray(init_indices), dtype=torch.long)
        if idx.shape != (m, k):
            raise ValueError(f"init_indices must be [{m}, {k}], got {tuple(idx.shape)}")
    elif config.init == "kmeans++":
        cap = min(n, max(k * 64, 65536))
        rows = None
        seed_x = x
        if cap < n:
            rng = np.random.default_rng(config.seed)
            rows = torch.from_numpy(np.sort(rng.choice(n, size=cap, replace=False)))
            seed_x = x[:, rows.to(x.device)]
        idx = kmeans_pp_indices(seed_x.to(lead), k, config.seed).cpu()
        if rows is not None:
            idx = rows[idx]
    else:
        idx = draw_init_indices(m, n, k, config.seed)
    sub_x = torch.arange(m)[:, None]
    centroids = x[sub_x.to(x.device), idx.to(x.device)].to(lead)  # [m, k, d]

    r_shards, m_shards = mesh.shape[ROWS], mesh.shape[SUB]
    m_loc = m // m_shards
    n_loc = -(-n // r_shards)
    shards = {}  # (r, s) -> (x [m_loc, n_loc, d], valid [n_loc]) on its device
    for r, s in _positions(mesh):
        dev = mesh.devices[r, s]
        lo, hi = min(r * n_loc, n), min((r + 1) * n_loc, n)
        xs = x[s * m_loc : (s + 1) * m_loc, lo:hi]
        if hi - lo < n_loc:
            xs = torch.cat([xs, xs.new_zeros((m_loc, n_loc - (hi - lo), d))], dim=1)
        # padding rows count for nothing (None: the shard is all real rows)
        valid = (torch.arange(n_loc) < hi - lo).to(dev) if hi - lo < n_loc else None
        shards[(r, s)] = (xs.to(dev), valid)
    bs = config.block_rows

    def subspaces(c, s, dev):
        return c[s * m_loc : (s + 1) * m_loc].to(dev)

    def assign_all(c):
        # centroids placed on every device before any assignment
        local = {pos: subspaces(c, pos[1], xs.device) for pos, (xs, _) in shards.items()}
        return {
            pos: _assign_blocked(xs, local[pos], bs, config.precision)
            for pos, (xs, _) in shards.items()
        }

    def combine(parts, shape, dtype=torch.float32):
        """Per-position partials summed over rows in shard order, per
        subspace group, on the lead device; then across processes."""
        out = torch.zeros(shape, dtype=dtype, device=lead)
        for (r, s), p in sorted(parts.items()):
            out[s * m_loc : (s + 1) * m_loc] += p.to(lead)
        return all_reduce_sum(mesh, out)

    assignments = assign_all(centroids)
    done = torch.zeros(m, dtype=torch.bool, device=lead)
    it = 0
    while it < config.max_iters and not bool(done.all()):
        partial = {pos: _segment_sums(xs, assignments[pos], k, valid)
                   for pos, (xs, valid) in shards.items()}
        sums = combine({p: v[0] for p, v in partial.items()}, (m, k, d))
        counts = combine({p: v[1] for p, v in partial.items()}, (m, k, 1))
        new_c = torch.where(done[:, None, None], centroids, _means(sums, counts))
        new_a = assign_all(new_c)
        unchanged = {}
        for pos, (xs, valid) in shards.items():
            keep = subspaces(done, pos[1], xs.device)
            new_a[pos] = torch.where(keep[:, None], assignments[pos], new_a[pos])
            same = new_a[pos] == assignments[pos]
            if valid is not None:
                same = same & valid[None, :]
            unchanged[pos] = same.sum(dim=1)
        done = done | (combine(unchanged, (m,), torch.int64) == n)
        centroids, assignments = new_c, new_a
        it += 1

    # [m_loc, n_loc] per position -> [m, n] in row order
    order = sorted(assignments)
    stacked = gather_shards(mesh, [assignments[p][None] for p in order], dim=0)
    full = stacked.reshape(r_shards, m_shards, m_loc, n_loc).permute(1, 2, 0, 3)
    full = full.reshape(m, r_shards * n_loc)[:, :n]
    if squeeze:
        return KMeansResult(centroids[0], full[0], it, done[0])
    return KMeansResult(centroids, full, it, done)
