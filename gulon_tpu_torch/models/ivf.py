"""IVF-style coarse-partitioned residual PQ index (counterpart of
``gulon_tpu/models/ivf.py``, reference ``GroupedIndex``,
``Index.scala:231-308``).

Rows are grouped by nearest coarse centroid, PQ encodes the residuals,
and a query probes the partitions its strategy picks:

- ``LimitGroups(count)``: the ``count`` nearest centroids
  (``Index.scala:287-288``);
- ``LimitVectors(count)``: centroids in ascending distance while the
  cumulative candidate count is below ``count`` (``Index.scala:289-298``).

The residual distance is expanded as in the JAX package,

    ||(q - c_g) - r^||^2 = ||q||^2 + (||c_g||^2 - 2<q, c_g>)
                         + (||r^||^2 + 2<c_g, r^>) - 2<q, r^>,

so the partition structure contributes a per-(query, group) term, a
per-row constant (``row_const``, built once) and a probe mask. Scan
strategies (``scan_strategy``):

- ``"masked"``: one masked full scan over every row;
- ``"pallas"``: the fused scan kernel K1 (``csrc/adc_scan.cu``) over a
  partition-padded row layout, uncentered, ``pallas_winners`` winners per
  128-row block (optionally ``pallas_rescore``), on CPU tensors K1's
  plain twin; outside the kernel's envelope the masked scan serves;
- ``"gathered"``: per-query slices of the probed partitions, the
  small-batch sublinear path;
- ``"bucketed"``: a host-planned (row chunk x query sub-bucket) entry
  schedule over the probed partitions, the larger-batch sublinear path;
- ``"auto"`` (default): by probed-work estimates, sublinear for small
  batches, then ``pallas`` when the codes live on a CUDA device (the JAX
  package's "on a TPU") and ``masked`` elsewhere.

Both sublinear paths decode probed codes in flight, or scan the
reconstruction cache of :meth:`IVFIndex.enable_cache` when one is built.
An OPQ ``rotation`` is a global basis change: centroids and codebooks are
stored rotated, queries rotate at full f32, :meth:`IVFIndex.lookup`
rotates back. :meth:`IVFIndex.add` and :meth:`IVFIndex.remove` return a
new index whose lazy operands are all cleared.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from gulon_tpu_torch.models import update as up
from gulon_tpu_torch.models.index import Index, Result
from gulon_tpu_torch.models.keyindex import GroupedKeyIndex
from gulon_tpu_torch.models.metric import Metric
from gulon_tpu_torch.ops import scan as scan_ops
from gulon_tpu_torch.ops.cuda.adc import K1Operands, pack_codes_t
from gulon_tpu_torch.ops.cuda.ivf_topk import ivf_select
from gulon_tpu_torch.ops.distance import nearest, normalize_rows, sq_norms
from gulon_tpu_torch.ops.pq import ProductQuantizer
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.ops.topk import approx_smallest_k, smallest_k
from gulon_tpu_torch.utils import tracing

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class LimitGroups:
    """Probe the ``count`` nearest partitions (proto Strategy LIMIT_GROUPS=0)."""

    count: int
    proto_value = 0


@dataclasses.dataclass(frozen=True)
class LimitVectors:
    """Probe nearest partitions until >= ``count`` candidate vectors
    (proto Strategy LIMIT_VECTORS=2)."""

    count: int
    proto_value = 2


Strategy = Union[LimitGroups, LimitVectors]


def _probe_mask_limit_groups(cdist: torch.Tensor, count: int) -> torch.Tensor:
    """[Q, P] bool: True for the ``count`` nearest centroids per query
    (equal distances keep the lower centroid)."""
    count = min(count, cdist.shape[1])
    _, idx = smallest_k(cdist, count)
    mask = torch.zeros(cdist.shape, dtype=torch.bool, device=cdist.device)
    return mask.scatter(1, idx.long(), True)


def _probe_mask_limit_vectors(
    cdist: torch.Tensor, sizes: torch.Tensor, count: int
) -> torch.Tensor:
    """Probe in ascending-distance order while the cumulative size is below
    ``count``; the partition that crosses it is included
    (``Index.scala:289-298``). The order is a stable argsort, as
    ``jnp.argsort``'s."""
    order = torch.argsort(cdist, dim=1, stable=True)
    sz = sizes[order].to(torch.int64)
    include = torch.cumsum(sz, dim=1) - sz < count
    mask = torch.zeros(cdist.shape, dtype=torch.bool, device=cdist.device)
    return mask.scatter(1, order, include)


def _probe_kind(strategy: Strategy) -> str:
    """The ``kind`` of :func:`_rank_and_probe` a probe strategy asks for."""
    if isinstance(strategy, LimitGroups):
        return "groups"
    if isinstance(strategy, LimitVectors):
        return "vectors"
    raise ValueError(f"unknown strategy {strategy!r}")


def _rank_and_probe(q, centroids, sizes, *, kind: str, count: int):
    """Centroid ranking at full f32 (``exactNearestNeighbours`` over the
    centroids, ``Index.scala:285-299``) and the probe mask:
    ``(group_term [Q, P], qn [Q], cdist [Q, P], mask [Q, P])``."""
    with tracing.span("gulon.ivf.probe"):
        cn = sq_norms(centroids)
        group_term = cn[None, :] - 2.0 * matmul(q, centroids.T, "highest")
        qn = sq_norms(q)
        cdist = group_term + qn[:, None]
        if kind == "groups":
            pm = _probe_mask_limit_groups(cdist, count)
        else:
            pm = _probe_mask_limit_vectors(cdist, sizes, count)
        return group_term, qn, cdist, pm


def _ivf_scan(
    queries: torch.Tensor,  # [Q, D]
    codebooks: torch.Tensor,  # [m, K, dsub]
    codes: torch.Tensor,  # [N, m]
    row_const: torch.Tensor,  # [N] = ||r^||^2 + 2<c_g, r^>
    group_ids: torch.Tensor,  # [N] int32
    group_term: torch.Tensor,  # [Q, P] = ||c_g||^2 - 2<q, c_g>
    probe_mask: torch.Tensor,  # [Q, P] bool
    *,
    bounds,
    k: int,
    tile_rows: int,
    precision: str = "default",
    topk_impl: str = "approx",
):
    """The masked full scan: every row tile is decoded and scored, rows of
    unprobed partitions read +inf."""
    num_q = queries.shape[0]
    n = codes.shape[0]
    tile_rows = min(tile_rows, max(n, 1))
    q_pad = scan_ops._q_pad(queries, bounds, codebooks.shape[2])
    qn = sq_norms(queries)
    gids = group_ids.long()

    def dist_tile(start, stop):
        dec = scan_ops.decode_tile(codebooks, codes[start:stop])
        ip = matmul(q_pad, dec.T, precision)
        gid = gids[start:stop]
        d = qn[:, None] + row_const[None, start:stop] + group_term[:, gid] - 2.0 * ip
        return torch.where(probe_mask[:, gid], d, _INF)

    return scan_ops._streaming_topk(
        dist_tile, n, tile_rows, num_q, k, queries.device, topk_impl=topk_impl
    )


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _plan_entry_schedule(
    probe_np: np.ndarray,  # [Q, L] i32, -1 = unused slot
    sizes: np.ndarray,  # [P] partition sizes
    starts: np.ndarray,  # [P] partition start rows
    rcap: int,  # rows per entry
    qcap: int,  # queries per entry
    kk: int,
):
    """Host-side planner of the exact partition-centric ("bucketed") scan,
    the JAX package's numpy planner (``gulon_tpu/models/ivf.py:166``)
    carried over unchanged.

    The (query, probe) pairs are inverted into fixed-shape entries: every
    probed partition splits into ``ceil(size/rcap)`` row chunks x
    ``ceil(occupancy/qcap)`` query sub-buckets, one entry per cell, so hot
    partitions get more entries instead of dropped pairs (probes are never
    lossy, ``Index.scala:273-281``). Returns ``e_start/e_size/e_part
    [E]``, ``e_bucket [E, qcap]`` (query ids, -1 pad) and ``pair_slots
    [Q, L*max_nr]``, flat indices into the ``[E*qcap]`` candidate table
    (``E*qcap`` = unused).
    """
    num_q, L = probe_np.shape
    qs = np.repeat(np.arange(num_q, dtype=np.int32), L)
    ps = probe_np.reshape(-1)
    valid = ps >= 0
    orig_pos = np.nonzero(valid)[0]
    qs, ps = qs[valid], ps[valid]
    order = np.argsort(ps, kind="stable")
    ps_s, qs_s = ps[order], qs[order]
    orig_pos = orig_pos[order]

    used, used_start = np.unique(ps_s, return_index=True)
    occ = np.diff(np.append(used_start, len(ps_s)))
    nq = -(-occ // qcap)
    nr = np.maximum(-(-sizes[used] // rcap), 1)
    max_nr = int(nr.max()) if len(nr) else 1

    # rank of each pair within its partition -> (query chunk, slot)
    first = np.searchsorted(ps_s, ps_s, side="left")
    rank = (np.arange(len(ps_s)) - first).astype(np.int64)
    uidx = np.searchsorted(used, ps_s)
    j_q = rank // qcap
    slot = (rank % qcap).astype(np.int64)

    # entries: per used partition, an nr x nq grid (row-chunk major)
    reps = nr * nq
    num_e = int(reps.sum())
    if num_e == 0:
        # no (query, probe) pairs at all: an all-padding schedule
        e_pad = 8
        return (
            np.zeros(e_pad, np.int32),
            np.zeros(e_pad, np.int32),
            np.zeros(e_pad, np.int32),
            np.full((e_pad, qcap), -1, np.int32),
            np.full((num_q, L), e_pad * qcap, np.int32),
        )
    cum = np.concatenate([[0], np.cumsum(reps)[:-1]])
    e_upart = np.repeat(np.arange(len(used)), reps)
    within = np.arange(num_e) - np.repeat(cum, reps)
    i_row = within // nq[e_upart]
    j_ent = within % nq[e_upart]
    e_start = (starts[used][e_upart] + i_row * rcap).astype(np.int32)
    e_size = np.minimum(
        rcap, sizes[used][e_upart] - i_row * rcap
    ).astype(np.int32)
    e_part = used[e_upart].astype(np.int32)

    # bucket contents per (used partition, query chunk)
    bucket_base = np.cumsum(np.append(0, nq))[:-1]
    bucket_of_entry = (bucket_base[e_upart] + j_ent).astype(np.int64)
    num_b = int(nq.sum())
    buckets = np.full((num_b, qcap), -1, np.int32)
    brow = bucket_base[uidx] + j_q
    buckets[brow, slot] = qs_s

    # pad E to a power of two; padded entries are size-0 and point at an
    # all-empty bucket row
    e_pad = max(_next_pow2(num_e), 8)
    if e_pad > num_e:
        pad = e_pad - num_e
        e_start = np.concatenate([e_start, np.zeros(pad, np.int32)])
        e_size = np.concatenate([e_size, np.zeros(pad, np.int32)])
        e_part = np.concatenate([e_part, np.zeros(pad, np.int32)])
        bucket_of_entry = np.concatenate(
            [bucket_of_entry, np.full(pad, num_b, np.int64)]
        )
    buckets = np.concatenate(
        [buckets, np.full((1, qcap), -1, np.int32)], axis=0
    )
    e_bucket = buckets[bucket_of_entry]  # [E_pad, qcap]

    # per-pair candidate slots: pair (q, p) owns slot `slot` of every
    # row-chunk entry (i, j_q) of p
    max_nr_pad = _next_pow2(max_nr)
    eids = (
        cum[uidx][:, None]
        + np.arange(max_nr_pad)[None, :] * nq[uidx][:, None]
        + j_q[:, None]
    )
    pair_ok = np.arange(max_nr_pad)[None, :] < nr[uidx][:, None]
    flat = np.where(pair_ok, eids * qcap + slot[:, None], e_pad * qcap)
    pair_slots = np.full(
        (num_q, L, max_nr_pad), e_pad * qcap, np.int64
    )
    pair_slots[qs_s, orig_pos % L] = flat
    return (
        e_start,
        e_size,
        e_part,
        e_bucket,
        pair_slots.reshape(num_q, L * max_nr_pad).astype(np.int32),
    )


# Below this many bytes of entry distances the bucketed scan stacks them
# into one [E*qcap, rcap] tensor and selects once; above it, it selects
# per chunk of entries (``gulon_tpu/models/ivf.py:293``).
_FLAT_TOPK_BYTES = 1 << 30
# working-set budget of one chunk of entries (decoded rows + scores)
_ENTRY_CHUNK_BYTES = 1 << 27


def _entry_chunk(e_total: int, rcap: int, qcap: int, width: int) -> int:
    """Entries scored per step: a power of two (so it divides the padded
    entry count) whose working set stays within ``_ENTRY_CHUNK_BYTES``.
    The chunking changes no result."""
    per_entry = 4 * rcap * (width + qcap)
    chunk = 8
    while chunk < e_total and 2 * chunk * per_entry <= _ENTRY_CHUNK_BYTES:
        chunk *= 2
    return min(chunk, e_total)


def _entry_topk(
    dist_chunk_fn,  # chunk of schedule rows -> [chunk, qcap, rcap]
    schedule,  # tuple of [E, ...] tensors fed to dist_chunk_fn
    e_start: torch.Tensor,  # [E] int32 (for global row ids)
    *,
    rcap: int,
    qcap: int,
    kk: int,
    chunk: int,
    topk_impl: str,
):
    """Score the entries chunk by chunk, then select ``kk`` per entry slot:
    ``([E, qcap, kk] dists, [E, qcap, kk] global row ids)``; the selection
    is ``lax.approx_min_k``'s (``approx_smallest_k``) where the JAX package
    takes it (``topk_impl="approx"``, ``rcap >= 128``)."""
    select = approx_smallest_k if topk_impl == "approx" and rcap >= 128 else smallest_k
    e_total = e_start.shape[0]
    chunks = [
        tuple(a[s : s + chunk] for a in schedule)
        for s in range(0, e_total, chunk)
    ]
    if e_total * qcap * rcap * 4 <= _FLAT_TOPK_BYTES:
        dist_all = torch.cat([dist_chunk_fn(*c) for c in chunks])
        kv, kp = select(dist_all.reshape(e_total * qcap, rcap), kk)
        ki = e_start[:, None, None] + kp.reshape(e_total, qcap, kk)
        return kv.reshape(e_total, qcap, kk), ki
    all_v, all_p = [], []
    for c in chunks:
        dist = dist_chunk_fn(*c)
        kv, kp = select(dist.reshape(-1, rcap), kk)
        all_v.append(kv.reshape(-1, qcap, kk))
        all_p.append(kp.reshape(-1, qcap, kk))
    return torch.cat(all_v), e_start[:, None, None] + torch.cat(all_p)


def _scan_entries_codes(
    q_pad: torch.Tensor,  # [Q, m*dsub] f32 (subspace layout)
    qn: torch.Tensor,  # [Q] f32
    group_term: torch.Tensor,  # [Q, P] f32
    codebooks: torch.Tensor,  # [m, K, dsub]
    codes_pad: torch.Tensor,  # [N + pad, m]
    row_const_pad: torch.Tensor,  # [N + pad] f32 (+inf padding)
    e_start: torch.Tensor,  # [E] int32
    e_size: torch.Tensor,  # [E] int32
    e_part: torch.Tensor,  # [E] int32
    e_bucket: torch.Tensor,  # [E, qcap] int32 query ids (-1 pad)
    *,
    rcap: int,
    qcap: int,
    kk: int,
    precision: str = "default",
    topk_impl: str = "approx",
):
    """Code-resident entry scan: each probed row chunk is decoded in flight
    (``m`` bytes a vector, the reference's ranged code scan,
    ``Index.scala:411-412``). Returns per-entry-slot candidates."""
    num_q = q_pad.shape[0]
    dev = q_pad.device
    q_safe = torch.cat([q_pad, q_pad.new_zeros((1, q_pad.shape[1]))])
    qn_safe = torch.cat([qn, qn.new_zeros((1,))])
    gt_safe = torch.cat([group_term, group_term.new_zeros((1, group_term.shape[1]))])
    col_iota = torch.arange(rcap, device=dev)

    def dist_chunk(st, sz, part, bucket):
        rows = st.long()[:, None] + col_iota  # [C, rcap]
        c = rows.shape[0]
        dec = scan_ops.decode_tile(codebooks, codes_pad[rows.reshape(-1)])
        dec = dec.reshape(c, rcap, -1)
        rc = row_const_pad[rows]  # [C, rcap]
        qidx = torch.where(bucket >= 0, bucket, num_q).long()  # [C, qcap]
        ip = matmul(q_safe[qidx], dec.transpose(1, 2), precision)  # [C, qcap, rcap]
        gt = gt_safe[qidx, part.long()[:, None]]  # [C, qcap]
        dist = (
            qn_safe[qidx][:, :, None] + gt[:, :, None] + rc[:, None, :]
            - 2.0 * ip
        )
        ok = (bucket >= 0)[:, :, None] & (col_iota < sz[:, None])[:, None, :]
        return torch.where(ok, dist, _INF)

    return _entry_topk(
        dist_chunk, (e_start, e_size, e_part, e_bucket), e_start,
        rcap=rcap, qcap=qcap, kk=kk,
        chunk=_entry_chunk(e_start.shape[0], rcap, qcap, q_pad.shape[1]),
        topk_impl=topk_impl,
    )


def _scan_entries_cached(
    queries: torch.Tensor,  # [Q, D] f32 (already normalized)
    recon_pad: torch.Tensor,  # [N + pad, D] bf16/f32 reconstruction
    recon_norms_pad: torch.Tensor,  # [N + pad] f32 (+inf padding)
    e_start: torch.Tensor,
    e_size: torch.Tensor,
    e_bucket: torch.Tensor,
    *,
    rcap: int,
    qcap: int,
    kk: int,
    topk_impl: str = "approx",
):
    """Entry scan over the reconstruction cache (matmuls only; the queries
    are rounded to the cache's dtype, products summed in f32)."""
    num_q, d = queries.shape
    dev = queries.device
    qn = sq_norms(queries)
    qc = queries.to(recon_pad.dtype).to(torch.float32)
    q_safe = torch.cat([qc, qc.new_zeros((1, d))])
    qn_safe = torch.cat([qn, qn.new_zeros((1,))])
    col_iota = torch.arange(rcap, device=dev)

    def dist_chunk(st, sz, bucket):
        rows = st.long()[:, None] + col_iota  # [C, rcap]
        block = recon_pad[rows].to(torch.float32)  # [C, rcap, D]
        bn = recon_norms_pad[rows]
        qidx = torch.where(bucket >= 0, bucket, num_q).long()
        ip = matmul(q_safe[qidx], block.transpose(1, 2), "highest")
        dist = qn_safe[qidx][:, :, None] + bn[:, None, :] - 2.0 * ip
        ok = (bucket >= 0)[:, :, None] & (col_iota < sz[:, None])[:, None, :]
        return torch.where(ok, dist, _INF)

    return _entry_topk(
        dist_chunk, (e_start, e_size, e_bucket), e_start,
        rcap=rcap, qcap=qcap, kk=kk,
        chunk=_entry_chunk(e_start.shape[0], rcap, qcap, d), topk_impl=topk_impl,
    )


def _regroup_pairs(
    cand_v: torch.Tensor,  # [E, qcap, kk]
    cand_i: torch.Tensor,  # [E, qcap, kk]
    pair_slots: torch.Tensor,  # [Q, W] flat (entry*qcap + slot); E*qcap = pad
    *,
    k: int,
):
    """Gather every pair's entry winners and take the per-query top-k."""
    e_total, qcap, kk = cand_v.shape
    num_q, w = pair_slots.shape
    cv = torch.cat([cand_v.reshape(e_total * qcap, kk), cand_v.new_full((1, kk), _INF)])
    ci = torch.cat([
        cand_i.reshape(e_total * qcap, kk).to(torch.int32),
        torch.full((1, kk), -1, dtype=torch.int32, device=cand_i.device),
    ])
    safe = torch.clamp(pair_slots.long(), max=e_total * qcap)
    per_q_v = cv[safe].reshape(num_q, w * kk)
    per_q_i = ci[safe].reshape(num_q, w * kk)
    kf = min(k, w * kk)
    best_d, pos = smallest_k(per_q_v, kf)
    best_i = torch.gather(per_q_i, 1, pos.long())
    if kf < k:
        best_d = torch.nn.functional.pad(best_d, (0, k - kf), value=_INF)
        best_i = torch.nn.functional.pad(best_i, (0, k - kf), value=-1)
    return best_d, torch.where(torch.isinf(best_d), -1, best_i)


def _ivf_scan_gathered(
    q_op: torch.Tensor,  # cached: [Q, D] queries; codes: [Q, m*dsub]
    qn: torch.Tensor,  # [Q] f32
    group_term,  # codes: [Q, P] f32; cached: None (folded into aux)
    codebooks,  # codes: [m, K, dsub]; cached: None
    data_pad: torch.Tensor,  # cached: [N + pad, D] recon; codes: [N + pad, m]
    aux_pad: torch.Tensor,  # cached: recon norms; codes: row_const (+inf pad)
    starts: torch.Tensor,  # [P] partition start rows
    sizes: torch.Tensor,  # [P] partition sizes
    probe_ids: torch.Tensor,  # [Q, L] partitions to probe; -1 = unused
    *,
    mode: str,  # "cached" | "codes"
    pmax: int,
    k: int,
    precision: str = "default",
    topk_impl: str = "approx",
):
    """Sublinear probed scan: per query, its L partitions as contiguous
    ``pmax``-row slices, ``O(L * pmax)`` rows a query whatever the corpus
    size. ``mode="codes"`` decodes the probed codes in flight;
    ``mode="cached"`` reads the reconstruction cache."""
    num_q, num_probe = probe_ids.shape
    row_iota = torch.arange(pmax, device=q_op.device)
    active = probe_ids >= 0  # LimitVectors probe sets vary per query
    p_safe = torch.clamp(probe_ids.long(), min=0)
    s = starts.long()[p_safe]  # [Q, L]
    rows = s[:, :, None] + row_iota  # [Q, L, pmax]
    valid = active[:, :, None] & (row_iota < sizes.long()[p_safe][:, :, None])
    aux = aux_pad[rows]  # [Q, L, pmax]
    if mode == "cached":
        blocks = data_pad[rows.reshape(-1)].to(torch.float32)
        blocks = blocks.reshape(num_q, num_probe * pmax, -1)
        qc = q_op.to(data_pad.dtype).to(torch.float32)
        ip = matmul(blocks, qc[:, :, None], "highest")[..., 0]
        bns = torch.where(valid, aux, _INF).reshape(num_q, -1)
        dist = qn[:, None] + bns - 2.0 * ip
    else:
        dec = scan_ops.decode_tile(codebooks, data_pad[rows.reshape(-1)])
        dec = dec.reshape(num_q, num_probe * pmax, -1)
        ip = matmul(dec, q_op[:, :, None], precision)[..., 0]
        gt = torch.gather(group_term, 1, p_safe)  # [Q, L]
        rcs = torch.where(valid, aux + gt[:, :, None], _INF).reshape(num_q, -1)
        dist = qn[:, None] + rcs - 2.0 * ip
    # lax.approx_min_k where the JAX package takes it
    select = (approx_smallest_k if topk_impl == "approx" and num_probe * pmax >= 256 * k
              else smallest_k)
    dists, pos = select(dist, k)
    ids = torch.gather(rows.reshape(num_q, -1), 1, pos.long()).to(torch.int32)
    return dists, torch.where(torch.isinf(dists), -1, ids)


_PALLAS_BLOCK = 128
_PALLAS_PAD_SENTINEL = 2.0e38  # > _INVALID_MIN: padding rows never win


@dataclasses.dataclass(frozen=True)
class PartitionBlocks:
    """Where each partition's rows sit in a partition-padded layout (one
    device's, or one shard's), as the IVF selection reads them
    (``ops/cuda/ivf_topk.py``): ``blk_part [NBP]`` int64, the partition of
    each 128-row block (0 on the padding blocks past the partitions);
    ``ranges [P, 2]`` int32, the blocks ``[b0, b1)`` of each of the index's
    ``P`` partitions (empty where it has no rows here), which fill blocks
    ``[0, real_blocks)``; ``largest_blocks[c]`` (host), the blocks of the
    ``c + 1`` largest partitions here, for :meth:`column_bound`."""

    blk_part: torch.Tensor
    ranges: torch.Tensor
    real_blocks: int
    largest_blocks: np.ndarray

    def column_bound(self, probe, winners: int, num_cols: int) -> int:
        """The most winner columns one query's probe can hold among K1's
        ``num_cols``, ``winners`` a block, from the probe ``(kind, count)``
        of :func:`_probe_kind` alone: under ``"groups"`` the blocks of the
        ``count`` largest partitions and the padding blocks the columns
        cover; under ``"vectors"``, whose probe can reach every partition,
        all of them."""
        kind, count = probe
        if kind != "groups":
            return num_cols
        blocks = int(self.largest_blocks[min(count, len(self.largest_blocks)) - 1]) if (
            count > 0 and len(self.largest_blocks)) else 0
        return min(num_cols, winners * (blocks + num_cols // winners - self.real_blocks))


def partition_layout(codes, row_const, sizes, parts, k_codes: int, npad: int = 0, *,
                     num_parts: int):
    """The partition-padded row layout of the fused-kernel scan over rows
    grouped by partition: ``codes [n, m]`` and ``row_const [n]`` hold
    partition ``parts[i]``'s ``sizes[i]`` rows after those of ``parts[:i]``
    from row 0 on (rows past them are not read); ``num_parts`` is the
    index's partition count. Each partition starts on a 128-row block, so
    each selection block belongs to one partition. Returns, on the rows'
    device, ``(codes_t [m, Np]`` (:func:`pack_codes_t`, code 0 on padding
    rows), ``row_const [Np]`` f32 (padding rows carry
    ``_PALLAS_PAD_SENTINEL``, above the kernel's invalid threshold, and
    never win a block min), :class:`PartitionBlocks` and ``row_map [Np]``
    int32 (padded row -> row, -1 on padding)``; ``Np`` is ``npad`` if
    larger than the padded partitions."""
    dev = codes.device
    sizes = np.asarray(sizes, np.int64)
    psz = -(-sizes // _PALLAS_BLOCK) * _PALLAS_BLOCK
    n, fill = int(sizes.sum()), int(psz.sum())
    npad = max(npad, fill)
    nblocks = psz // _PALLAS_BLOCK
    ranges = np.zeros((num_parts, 2), np.int32)
    ranges[np.asarray(parts, np.int64)] = np.stack(
        [np.cumsum(nblocks) - nblocks, np.cumsum(nblocks)], axis=1)
    with tracing.span("gulon.wait.upload_layout"):
        shift, sizes_t, blocks, parts_t, ranges_t = (
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in ((np.cumsum(psz) - psz) - (np.cumsum(sizes) - sizes), sizes,
                      nblocks, np.asarray(parts, np.int64), ranges)
        )
    dst = torch.repeat_interleave(shift, sizes_t, output_size=n) + torch.arange(n, device=dev)
    rc_pal = torch.full((npad,), _PALLAS_PAD_SENTINEL, device=dev)
    rc_pal[dst] = row_const[:n].to(torch.float32)
    row_map = torch.full((npad,), -1, dtype=torch.int32, device=dev)
    row_map[dst] = torch.arange(n, dtype=torch.int32, device=dev)
    codes_pal = codes.new_zeros((npad, codes.shape[1]))
    codes_pal[dst] = codes[:n]
    blk_part = torch.zeros(npad // _PALLAS_BLOCK, dtype=torch.int64, device=dev)
    blk_part[: fill // _PALLAS_BLOCK] = torch.repeat_interleave(
        parts_t, blocks, output_size=fill // _PALLAS_BLOCK
    )
    layout = PartitionBlocks(blk_part, ranges_t, fill // _PALLAS_BLOCK,
                             np.cumsum(np.sort(ranges[:, 1] - ranges[:, 0])[::-1]))
    return pack_codes_t(codes_pal, k_codes), rc_pal, layout, row_map


def _pallas_ivf_query(
    q: torch.Tensor,  # [Q, D] f32 (already metric-normalized)
    qn: torch.Tensor,  # [Q] f32 ||q||^2
    group_term: torch.Tensor,  # [Q, P] f32
    probe_mask: torch.Tensor,  # [Q, P] bool
    k1: K1Operands,  # over the partition-padded layout (row constants as norms)
    blocks: PartitionBlocks,  # the layout's partitions
    row_map: torch.Tensor,  # [Npad] int32 padded row -> original row (-1 pad)
    *,
    k: int,
    winners: int,
    probe,  # (kind, count) of the probe behind probe_mask (_probe_kind)
    rescore: int = 0,
):
    """Kernel K1 plus the epilogue of the IVF ``pallas`` strategy
    (``gulon_tpu/models/ivf.py:652-733``).

    K1 emits ``winners`` (value, row) candidates per 128-row block of the
    partition-padded layout. Each winner column belongs to one block and
    so to one partition, so the block-constant group term and probe mask
    apply after the in-kernel min. The selection
    (``ops/cuda/ivf_topk.py::ivf_select``) reads only the columns of each
    query's probed partitions and returns the ``fetch`` smallest, as a
    stable sort over every column with the unprobed ones at +inf ranks
    them. ``rescore > 0`` over-fetches ``rescore * k`` candidates and
    re-ranks them with exact f32 ADC distances (:func:`ivf_block_rescore`).
    ``ivf.select_keys`` counts the columns the selection may read: the
    batch's queries times :meth:`PartitionBlocks.column_bound`.
    """
    npad = row_map.shape[0]
    packed, base_cols = k1.scan(q, winners=winners)
    t, _ = k1.geometry(q.shape[0], winners=winners)
    with tracing.span("gulon.scan.select"):
        nw = packed.shape[1]
        kk = min(k, nw)
        fetch = min(rescore * kk, nw) if rescore else kk
        tracing.count("ivf.selects")
        tracing.count("ivf.select_keys", q.shape[0] * blocks.column_bound(probe, winners, nw))
        best, cols = ivf_select(
            packed, group_term, qn, probe_mask, blocks.ranges, blocks.blk_part,
            blocks.real_blocks, winners=winners, nblk=t // _PALLAS_BLOCK, fetch=fetch,
        )
        safe = torch.clamp(cols, min=0).long()
        win_rows = base_cols[safe] + (torch.gather(packed.view(torch.int32), 1, safe) & 127)
        if rescore:
            col_part = blocks.blk_part[torch.clamp(base_cols[safe].long() // _PALLAS_BLOCK,
                                                   max=blocks.blk_part.shape[0] - 1)]
            best, win_rows = scan_ops.ivf_block_rescore(
                q, qn, k1.codebooks, k1.codes_t, k1.norms, best, win_rows,
                torch.gather(group_term, 1, col_part), bounds=k1.bounds, k=kk,
            )
        # rows of the padded tail past npad only ever carry +inf winners
        ids = row_map[torch.clamp(win_rows.long(), max=npad - 1)]
        ids = torch.where(torch.isinf(best), -1, ids)
        if kk < k:
            best = torch.nn.functional.pad(best, (0, k - kk), value=_INF)
            ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
        return best, ids


@dataclasses.dataclass
class IVFIndex(Index):
    _key_index: GroupedKeyIndex
    pq: ProductQuantizer  # trained on residuals
    codes: torch.Tensor  # [N, m] codes (grouped row order), on the device
    row_const: torch.Tensor  # [N] f32 = ||r^||^2 + 2<c_g, r^>
    group_ids: torch.Tensor  # [N] int32, partition of each row
    centroids: torch.Tensor  # [P, D] f32 coarse centroids
    metric: Metric
    strategy: Strategy
    tile_rows: int = scan_ops.DEFAULT_TILE_ROWS
    # "default" = TF32 allowed on CUDA, "highest" = full f32
    precision: str = "default"
    # accepted for parity with the JAX package; the port's top-k is exact
    topk_impl: str = "approx"
    recall_target: float = 0.95
    scan_strategy: str = "auto"  # auto|masked|pallas|gathered|bucketed
    # [D, D] learned OPQ rotation (ops/opq.py), a global basis change:
    # centroids and codebooks are stored rotated; None = plain PQ
    rotation: Optional[torch.Tensor] = None
    recon_cache: Optional[torch.Tensor] = None  # [N + pad, D], enable_cache
    recon_norms_cache: Optional[torch.Tensor] = None  # [N + pad] f32
    _codes_pad: Optional[torch.Tensor] = None  # [N + pad, m], built lazily
    _row_const_pad: Optional[torch.Tensor] = None  # [N + pad] f32
    # lazily built partition-padded layout of the pallas strategy:
    # (row_const [Np], PartitionBlocks, row_map [Np]); its code operand
    # lives in _k1_operands
    _pallas_layout: Optional[tuple] = None
    # K1's operands over the layout (ops/cuda/adc.py::K1Operands), built
    # with it
    _k1_operands: Optional[K1Operands] = None
    _sizes_dev: Optional[torch.Tensor] = None  # partition_sizes() on device
    # ranked candidates the fused kernel keeps per 128-row block (1..4):
    # losing a true top-k member needs pallas_winners + 1 of them in one
    # block
    pallas_winners: int = 4
    # > 0: over-fetch pallas_rescore * k block winners and re-rank them
    # with exact f32 ADC distances
    pallas_rescore: int = 0

    # the fields above that are built from the rows, on first use or by
    # enable_cache
    _LAZY_OPERANDS = (
        "recon_cache", "recon_norms_cache", "_codes_pad", "_row_const_pad",
        "_pallas_layout", "_k1_operands", "_sizes_dev",
    )

    @property
    def key_index(self) -> GroupedKeyIndex:
        return self._key_index

    @property
    def dimension(self) -> int:
        return self.pq.dimension

    @property
    def size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def num_partitions(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def partition_sizes(self) -> np.ndarray:
        offsets = self._key_index.group_offsets
        bounds = np.concatenate([[0], offsets, [self.size]])
        return np.diff(bounds).astype(np.int32)

    def batch_query(self, k: int, vectors) -> List[Result]:
        dists, ids = self.query_arrays(k, vectors)
        return self._make_results(dists.cpu().numpy(), ids.cpu().numpy())

    def _pad_rows(self) -> int:
        """Row padding so any rcap/pmax slice stays in bounds."""
        sizes = self.partition_sizes()
        pmax = int(sizes.max()) if len(sizes) else 1
        return max(pmax, 512)

    def _code_operands(self):
        """Padded code matrix + row constants for code-resident probing."""
        if self._codes_pad is None:
            pad = self._pad_rows()
            self._codes_pad = torch.cat(
                [self.codes, self.codes.new_zeros((pad, self.codes.shape[1]))]
            )
            self._row_const_pad = torch.cat(
                [self.row_const, self.row_const.new_full((pad,), _INF)]
            )
        return self._codes_pad, self._row_const_pad

    def _q_subspace(self, q: torch.Tensor) -> torch.Tensor:
        return scan_ops._q_pad(q, self.pq.bounds, self.pq.pad_width)

    def _pallas_operands(self):
        """Partition-padded layout of the fused-kernel scan, built once on
        the index's device (:func:`partition_layout`): ``(row_const [Np],
        PartitionBlocks, row_map [Np])``; K1's operands over it, its
        code operand with them, are held in ``_k1_operands``."""
        if self._pallas_layout is None or self._k1_operands is None:
            with tracing.span("gulon.scan.operands"):
                codes_t, rc_pal, blocks, row_map = partition_layout(
                    self.codes, self.row_const, self.partition_sizes(),
                    np.arange(self.num_partitions), self.pq.num_clusters,
                    num_parts=self.num_partitions,
                )
                self._k1_operands = K1Operands(
                    self.pq.codebooks, codes_t, rc_pal, bounds=self.pq.bounds,
                    num_rows=codes_t.shape[1],
                )
            self._pallas_layout = (rc_pal, blocks, row_map)
        return self._pallas_layout

    def _k1(self) -> K1Operands:
        """K1's operands over the partition-padded layout, uncentered."""
        self._pallas_operands()
        return self._k1_operands

    def _pallas_eligible(self, k_eff: int) -> bool:
        return (
            k_eff <= 128
            and self.pq.num_clusters <= 1024
            and self.size >= 1024
        )

    def _resolve_auto(self, num_q: int, k_eff: int) -> str:
        """A scan strategy from batch size vs probed-work estimates, the
        policy of ``gulon_tpu/models/ivf.py:900-948`` with "on a TPU" read
        as "codes on a CUDA device": ``gathered`` for small batches whose
        padded probe slices stay under half the corpus, ``bucketed`` while
        the probed rows do, then ``pallas`` (K1) on a CUDA device inside
        the kernel's envelope and ``masked`` elsewhere."""
        sizes = self.partition_sizes()
        if len(sizes) == 0 or self.size == 0:
            return "masked"
        pmax = int(sizes.max())
        mean_size = self.size / len(sizes)
        if isinstance(self.strategy, LimitGroups):
            probes = min(self.strategy.count, self.num_partitions)
            bucketed_rows = num_q * probes * mean_size
        else:
            # LimitVectors probes until the cumulative size >= count; the
            # probe count is data-dependent, estimated from the
            # 25th-percentile partition size
            nz = sizes[sizes > 0]
            p25 = max(int(np.percentile(nz, 25)), 1) if len(nz) else 1
            probes = min(
                self.num_partitions,
                max(1, -(-self.strategy.count // p25)),
            )
            bucketed_rows = num_q * min(
                self.strategy.count + pmax, self.size
            )
        gathered_rows = num_q * probes * pmax  # padded slices per query
        if num_q <= 32 and gathered_rows * 2 < self.size:
            return "gathered"
        if bucketed_rows * 2 < self.size:
            return "bucketed"
        if self.device.type == "cuda" and self._pallas_eligible(k_eff):
            return "pallas"
        return "masked"

    def resolve_strategy(self, num_queries: int, k: int) -> str:
        """The scan strategy a ``query_arrays(k, [num_queries, D])`` call
        serves through (``pallas`` outside the kernel's envelope serves
        through the masked scan)."""
        k_eff = min(k, self.size)
        strategy = self.scan_strategy
        if strategy == "auto":
            strategy = self._resolve_auto(num_queries, k_eff)
        if strategy == "pallas" and not self._pallas_eligible(k_eff):
            return "masked"
        return strategy

    def query_arrays(self, k: int, vectors):
        """([Q, k] squared distances, [Q, k] int32 row ids) as tensors on
        the index's device."""
        with tracing.span("gulon.query"):
            return self._query(k, vectors)

    def _query(self, k: int, vectors):
        scan_ops.resolve_precision(self.precision)
        scan_ops._check_topk_impl(self.topk_impl)
        q = self._prepare_queries(vectors)
        kind = _probe_kind(self.strategy)
        if self._sizes_dev is None:
            with tracing.span("gulon.wait.upload_sizes"):
                self._sizes_dev = torch.from_numpy(self.partition_sizes()).to(self.device)
        group_term, qn, cdist, probe_mask = _rank_and_probe(
            q, self.centroids, self._sizes_dev,
            kind=kind, count=self.strategy.count,
        )

        k_eff = min(k, self.size)
        with tracing.span("gulon.query.route"):
            strategy = self.resolve_strategy(int(q.shape[0]), k)
        if strategy == "pallas":
            return self._query_pallas(q, qn, group_term, probe_mask, k_eff)
        if strategy in ("gathered", "bucketed"):
            if q.shape[0] == 0:  # the JAX package's planners divide by Q
                raise ValueError(f"the {strategy} strategy needs at least one query")
            with tracing.span(
                "gulon.scan.gathered" if strategy == "gathered" else "gulon.scan.bucketed"
            ):
                return self._query_sublinear(
                    strategy, q, qn, group_term, cdist, probe_mask, k_eff
                )
        if strategy != "masked":
            raise ValueError(
                f"unknown ivf scan strategy {strategy!r} "
                "(expected auto|masked|pallas|gathered|bucketed)"
            )
        with tracing.span("gulon.scan.masked"):
            return _ivf_scan(
                q, self.pq.codebooks, self.codes, self.row_const, self.group_ids,
                group_term, probe_mask, bounds=self.pq.bounds, k=k_eff,
                tile_rows=self.tile_rows, precision=self.precision,
                topk_impl=self.topk_impl,
            )

    def _query_pallas(self, q, qn, group_term, probe_mask, k_eff: int):
        """The fused-kernel strategy over the partition-padded layout."""
        _, blocks, row_map = self._pallas_operands()
        return _pallas_ivf_query(
            q, qn, group_term, probe_mask, self._k1_operands, blocks, row_map,
            k=k_eff, winners=self.pallas_winners, rescore=self.pallas_rescore,
            probe=(_probe_kind(self.strategy), self.strategy.count),
        )

    def _query_sublinear(self, strategy, q, qn, group_term, cdist, probe_mask, k_eff):
        """The ``gathered`` and ``bucketed`` strategies
        (``gulon_tpu/models/ivf.py:1029-1148``)."""
        dev = self.device
        use_cache = self.recon_cache is not None
        sizes_np = self.partition_sizes()
        pmax = int(sizes_np.max()) if len(sizes_np) else 1
        if isinstance(self.strategy, LimitGroups):
            num_probe = min(self.strategy.count, self.num_partitions)
        else:
            # LimitVectors: the mask's largest probe set, rounded up to a
            # power of two as the JAX package does
            with tracing.span("gulon.wait.probe_count"):
                raw = int(probe_mask.sum(dim=1).max())
            num_probe = min(_next_pow2(raw), self.num_partitions)
        # the num_probe nearest centroids, best first; unused slots -1
        masked_cdist = torch.where(probe_mask, cdist, _INF)
        probe_d, probe_ids = smallest_k(masked_cdist, num_probe)
        probe_ids = torch.where(torch.isinf(probe_d), -1, probe_ids)
        starts = np.concatenate([[0], np.cumsum(sizes_np)[:-1]]).astype(np.int32)
        if strategy == "bucketed":
            with tracing.span("gulon.wait.probe_ids"):
                probe_np = probe_ids.cpu().numpy()
            flat_p = probe_np[probe_np >= 0]
            max_occ = int(np.bincount(flat_p).max()) if flat_p.size else 1
            rcap = min(512, _next_pow2(pmax))
            qcap = min(64, max(8, _next_pow2(max_occ)))
            kk = min(k_eff, rcap)
            e_start, e_size, e_part, e_bucket, pair_slots = _plan_entry_schedule(
                probe_np, sizes_np, starts, rcap, qcap, kk
            )
            with tracing.span("gulon.wait.upload_schedule"):
                e_start, e_size, e_part, e_bucket, pair_slots = (
                    torch.from_numpy(a).to(dev)
                    for a in (e_start, e_size, e_part, e_bucket, pair_slots)
                )
            if use_cache:
                cand_v, cand_i = _scan_entries_cached(
                    q, self.recon_cache, self.recon_norms_cache,
                    e_start, e_size, e_bucket, rcap=rcap, qcap=qcap, kk=kk,
                    topk_impl=self.topk_impl,
                )
            else:
                codes_pad, rc_pad = self._code_operands()
                cand_v, cand_i = _scan_entries_codes(
                    self._q_subspace(q), qn, group_term, self.pq.codebooks,
                    codes_pad, rc_pad, e_start, e_size, e_part, e_bucket,
                    rcap=rcap, qcap=qcap, kk=kk, precision=self.precision,
                    topk_impl=self.topk_impl,
                )
            return _regroup_pairs(cand_v, cand_i, pair_slots, k=k_eff)
        # gathered: the candidate pool holds num_probe * pmax rows a query
        k_g = min(k_eff, num_probe * pmax)
        with tracing.span("gulon.wait.upload_slices"):
            starts_t = torch.from_numpy(starts).to(dev)
            sizes_t = torch.from_numpy(sizes_np).to(dev)
        if use_cache:
            dists, ids = _ivf_scan_gathered(
                q, qn, None, None, self.recon_cache, self.recon_norms_cache,
                starts_t, sizes_t, probe_ids, mode="cached", pmax=pmax, k=k_g,
                topk_impl=self.topk_impl,
            )
        else:
            codes_pad, rc_pad = self._code_operands()
            dists, ids = _ivf_scan_gathered(
                self._q_subspace(q), qn, group_term, self.pq.codebooks,
                codes_pad, rc_pad, starts_t, sizes_t, probe_ids,
                mode="codes", pmax=pmax, k=k_g, precision=self.precision,
                topk_impl=self.topk_impl,
            )
        if k_g < k_eff:  # pad to the requested width (inf / -1 slots)
            dists = torch.nn.functional.pad(dists, (0, k_eff - k_g), value=_INF)
            ids = torch.nn.functional.pad(ids, (0, k_eff - k_g), value=-1)
        return dists, ids

    def enable_cache(self, dtype=None, chunk: int = 1 << 20) -> None:
        """Materialize the full reconstruction (residual decode + centroid)
        for the sublinear strategies: bf16 when the codes live on a CUDA
        device, f32 elsewhere, padded so probe slices never clamp; norms in
        float64, stored f32."""
        dev = self.device
        if dtype is None:
            dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        pad = self._pad_rows()
        d = self.dimension
        cache = torch.zeros((self.size + pad, d), dtype=dtype, device=dev)
        norms = torch.full((self.size + pad,), _INF, device=dev)
        gids = self.group_ids.long()
        for start in range(0, self.size, chunk):
            stop = min(start + chunk, self.size)
            rec = self.pq.decode(self.codes[start:stop]) + self.centroids[gids[start:stop]]
            norms[start:stop] = (rec.double() ** 2).sum(dim=1).to(torch.float32)
            cache[start:stop] = rec.to(dtype)
        self.recon_cache = cache
        self.recon_norms_cache = norms

    def add(self, keys, vectors) -> "IVFIndex":
        """A new index with ``(keys, vectors)`` merged in
        (``gulon_tpu/models/ivf.py:1215-1261``): each new row goes to its
        nearest coarse centroid (after the metric's normalization and the
        rotation), its residual is encoded with the existing codebooks and
        its row constant computed; rows land in their partition's range
        with keys sorted within each group."""
        keys_new, x = up.validate_add(keys, vectors, self.dimension)
        dev = self.device
        xd = torch.from_numpy(x).to(dev)
        if self.metric.normalized:
            xd = normalize_rows(xd)
        if self.rotation is not None:
            xd = matmul(xd, self.rotation, "highest")
        gid_new = nearest(xd, self.centroids)
        codes_new = self.pq.encode(xd - self.centroids[gid_new.long()])
        rc_new = self.pq.reconstruction_norms(codes_new) + 2.0 * self.pq.centroid_code_dot(
            codes_new, self.centroids, gid_new
        )
        merged_keys, gids, offsets, order = up.merge_grouped_order(
            self.group_ids.cpu().numpy(), self._key_index.keys,
            gid_new.cpu().numpy(), keys_new, self.num_partitions,
        )
        order = torch.from_numpy(order).to(dev)
        return self._replace_rows(
            GroupedKeyIndex(merged_keys, offsets),
            torch.cat([self.codes, codes_new])[order],
            torch.cat([self.row_const, rc_new])[order],
            torch.from_numpy(gids).to(dev),
        )

    def remove(self, keys) -> "IVFIndex":
        """A new index without the given keys (all occurrences). A
        partition may become empty; its centroid stays, so group ids stay
        stable. ``KeyError`` for absent keys, ``ValueError`` on emptying."""
        keep = up.removal_mask(self._key_index.keys, keys)
        keep_idx = np.flatnonzero(keep)
        gids = self.group_ids.cpu().numpy()[keep_idx]
        counts = np.bincount(gids, minlength=self.num_partitions)
        offsets = np.cumsum(counts)[:-1].astype(np.int32)
        rows = torch.from_numpy(keep_idx).to(self.device)
        return self._replace_rows(
            GroupedKeyIndex(self._key_index.keys[keep], offsets),
            self.codes[rows],
            self.row_const[rows],
            torch.from_numpy(gids).to(self.device),
        )

    def _replace_rows(
        self,
        key_index: GroupedKeyIndex,
        codes: torch.Tensor,
        row_const: torch.Tensor,
        group_ids: torch.Tensor,
    ) -> "IVFIndex":
        """The index over a new row set with every lazy operand cleared
        (caches, padded operands, the kernel's partition-padded layout,
        the partition sizes): they rebuild on first use."""
        return dataclasses.replace(
            self,
            _key_index=key_index,
            codes=codes,
            row_const=row_const,
            group_ids=group_ids,
            **dict.fromkeys(self._LAZY_OPERANDS),
        )

    def lookup(self, word: str) -> Optional[np.ndarray]:
        """Decode residual + add the partition centroid
        (``Index.scala:247-254``), in the original basis."""
        row = self._key_index.lookup(word)
        if row is None:
            return None
        g = self._key_index.group_of(row)
        rec = self.pq.decode(self.codes[row : row + 1])[0] + self.centroids[g]
        if self.rotation is not None:
            rec = matmul(rec[None], self.rotation.T, "highest")[0]
        return rec.cpu().numpy()
