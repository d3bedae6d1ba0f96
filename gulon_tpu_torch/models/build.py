"""Index builders (counterparts of ``gulon_tpu/models/build.py``), on
``device``, the CUDA card unless the caller names another:

- linear (``BuildIndex.scala:84-93``): sort keys -> train PQ -> chunked
  encode -> reconstruction norms -> ``FlatIndex``;
- sublinear (``BuildIndex.scala:70-82``): coarse k-means over the full
  vectors -> group rows by (cluster, key), dropping empty clusters
  (``WordVectors.scala:24-58``) -> train PQ on the residuals -> encode ->
  row constants -> ``IVFIndex``.

With ``opq_iters > 0`` both learn an OPQ rotation (``ops/opq.py``)
first. ``PQConfig.init`` and ``coarse_init`` pick the k-means seeding
(``"sample"`` or ``"kmeans++"``); ``report_fn`` receives the k-means
progress of every single-device training. With ``mesh``
(``parallel/mesh.py``) the k-means stages train distributed (rows
data-parallel, subspaces over ``"sub"``) and the encode shards rows over
every device of the mesh (``parallel/ops.py``); the index itself lands on
``device``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gulon_tpu_torch.models.keyindex import GroupedKeyIndex, SortedKeyIndex
from gulon_tpu_torch.models.metric import Metric
from gulon_tpu_torch.models.flat import FlatIndex
from gulon_tpu_torch.models.ivf import IVFIndex, LimitGroups, Strategy
from gulon_tpu_torch.ops.kmeans import KMeansConfig, fit_kmeans
from gulon_tpu_torch.ops.opq import train_opq
from gulon_tpu_torch.ops.pq import PQConfig, ProductQuantizer, train_product_quantizer
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.parallel.mesh import check_mesh
from gulon_tpu_torch.utils import tracing
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE
from gulon_tpu_torch.utils.word2vec import WordVectors

_DEFAULT_ENCODE_CHUNK = 1 << 20


def _normalize_np(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return np.where(norms > 0, x / np.where(norms > 0, norms, 1.0), x)


def _encode_chunked(pq: ProductQuantizer, x, chunk: int, mesh=None) -> torch.Tensor:
    """Encode rows (host or device) ``chunk`` at a time on the quantizer's
    device, or with ``mesh`` over every device of the mesh (P3,
    ``ProductQuantizer.scala:25-35`` at mesh scale); the codes land on the
    quantizer's device."""
    if mesh is not None and len(x):
        from gulon_tpu_torch.parallel.ops import sharded_encode

        return torch.from_numpy(sharded_encode(pq, x, mesh, chunk=chunk)).to(pq.device)
    parts = [pq.encode(x[start : start + chunk]) for start in range(0, len(x), chunk)]
    if not parts:
        return torch.zeros(
            (0, pq.num_quantizers), dtype=pq.dtype_codes, device=pq.device
        )
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def build_flat_index(
    keys: Sequence[str],
    vectors,
    metric: Metric = Metric.L2,
    pq_config: PQConfig = PQConfig(),
    *,
    encode_chunk: int = _DEFAULT_ENCODE_CHUNK,
    opq_iters: int = 0,
    report_fn=None,
    mesh=None,
    device=DEFAULT_DEVICE,
) -> FlatIndex:
    """Linear build: sort -> PQ train -> encode (``BuildIndex.scala:84-93``).

    ``vectors`` is host data (numpy or nested lists); training sample,
    codes and norms live on ``device``. With ``mesh`` the codebooks train
    and the rows encode distributed over its devices. With ``opq_iters >
    0`` a rotation is learned first and the codes quantize ``x @
    rotation`` (``gulon_tpu/models/build.py:86-111``); queries rotate
    inside the index."""
    with tracing.span("gulon.build"):
        check_mesh(mesh)
        with tracing.span("gulon.build.host"):
            x = np.asarray(vectors, np.float32)
            keys = np.asarray(keys, dtype=object)
            if len(keys) != len(x):
                raise ValueError("keys and vectors must have equal length")
            if metric.normalized:
                x = _normalize_np(x)

            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            x = x[order]

        rotation = None
        with tracing.span("gulon.build.train"):
            if opq_iters > 0:
                rotation, pq = train_opq(
                    x, pq_config, opq_iters=opq_iters, mesh=mesh, device=device
                )
                x = matmul(torch.from_numpy(x).to(device), rotation, "highest")
            else:
                pq = train_product_quantizer(
                    x, pq_config, None if mesh is not None else report_fn, mesh=mesh,
                    device=device,
                )
        with tracing.span("gulon.build.encode"):
            codes = _encode_chunked(pq, x, encode_chunk, mesh)
            recon_norms = pq.reconstruction_norms(codes)
        return FlatIndex(
            _key_index=SortedKeyIndex(keys),
            pq=pq,
            codes=codes,
            recon_norms=recon_norms,
            metric=metric,
            rotation=rotation,
        )


def _balanced_split(
    xp: np.ndarray, k: int, cap: int, rng: np.random.Generator
) -> np.ndarray:
    """Assign ``xp``'s rows to ``k`` children, each holding <= ``cap`` rows
    (``gulon_tpu/models/build.py:115``, numpy, carried over unchanged).

    A few host-side Lloyd iterations for quality, then a capacity repair
    pass: each overfull child keeps its ``cap`` nearest rows and the rest
    greedily move to the nearest child with spare room. Feasible because
    ``k*cap >= len(xp)`` by construction.
    """
    n = len(xp)
    init = xp[rng.choice(n, size=k, replace=False)]
    cents = init.astype(np.float32)
    xn = (xp * xp).sum(1)
    for _ in range(10):
        d2 = xn[:, None] - 2.0 * (xp @ cents.T) + (cents * cents).sum(1)[None]
        assign = d2.argmin(1)
        for j in range(k):
            sel = assign == j
            if sel.any():
                cents[j] = xp[sel].mean(0)
    d2 = xn[:, None] - 2.0 * (xp @ cents.T) + (cents * cents).sum(1)[None]
    assign = d2.argmin(1)
    counts = np.bincount(assign, minlength=k)
    for j in range(k):
        if counts[j] <= cap:
            continue
        idx = np.nonzero(assign == j)[0]
        move = idx[np.argsort(d2[idx, j])][cap:]
        counts[j] = cap
        for r in move:
            for cnd in np.argsort(d2[r]):
                if cnd != j and counts[cnd] < cap:
                    assign[r] = cnd
                    counts[cnd] += 1
                    break
    return assign


def _split_oversized_partitions(
    fetch_rows,
    assignments: np.ndarray,
    centroids: np.ndarray,
    cap: int,
    seed: int,
):
    """Split every partition with > ``cap`` rows into <= ``cap``-row
    children with their own centroids (the child-member means), so the
    per-probe cost of the sublinear strategies, which scales with the
    largest partition, stays bounded. ``fetch_rows(row_ids) -> [len, d]``
    supplies vectors on demand. Numpy, as ``gulon_tpu/models/build.py:154``.
    """
    assignments = np.asarray(assignments, np.int64).copy()
    cents = list(np.asarray(centroids, np.float32))
    rng = np.random.default_rng(seed)
    next_id = len(cents)
    for pid in range(len(cents)):
        rows = np.nonzero(assignments == pid)[0]
        if len(rows) <= cap:
            continue
        xp = np.asarray(fetch_rows(rows), np.float32)
        kchild = -(-len(rows) // cap)
        child = _balanced_split(xp, kchild, cap, rng)
        for j in range(kchild):
            sel = child == j
            c_j = (
                xp[sel].mean(0).astype(np.float32)
                if sel.any()
                else cents[pid]
            )
            if j == 0:
                cents[pid] = c_j
            else:
                assignments[rows[sel]] = next_id
                cents.append(c_j)
                next_id += 1
    return assignments, np.stack(cents)


def default_num_partitions(n: int) -> int:
    """Reference default: ``size / 1000`` (``BuildIndex.scala:104``)."""
    return max(1, n // 1000)


def default_limit(num_partitions: int) -> int:
    """Reference default: ``max(0.05 * partitions, 5)`` (``BuildIndex.scala:105``)."""
    return max(int(0.05 * num_partitions), 5)


def build_ivf_index(
    keys: Sequence[str],
    vectors,
    metric: Metric = Metric.L2,
    pq_config: PQConfig = PQConfig(),
    *,
    num_partitions: Optional[int] = None,
    strategy: Optional[Strategy] = None,
    coarse_max_iters: int = 100,
    coarse_seed: int = 0,
    coarse_init: str = "sample",
    max_partition_size: Optional[int] = None,
    encode_chunk: int = _DEFAULT_ENCODE_CHUNK,
    opq_iters: int = 0,
    report_fn=None,
    mesh=None,
    device=DEFAULT_DEVICE,
) -> IVFIndex:
    """Sublinear build (``BuildIndex.scala:70-82``).

    Coarse k-means, PQ training, encoding and the row constants run on
    ``device``; the grouping is the host-side numpy
    ``WordVectors.grouped`` (``utils/word2vec.py``).
    ``max_partition_size`` splits oversized partitions into
    capacity-bounded children. The coarse init draws from
    ``torch.Generator``, not ``jax.random``, so a build matches the JAX
    package's by recall, not id for id. With ``opq_iters > 0`` the
    rotation is learned on the coarse residuals and applied as a global
    basis change to residuals and centroids, which leaves the coarse
    assignment exact (``gulon_tpu/models/build.py:284-300``). With
    ``mesh`` the coarse k-means, the PQ training and the encode run
    distributed over its devices."""
    with tracing.span("gulon.build"):
        check_mesh(mesh)
        with tracing.span("gulon.build.host"):
            x = np.asarray(vectors, np.float32)
            keys = np.asarray(keys, dtype=object)
            if len(keys) != len(x):
                raise ValueError("keys and vectors must have equal length")
            if metric.normalized:
                x = _normalize_np(x)
        if num_partitions is None:
            num_partitions = default_num_partitions(len(x))
        if strategy is None:
            strategy = LimitGroups(default_limit(num_partitions))

        # coarse clustering over the full vectors (CommandUtils.scala:127-133)
        coarse_cfg = KMeansConfig(
            k=num_partitions, max_iters=coarse_max_iters, seed=coarse_seed, init=coarse_init,
        )
        with tracing.span("gulon.build.train"), tracing.span("gulon.build.coarse"):
            if mesh is not None:
                from gulon_tpu_torch.parallel.ops import sharded_fit_kmeans

                coarse = sharded_fit_kmeans(x, coarse_cfg, mesh)
            else:
                with tracing.span("gulon.wait.upload_rows"):
                    xd = torch.as_tensor(x, device=device)
                coarse = fit_kmeans(xd, coarse_cfg, report_fn)
                del xd  # the rows leave the device with the k-means
            with tracing.span("gulon.wait.coarse_result"):
                coarse_cents = coarse.centroids.cpu().numpy()
                coarse_assign = coarse.assignments.cpu().numpy()
        with tracing.span("gulon.build.host"):
            if max_partition_size is not None:
                if max_partition_size < 1:
                    raise ValueError("max_partition_size must be >= 1")
                coarse_assign, coarse_cents = _split_oversized_partitions(
                    lambda rows: x[rows], coarse_assign, coarse_cents,
                    max_partition_size, coarse_seed,
                )
            grouped = WordVectors(keys, x).grouped(coarse_cents, coarse_assign)
            residuals = grouped.residuals()

        with tracing.span("gulon.wait.upload_centroids"):
            centroids = torch.from_numpy(np.array(grouped.centroids, np.float32)).to(device)
        rotation = None
        with tracing.span("gulon.build.train"):
            if opq_iters > 0:
                rotation, pq = train_opq(
                    residuals, pq_config, opq_iters=opq_iters, mesh=mesh, device=device
                )
                residuals = matmul(torch.from_numpy(residuals).to(device), rotation, "highest")
                centroids = matmul(centroids, rotation, "highest")
            else:
                pq = train_product_quantizer(
                    residuals, pq_config, None if mesh is not None else report_fn, mesh=mesh,
                    device=device,
                )
        with tracing.span("gulon.build.encode"):
            codes = _encode_chunked(pq, residuals, encode_chunk, mesh)
            # per-row constant of the expanded residual distance,
            # ||r^||^2 + 2<c_g, r^>, by per-partition LUT gathers
            row_const = pq.reconstruction_norms(codes) + 2.0 * pq.centroid_code_dot(
                codes, centroids, grouped.group_ids
            )
        with tracing.span("gulon.wait.upload_groups"):
            group_ids = torch.from_numpy(grouped.group_ids).to(device)
        return IVFIndex(
            _key_index=GroupedKeyIndex(grouped.keys, grouped.group_offsets),
            pq=pq,
            codes=codes,
            row_const=row_const,
            group_ids=group_ids,
            centroids=centroids,
            metric=metric,
            strategy=strategy,
            rotation=rotation,
        )
