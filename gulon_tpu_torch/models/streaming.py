"""Streaming builds straight from a word2vec text file (counterpart of
``gulon_tpu/models/streaming.py``).

The in-memory builders (``models/build.py``) hold the whole f32 corpus on
the host: 12 GB at 10M x 300. These builders never do:

1. the native parser indexes the file: keys and the offset of each row's
   line only (``utils/native.py::Word2VecStream``);
2. the codebooks train on a row sample parsed on demand, drawn exactly as
   ``train_product_quantizer`` draws from an in-memory corpus in the same
   order, so with the same configuration both builders train the same
   codebooks and write the same codes: streaming changes where the rows
   live, not the result;
3. the rows stream through the device in chunks, double-buffered: a parser
   thread fills chunk N+1 into one pinned host buffer while chunk N, copied
   from the other, encodes on the device;
4. only the ``[N, m]`` codes (on the device), the keys and the per-row
   scalars persist; the key sort (or the partition grouping) is applied to
   the codes.

The streaming IVF build trains its coarse quantizer on the training sample
rather than on the whole corpus (the JAX package's semantics; every row is
still assigned and encoded exactly). With ``mesh`` the k-means stages
train distributed and each chunk encodes over every device of the mesh
(``parallel/ops.py``); pass A's coarse assignment stays on ``device``, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from gulon_tpu_torch.models.build import (
    _encode_chunked,
    _normalize_np,
    _split_oversized_partitions,
    default_limit,
    default_num_partitions,
)
from gulon_tpu_torch.models.flat import FlatIndex
from gulon_tpu_torch.models.ivf import IVFIndex, LimitGroups, Strategy
from gulon_tpu_torch.models.keyindex import GroupedKeyIndex, SortedKeyIndex
from gulon_tpu_torch.models.metric import Metric
from gulon_tpu_torch.ops.kmeans import KMeansConfig, _assign_blocked, fit_kmeans
from gulon_tpu_torch.ops.pq import PQConfig, train_product_quantizer
from gulon_tpu_torch.parallel.mesh import check_mesh
from gulon_tpu_torch.parallel.ops import sharded_fit_kmeans
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE
from gulon_tpu_torch.utils.native import Word2VecStream

_DEFAULT_CHUNK = 1 << 18


@dataclasses.dataclass
class StreamProgress:
    """Per-chunk pipeline report (rows encoded so far)."""

    rows_done: int
    total_rows: int

    @property
    def percentage(self) -> float:
        return 100.0 * self.rows_done / max(self.total_rows, 1)


def _train_sample(
    stream: Word2VecStream,
    config: PQConfig,
    normalized: bool,
    order: Optional[np.ndarray] = None,
):
    """Training rows, drawn exactly as ``train_product_quantizer`` draws
    from a host corpus presented in ``order`` (``ops/pq.py``: the same
    numpy draw, then sorted), so both builders train the same codebooks.
    Returns ``(vectors, file row ids)``."""
    n = stream.num_rows
    sample_n = min(config.train_sample or n, n)
    if sample_n < n:
        rng = np.random.default_rng(config.seed)
        ids = np.sort(rng.choice(n, sample_n, replace=False))
    else:
        ids = np.arange(n)
    rows = ids if order is None else order[ids]
    x = stream.gather(rows)
    return (_normalize_np(x) if normalized else x), rows


def _pipeline(stream, n, chunk, normalized, consume, report_fn=None,
              stats=None, *, device=DEFAULT_DEVICE):
    """Double-buffered parse -> consume loop: a parser thread fills chunk
    N+1 while ``consume(start, rows)`` runs on chunk N, ``rows`` an f32
    tensor on ``device``.

    On a CUDA device the chunks stage through two pinned host buffers and
    copy with ``non_blocking=True``; the parser writes into a buffer only
    after the CUDA event recorded behind its last copy has completed, so a
    copy in flight never reads a half-parsed chunk.

    ``stats`` (optional dict) accumulates the time split: ``wait_s``, the
    main thread blocked on the parser (parse not hidden behind device
    work); ``consume_s``, time in ``consume``; ``wall_s``, the whole loop
    up to the device finishing. The overlap fraction a benchmark reports
    is ``1 - wait_s / parse_only_s``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    t_all = time.monotonic()
    wait_s = consume_s = 0.0
    chunk = max(1, min(chunk, n))
    bufs = [
        torch.empty((chunk, stream.dim), dtype=torch.float32, pin_memory=cuda)
        for _ in range(2)
    ]
    copied = [None, None]  # event behind each buffer's last copy

    def produce(slot, start, count):
        if copied[slot] is not None:
            copied[slot].synchronize()
        x = stream.rows(start, count, out=bufs[slot].numpy())
        if normalized:
            x[:] = _normalize_np(x)
        return slot, count

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(produce, 0, 0, min(chunk, n)) if n else None
        start = 0
        while start < n:
            t0 = time.monotonic()
            slot, count = fut.result()
            wait_s += time.monotonic() - t0
            nxt = start + count
            if nxt < n:
                fut = pool.submit(produce, 1 - slot, nxt, min(chunk, n - nxt))
            t0 = time.monotonic()
            rows = bufs[slot][:count].to(device, non_blocking=cuda)
            if cuda:
                copied[slot] = torch.cuda.Event()
                copied[slot].record()
            consume(start, rows)
            consume_s += time.monotonic() - t0
            if report_fn is not None:
                report_fn(StreamProgress(rows_done=nxt, total_rows=n))
            start = nxt
    if cuda:
        torch.cuda.synchronize(device)
    if stats is not None:
        stats["wait_s"] = stats.get("wait_s", 0.0) + wait_s
        stats["consume_s"] = stats.get("consume_s", 0.0) + consume_s
        stats["wall_s"] = stats.get("wall_s", 0.0) + (time.monotonic() - t_all)


def build_flat_index_streaming(
    path: str,
    metric: Metric = Metric.L2,
    pq_config: PQConfig = PQConfig(),
    *,
    encode_chunk: int = _DEFAULT_CHUNK,
    num_threads: int = 0,
    report_fn=None,
    mesh=None,
    pipeline_stats: Optional[dict] = None,
    device=DEFAULT_DEVICE,
) -> FlatIndex:
    """Linear build straight from a word2vec text file, never holding the
    f32 corpus in host memory (``BuildIndex.scala:84-93`` at streaming
    scale). Codebooks, codes and norms live on ``device``; with the same
    ``pq_config`` the index equals ``build_flat_index`` of the file's
    vectors."""
    check_mesh(mesh)
    with Word2VecStream(path, num_threads) as stream:
        n = stream.num_rows
        # the reference trains on the key-sorted corpus
        # (BuildIndex.scala:84-93: vecs.sorted before quantizeVectors)
        order = np.argsort(stream.keys, kind="stable")
        train_x, _ = _train_sample(stream, pq_config, metric.normalized, order=order)
        pq = train_product_quantizer(
            train_x, pq_config._replace(train_sample=None), mesh=mesh, device=device
        )
        del train_x
        codes = torch.empty((n, pq.num_quantizers), dtype=pq.dtype_codes, device=device)

        def consume(start, x):
            codes[start : start + len(x)] = _encode_chunked(pq, x, len(x), mesh)

        _pipeline(
            stream, n, encode_chunk, metric.normalized, consume, report_fn,
            stats=pipeline_stats, device=device,
        )
        keys = stream.keys

    codes = codes[torch.from_numpy(order).to(codes.device)]
    return FlatIndex(
        _key_index=SortedKeyIndex(keys[order]),
        pq=pq,
        codes=codes,
        recon_norms=pq.reconstruction_norms(codes),
        metric=metric,
    )


def build_ivf_index_streaming(
    path: str,
    metric: Metric = Metric.L2,
    pq_config: PQConfig = PQConfig(),
    *,
    num_partitions: Optional[int] = None,
    strategy: Optional[Strategy] = None,
    coarse_max_iters: int = 100,
    coarse_seed: int = 0,
    coarse_init: str = "sample",
    max_partition_size: Optional[int] = None,
    encode_chunk: int = _DEFAULT_CHUNK,
    num_threads: int = 0,
    report_fn=None,
    mesh=None,
    device=DEFAULT_DEVICE,
) -> IVFIndex:
    """Sublinear build straight from a word2vec text file
    (``BuildIndex.scala:70-82`` at streaming scale), on ``device``.

    Two streamed passes: coarse-assign every row, then encode its
    residual; the grouping permutation is applied to the codes, not to the
    vectors. Pass A assigns with the routine and precision of the
    k-means the in-memory builder's assignments come from, so with a
    sample covering the corpus both builders give the same index."""
    check_mesh(mesh)
    with Word2VecStream(path, num_threads) as stream:
        n = stream.num_rows
        if num_partitions is None:
            num_partitions = default_num_partitions(n)
        if strategy is None:
            strategy = LimitGroups(default_limit(num_partitions))

        # the coarse quantizer trains on read-order rows, like the
        # reference's computePartitions over the unsorted corpus
        train_x, _ = _train_sample(stream, pq_config, metric.normalized)
        coarse_cfg = KMeansConfig(
            k=num_partitions, max_iters=coarse_max_iters, seed=coarse_seed,
            init=coarse_init,
        )
        if mesh is not None:
            coarse = sharded_fit_kmeans(train_x, coarse_cfg, mesh)
        else:
            coarse = fit_kmeans(train_x, coarse_cfg, report_fn, device=device)
        del train_x
        cent_dev = coarse.centroids.to(device)
        centroids_full = cent_dev.cpu().numpy()

        # pass A: the nearest coarse centroid of every row
        assign_dev = torch.empty(n, dtype=torch.int32, device=cent_dev.device)

        def consume_assign(start, x):
            assign_dev[start : start + len(x)] = _assign_blocked(
                x[None], cent_dev[None], coarse_cfg.block_rows, coarse_cfg.precision
            )[0]

        _pipeline(
            stream, n, encode_chunk, metric.normalized, consume_assign, report_fn,
            device=device,
        )
        assignments = assign_dev.cpu().numpy()

        if max_partition_size is not None:
            # only one partition's rows are ever parsed into host memory
            if max_partition_size < 1:
                raise ValueError("max_partition_size must be >= 1")

            def fetch(rows):
                xp = stream.gather(rows)
                return _normalize_np(xp) if metric.normalized else xp

            assignments, centroids_full = _split_oversized_partitions(
                fetch, assignments, centroids_full, max_partition_size, coarse_seed,
            )
            assignments = assignments.astype(np.int32)
            num_partitions = len(centroids_full)
            assign_dev = torch.from_numpy(assignments).to(cent_dev.device)
            cent_dev = torch.from_numpy(centroids_full).to(cent_dev.device)

        # the (cluster, key) order is known from pass A; the residual PQ
        # trains on grouped-order residuals, as the in-memory builder's
        order = np.lexsort((stream.keys, assignments))
        pq_x, pq_rows = _train_sample(stream, pq_config, metric.normalized, order=order)
        pq = train_product_quantizer(
            pq_x - centroids_full[assignments[pq_rows]],
            pq_config._replace(train_sample=None), mesh=mesh, device=device,
        )
        del pq_x

        # pass B: encode every row's residual
        codes = torch.empty(
            (n, pq.num_quantizers), dtype=pq.dtype_codes, device=cent_dev.device
        )

        def consume_encode(start, x):
            stop = start + len(x)
            res = x - cent_dev[assign_dev[start:stop].long()]
            codes[start:stop] = _encode_chunked(pq, res, len(res), mesh)

        _pipeline(
            stream, n, encode_chunk, metric.normalized, consume_encode, report_fn,
            device=device,
        )
        keys = stream.keys

    # group rows by (cluster, key), dropping empty clusters
    # (WordVectors.scala:24-58): the permutation applies to the codes only
    sorted_assign = assignments[order]
    used = np.unique(sorted_assign)
    relabel = np.full(num_partitions, -1, np.int32)
    relabel[used] = np.arange(len(used), dtype=np.int32)
    group_ids = relabel[sorted_assign]
    group_offsets = np.searchsorted(group_ids, np.arange(1, len(used))).astype(np.int32)
    dev = codes.device
    codes = codes[torch.from_numpy(order).to(dev)]
    centroids = torch.from_numpy(np.ascontiguousarray(centroids_full[used])).to(dev)
    # row_const = ||r^||^2 + 2<c_g, r^> from the codes alone
    row_const = pq.reconstruction_norms(codes) + 2.0 * pq.centroid_code_dot(
        codes, centroids, group_ids
    )
    return IVFIndex(
        _key_index=GroupedKeyIndex(keys[order], group_offsets),
        pq=pq,
        codes=codes,
        row_const=row_const,
        group_ids=torch.from_numpy(group_ids).to(dev),
        centroids=centroids,
        metric=metric,
        strategy=strategy,
    )
