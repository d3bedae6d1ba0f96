"""Streaming ADC / exact scans with a fused top-k.

Counterpart of ``gulon_tpu/ops/scan.py``. Every scan walks the rows in
tiles and carries the best ``(distance, row id)`` pairs across tiles
(concatenate + top-k per tile, the functional ``TopKHeap``):

- ``adc_scan_decode``: decode a tile of codes to ``[T, m*dsub]``, then one
  queries x tile matmul with precomputed reconstruction norms,
  ``||q||^2 + ||x^||^2 - 2<q, x^>``;
- ``adc_scan_lut``: per-subspace gathers from the ``[Q, m, K]`` lookup
  table (``Index.scala:393-409``), the cheaper path for tiny batches;
- ``cached_scan``: one queries x tile matmul over a decoded cache of the
  codes (no per-batch decode);
- ``exact_scan``: brute force over raw vectors
  (``exactNearestNeighbours``, ``Index.scala:209-229``), also the ground
  truth of the recall harness;
- ``ivf_block_rescore``: exact f32 re-rank of the IVF fused strategy's
  over-fetched block winners;
- ``pack_rows`` / ``unpack_tile``: row-major packing of 2- and 4-bit codes
  into bytes, which ``adc_scan_decode`` and ``rescore_exact`` unpack a
  tile at a time (``packed_width``).

All return squared-L2 distances ascending and global row ids; padding
rows carry +inf norms and never enter the top-k.

``topk_impl="approx"`` asks the JAX package for ``lax.approx_min_k``,
which torch does not have. The port accepts ``"approx"`` and
``recall_target`` and computes the top-k exactly, so both names give
the same (exact) answer here.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from gulon_tpu_torch.ops.distance import sq_norms
from gulon_tpu_torch.ops.pq import split_subspaces
from gulon_tpu_torch.ops.precision import matmul, resolve_precision
from gulon_tpu_torch.ops.topk import approx_smallest_k, smallest_k, smallest_k_nan_last
from gulon_tpu_torch.utils import tracing

DEFAULT_TILE_ROWS = 16384


def _check_topk_impl(topk_impl: str) -> None:
    if topk_impl not in ("approx", "exact"):
        raise ValueError(f"unknown topk impl {topk_impl!r}")


_STACK_BYTES = 64 * 1024 * 1024  # the JAX package's bound on stacked tile winners


def _streaming_topk(
    dist_tile_fn: Callable[[int, int], torch.Tensor],
    n: int,
    tile_rows: int,
    num_queries: int,
    k: int,
    device,
    *,
    topk_impl: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold ``dist_tile_fn(start, stop) -> [Q, stop-start]`` over the rows,
    keeping the k best (distance, global row id) per query, ranked as the
    JAX package's ``_streaming_topk`` ranks them
    (``gulon_tpu/ops/scan.py:71-181``):

    - ``"approx"``: each tile's ``min(k, tile_rows)`` winners by
      ``approx_smallest_k`` (``lax.approx_min_k`` off the TPU, which
      raises on k < 1), the last tile read as the JAX package pads it to
      ``tile_rows`` (+inf rows; NaN in a row of NaN); the winners of
      every tile stacked and ranked once (``smallest_k``), or, past 64 MB
      of winners, merged tile by tile into ``(inf, -1)`` slots. Slots at
      +inf become ``(inf, -1)``. A NaN distance survives only the stacked
      route: the JAX package's slots outrank a positive NaN;
    - ``"exact"``: every tile merged into ``(inf, -1)`` slots.

    Equal distances keep the lowest row. A row of NaN keeps the JAX
    package's positions in its padded last tile, which may pass ``n``:
    whatever gathers by these ids clamps them, as the JAX package's
    gathers do."""
    n_tiles = -(-n // tile_rows)
    kk = min(k, tile_rows)
    approx = topk_impl == "approx"

    def tile(start):
        stop = min(start + tile_rows, n)
        d = dist_tile_fn(start, stop)
        if approx:
            d, pos = approx_smallest_k(d, kk, length=tile_rows)
            return d, start + pos
        rows = torch.arange(start, stop, dtype=torch.int32, device=device)
        return d, rows.expand(num_queries, -1)

    if approx and n_tiles * num_queries * kk * 8 <= _STACK_BYTES:
        cand_d = torch.empty((num_queries, 0), device=device)
        cand_i = torch.empty((num_queries, 0), dtype=torch.int32, device=device)
        tiles = [tile(start) for start in range(0, n, tile_rows)]
        if tiles:
            cand_d = torch.cat([d for d, _ in tiles], dim=1)
            cand_i = torch.cat([i for _, i in tiles], dim=1)
        best_d, pos = smallest_k(cand_d, min(k, cand_d.shape[1]))
        best_i = torch.gather(cand_i, 1, pos.long())
        pad = k - best_d.shape[1]
        best_d = torch.nn.functional.pad(best_d, (0, pad), value=float("inf"))
        best_i = torch.nn.functional.pad(best_i, (0, pad), value=-1)
    else:
        best_d = torch.full((num_queries, k), float("inf"), device=device)
        best_i = torch.full((num_queries, k), -1, dtype=torch.int32, device=device)
        for start in range(0, n, tile_rows):
            d, ids = tile(start)
            cand_d = torch.cat([best_d, d], dim=1)
            cand_i = torch.cat([best_i, ids], dim=1)
            best_d, pos = smallest_k(cand_d, k)
            best_i = torch.gather(cand_i, 1, pos.long())
        if not approx:
            return best_d, best_i
    return best_d, torch.where(torch.isinf(best_d), -1, best_i)


def _q_pad(queries: torch.Tensor, bounds, dsub: int) -> torch.Tensor:
    """Queries in the padded subspace layout ``[Q, m*dsub]``."""
    qs = split_subspaces(queries, bounds, dsub)  # [m, Q, dsub]
    return qs.permute(1, 0, 2).reshape(queries.shape[0], qs.shape[0] * dsub)


def decode_tile(codebooks: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """Decode a tile of PQ codes ``[T, m]`` to ``[T, m*dsub]`` by indexing
    the codebooks ``[m, K, dsub]``; exact. (The JAX package's one-hot
    matmul formulation exists because a TPU has no fast gather; a GPU
    gathers from cache at full speed.)"""
    m, _, dsub = codebooks.shape
    dec = codebooks[torch.arange(m, device=ci.device)[None, :], ci.long()]
    return dec.reshape(ci.shape[0], m * dsub)


def pack_rows(codes, width: int) -> torch.Tensor:
    """Pack an ``[N, m]`` code matrix to ``[N, ceil(m*width/8)]`` uint8
    (``gulon_tpu/ops/scan.py:295-314``): row-major, code ``s`` of a row in
    bits ``(s % per) * width`` of byte ``s // per``, ``per = 8 // width``.
    Widths 2 and 4 only. Distinct from the wire layout (``ops/coder.py``),
    which is quantizer-major."""
    if width not in (2, 4):
        raise ValueError(f"in-memory packing supports widths 2/4, got {width}")
    codes = torch.as_tensor(codes).to(torch.int32)
    n, m = codes.shape
    per = 8 // width
    pad = (-m) % per
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    shifts = torch.arange(per, dtype=torch.int32, device=codes.device) * width
    grouped = codes.reshape(n, -1, per) << shifts
    return grouped.sum(dim=2).to(torch.uint8)


def unpack_tile(packed: torch.Tensor, m: int, width: int) -> torch.Tensor:
    """``[T, B] uint8 -> [T, m] int32``, the inverse of :func:`pack_rows`."""
    per = 8 // width
    shifts = torch.arange(per, dtype=torch.int32, device=packed.device) * width
    cols = (packed.to(torch.int32)[:, :, None] >> shifts) & ((1 << width) - 1)
    return cols.reshape(packed.shape[0], packed.shape[1] * per)[:, :m]


def _tile_codes(codes: torch.Tensor, m: int, packed_width: int) -> torch.Tensor:
    """A tile of codes as ``[T, m]``: unpacked when ``packed_width``."""
    return unpack_tile(codes, m, packed_width) if packed_width else codes


def adc_scan_decode(
    queries: torch.Tensor,  # [Q, D] f32
    codebooks: torch.Tensor,  # [m, K, dsub] f32
    codes: torch.Tensor,  # [N, m] codes (or [N, B] packed uint8, see packed_width)
    recon_norms: torch.Tensor,  # [N] f32 = ||decode(codes)||^2
    *,
    bounds,
    k: int,
    tile_rows: int = DEFAULT_TILE_ROWS,
    precision: str = "default",
    topk_impl: str = "approx",
    recall_target: float = 0.95,
    packed_width: int = 0,  # 0 = [N, m] codes; 2/4 = row-packed uint8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode + matmul ADC scan; a packed tile unpacks before it decodes.
    Returns ([Q,k] dists, [Q,k] ids)."""
    _check_topk_impl(topk_impl)
    resolve_precision(precision)
    num_q = queries.shape[0]
    m = codebooks.shape[0]
    n = codes.shape[0]
    tile_rows = min(tile_rows, max(n, 1))
    q_pad = _q_pad(queries, bounds, codebooks.shape[2])
    qn = sq_norms(queries)

    def dist_tile(start, stop):
        dec = decode_tile(codebooks, _tile_codes(codes[start:stop], m, packed_width))
        ip = matmul(q_pad, dec.T, precision)
        return qn[:, None] + recon_norms[None, start:stop] - 2.0 * ip

    return _streaming_topk(
        dist_tile, n, tile_rows, num_q, k, queries.device, topk_impl=topk_impl
    )


def adc_scan_lut(
    lut: torch.Tensor,  # [Q, m, K] f32 = ||q_sub - c||^2
    codes: torch.Tensor,  # [N, m] codes
    valid_rows: torch.Tensor,  # [N] bool (True = scannable)
    *,
    k: int,
    tile_rows: int = DEFAULT_TILE_ROWS,
    topk_impl: str = "approx",
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LUT gather-accumulate ADC scan (``Index.scala:393-409``)."""
    _check_topk_impl(topk_impl)
    num_q, m, _ = lut.shape
    n = codes.shape[0]
    tile_rows = min(tile_rows, max(n, 1))
    lut_t = lut.permute(1, 2, 0)  # [m, K, Q]

    def dist_tile(start, stop):
        ci = codes[start:stop].long()
        acc = torch.zeros((stop - start, num_q), device=lut.device)
        for s in range(m):
            acc = acc + lut_t[s][ci[:, s]]  # [T, Q]
        d = acc.T
        return torch.where(valid_rows[None, start:stop], d, float("inf"))

    return _streaming_topk(
        dist_tile, n, tile_rows, num_q, k, lut.device, topk_impl=topk_impl
    )


def rescore_exact(
    queries: torch.Tensor,  # [Q, D] f32
    codebooks: torch.Tensor,  # [m, K, dsub] f32
    codes: torch.Tensor,  # [N, m] codes (or [N, B] packed uint8, see packed_width)
    recon_norms: torch.Tensor,  # [N] f32
    cand_ids: torch.Tensor,  # [Q, C] candidate rows (-1 = empty slot)
    *,
    bounds,
    k: int,
    packed_width: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 ADC rescore of per-query candidate sets: the bf16-ranked
    fast scans over-fetch, and this ranks the survivors at full precision.
    Returns ([Q, k] exact dists ascending, [Q, k] ids)."""
    with tracing.span("gulon.scan.rescore"):
        num_q, c = cand_ids.shape
        m, _, dsub = codebooks.shape
        cand_ids = cand_ids.to(torch.int32)
        # clamped as the JAX package's gather clamps: a NaN query row's ids
        # may pass the last row (``_streaming_topk``)
        safe = torch.clamp(cand_ids, 0, codes.shape[0] - 1).long()
        gathered = _tile_codes(codes[safe.reshape(-1)], m, packed_width)
        dec = decode_tile(codebooks, gathered).reshape(
            num_q, c, m * dsub
        )
        q_pad = _q_pad(queries, bounds, dsub)
        ip = matmul(dec, q_pad[:, :, None], "highest")[..., 0]  # [Q, C]
        d = sq_norms(queries)[:, None] + recon_norms[safe] - 2.0 * ip
        d = torch.where(cand_ids < 0, float("inf"), d)
        kf = min(k, c)
        vals, pos = smallest_k(d, kf)
        ids = torch.gather(cand_ids, 1, pos.long())
        ids = torch.where(torch.isinf(vals), -1, ids)
        if kf < k:
            vals = torch.nn.functional.pad(vals, (0, k - kf), value=float("inf"))
            ids = torch.nn.functional.pad(ids, (0, k - kf), value=-1)
        return vals, ids


def ivf_block_rescore(
    queries: torch.Tensor,  # [Q, D] f32 (normalized residual basis)
    q_norms: torch.Tensor,  # [Q] f32 ||q||^2
    codebooks: torch.Tensor,  # [m, K, dsub] f32 residual codebooks
    codes_t: torch.Tensor,  # [m, Npad] kernel code operand (int8 offset or int)
    rc: torch.Tensor,  # [Npad] f32 row constants of the padded layout
    cand_vals: torch.Tensor,  # [Q, F] block-min values (inf = invalid slot)
    cand_rows: torch.Tensor,  # [Q, F] padded-layout rows of the winners
    cand_gt: torch.Tensor,  # [Q, F] per-candidate group term
    *,
    bounds,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-rank of IVF fused-kernel block winners (counterpart of
    ``gulon_tpu/ops/scan.py::ivf_block_rescore``): the expanded residual
    distance ``||q||^2 + rc + group_term - 2<q, dec(row)>`` recomputed at
    full f32 for the over-fetched candidates. Returns ``([Q, k] exact
    dists, [Q, k] re-ranked padded-layout rows)``."""
    with tracing.span("gulon.scan.rescore"):
        num_q, fetch = cand_rows.shape
        m, _, dsub = codebooks.shape
        invalid = torch.isinf(cand_vals)
        safe = torch.where(invalid, 0, cand_rows).long()
        sel = codes_t[:, safe.reshape(-1)].to(torch.int32)  # [m, Q*F]
        if codes_t.dtype == torch.int8:  # undo the offset encoding
            sel = sel + 128
        dec = decode_tile(codebooks.to(torch.float32), sel.T).reshape(
            num_q, fetch, m * dsub
        )
        q_pad = _q_pad(queries, bounds, dsub)
        ip = matmul(dec, q_pad[:, :, None], "highest")[..., 0]  # [Q, F]
        exact = q_norms[:, None] + rc[safe] + cand_gt - 2.0 * ip
        exact = torch.where(invalid, float("inf"), exact)
        best, pos = smallest_k_nan_last(exact, min(k, fetch))
        return best, torch.gather(cand_rows, 1, pos.long())


def cached_scan(
    q_pad: torch.Tensor,  # [Q, m*dsub] f32, queries in the padded layout
    decoded: torch.Tensor,  # [N, m*dsub] bf16/f32 precomputed reconstructions
    recon_norms: torch.Tensor,  # [N] f32 (exact, not recomputed from the cache)
    *,
    k: int,
    tile_rows: int = DEFAULT_TILE_ROWS,
    topk_impl: str = "approx",
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC scan over a *cached decode* of the code matrix.

    The queries are cast to the cache's dtype and the matmul accumulates
    in f32 (both operands upcast; products of bf16 values are exact in
    f32). Results equal the decode scan's up to the rounding of the
    stored reconstructions."""
    _check_topk_impl(topk_impl)
    num_q = q_pad.shape[0]
    n = decoded.shape[0]
    tile_rows = min(tile_rows, max(n, 1))
    qn = sq_norms(q_pad)
    qc = q_pad.to(decoded.dtype).to(torch.float32)

    def dist_tile(start, stop):
        ip = matmul(qc, decoded[start:stop].to(torch.float32).T, "highest")
        return qn[:, None] + recon_norms[None, start:stop] - 2.0 * ip

    return _streaming_topk(
        dist_tile, n, tile_rows, num_q, k, q_pad.device, topk_impl=topk_impl
    )


def exact_scan(
    queries: torch.Tensor,  # [Q, D] f32
    data: torch.Tensor,  # [N, D] f32
    *,
    k: int,
    tile_rows: int = DEFAULT_TILE_ROWS,
    precision: str = "highest",
    topk_impl: str = "exact",
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force squared-L2 top-k (``exactNearestNeighbours``)."""
    _check_topk_impl(topk_impl)
    resolve_precision(precision)
    num_q = queries.shape[0]
    n = data.shape[0]
    tile_rows = min(tile_rows, max(n, 1))
    qn = sq_norms(queries)
    xn = sq_norms(data)

    def dist_tile(start, stop):
        ip = matmul(queries, data[start:stop].T, precision)
        return qn[:, None] + xn[None, start:stop] - 2.0 * ip

    return _streaming_topk(
        dist_tile, n, tile_rows, num_q, k, queries.device, topk_impl=topk_impl
    )
