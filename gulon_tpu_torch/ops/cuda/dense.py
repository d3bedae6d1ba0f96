"""Fused dense scans: the counterpart of ``gulon_tpu/ops/pallas/dense.py``.

Kernels K2 and K3 (``csrc/dense_scan.cu``) replace the TPU kernels
``_dense_kernel`` and ``_dense_kernel_i8``: per 128-row block of a dense
operand and per query they score the rows with one contraction and keep
the block's lane-packed minimum. This module holds everything around
them, with the JAX package's names and semantics:

- operand prep: ``padded_dim`` / ``prepare_data`` (bf16 rows with the
  hi/lo bf16 split of ``||x||^2`` in the last two lanes) and
  ``padded_dim_i8`` / ``prepare_data_i8`` / ``DenseI8Meta`` (int8 rows
  with the centered norm as a base-127 digit pair);
- the launches :func:`dense_block_scan` (K2) and
  :func:`dense_block_scan_i8` (K3), which run the kernel for CUDA tensors
  and its plain PyTorch twin for CPU tensors;
- the entry points :func:`dense_scan_fused` (``dense_scan_pallas``) and
  :func:`dense_scan_fused_i8` (``dense_scan_pallas_i8``) with their
  plain-torch epilogues: exact top-k over the block winners, id decode,
  optional rescore.

Packed winners are ``[Q, ceil(n/128)]``: column ``c`` is the global
128-row block ``c``, as in the TPU kernels' output, so ``tile_rows`` only
pads there and never changes an answer. Rows past ``n`` in the last
block score as the JAX package's padding rows do: zero data lanes and a
``bf16(_BIG)`` norm lane (K2) or the digit pair (127, 126) (K3). No
corpus copy is made per call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gulon_tpu_torch.ops.distance import sq_norms
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.ops.topk import smallest_k_nan_last
from gulon_tpu_torch.utils import tracing

_BIG = 3.0e38
_INVALID_MIN = 1.0e38
_LANES = 128
_N14_MAX = 127 * 127 + 126  # base-127 two-lane integer range
_PLAIN_SCORE_BYTES = 1 << 30  # score tile budget of the plain twins
# score of a padding row: K2 zero lanes + bf16(_BIG) against a unit lane,
# K3 zero lanes + the digit pair (127, 126) against (127, 1)
_TAIL_F32 = float(torch.tensor(_BIG).to(torch.bfloat16).to(torch.float32))
_TAIL_I32 = _N14_MAX


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_dim(d: int) -> int:
    """Lane count of the bf16 operand: D data lanes + 2 norm lanes,
    8-aligned. The norm hi/lo pair lives in the LAST two lanes."""
    return _round_up(d + 2, 8)


def padded_dim_i8(d: int) -> int:
    """Lane count of the int8 operand: D data lanes + 2 norm lanes,
    32-aligned."""
    return _round_up(d + 2, 32)


def _check_tile_rows(tile_rows: int) -> None:
    if tile_rows and tile_rows % 1024:
        raise ValueError(f"tile_rows must be a 1024-multiple, got {tile_rows}")


def prepare_data(data: torch.Tensor, norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Augmented natural-layout bf16 operand ``[N, D] -> [N, padded_dim(D)]``
    with a hi/lo bf16 split of each row's ``||x||^2`` in the last two
    lanes, on ``data``'s device. Pass ``norms`` to reuse precomputed
    ``||x||^2``; +inf norms clamp to ``_BIG`` (inf - inf would be NaN)."""
    n, d = data.shape
    dp = padded_dim(d)
    if norms is None:
        norms = sq_norms(data.to(torch.float32))
    norms = torch.clamp(norms.to(torch.float32), max=_BIG)
    hi = norms.to(torch.bfloat16)
    lo = (norms - hi.to(torch.float32)).to(torch.bfloat16)
    out = torch.zeros((n, dp), dtype=torch.bfloat16, device=data.device)
    out[:, :d] = data.to(torch.bfloat16)
    out[:, dp - 2] = hi
    out[:, dp - 1] = lo
    return out


@dataclasses.dataclass(frozen=True)
class DenseI8Meta:
    """Dequantization metadata of the int8 operand: ``scale`` is the
    shared symmetric step of data and query lanes, ``nmean`` the norm
    centering constant, ``gain`` the integer coarsening of the score unit.
    A kernel score ``v`` dequantizes to ``v * 2*scale^2*gain + ||q||^2 +
    nmean``."""

    scale: float
    nmean: float
    d: int
    dp: int
    gain: int = 1


def prepare_data_i8(
    data: torch.Tensor, norms: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, DenseI8Meta, torch.Tensor]:
    """Quantize a corpus into the int8 kernel operand (``dense.py:356-416``).

    Returns ``(data_i8 [N, padded_dim_i8(D)] int8, meta, norms f32)``:
    data lanes ``round(x / s)`` with ``s = max|x| / 127``; the last two
    lanes the base-127 digit pair of ``round((||x||^2 - mean) / (2 s^2 g))``,
    which the constant query lanes (127, 1) turn into the centered norm
    term. Raises ValueError for corpora needing ``g > 64`` (use bf16)."""
    n, d = data.shape
    dp = padded_dim_i8(d)
    xf = data.to(torch.float32)
    if norms is None:
        norms = sq_norms(xf)
    norms = torch.clamp(norms.to(torch.float32), max=_BIG)
    s = max(float(torch.max(torch.abs(xf))) / 127.0, 1e-30)
    nmean = float(torch.mean(norms))
    dev_max = float(torch.max(torch.abs(norms - nmean)))
    gain = max(1, int(np.ceil(dev_max / (2.0 * s * s * _N14_MAX))))
    if gain > 64:
        raise ValueError(
            f"norm deviation range {dev_max:.3g} needs gain {gain} > 64 "
            f"(query step would coarsen {gain}x); use the bf16 dense "
            "kernel for this corpus"
        )
    unit = 2.0 * s * s * gain
    n_int = torch.clamp(
        torch.round((norms - nmean) / unit), -_N14_MAX, _N14_MAX
    ).to(torch.int32)
    hi = torch.div(n_int, 127, rounding_mode="floor")
    lo = n_int - hi * 127  # in [0, 126]
    out = torch.zeros((n, dp), dtype=torch.int8, device=data.device)
    out[:, :d] = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    out[:, dp - 2] = hi.to(torch.int8)
    out[:, dp - 1] = lo.to(torch.int8)
    return out, DenseI8Meta(s, nmean, d, dp, gain), norms


def _check_operands(data, q_op, dtype, align: int) -> None:
    if data.dim() != 2 or data.dtype != dtype or data.shape[0] == 0:
        raise ValueError(
            f"data must be [N>0, Dp] {dtype}, got {tuple(data.shape)} {data.dtype}"
        )
    dp = data.shape[1]
    if dp % align:
        raise ValueError(f"data width {dp} must be a multiple of {align}")
    if q_op.dim() != 2 or q_op.shape[1] != dp or q_op.dtype != dtype:
        raise ValueError(
            f"queries must be [Q, {dp}] {dtype}, got {tuple(q_op.shape)} {q_op.dtype}"
        )
    if q_op.shape[0] == 0:
        raise ValueError("need at least one query")
    if q_op.device != data.device:
        raise ValueError(
            f"operands must share one device, got {data.device} and {q_op.device}"
        )


def _plain_blocks(data, q_op, score_fn, pack_fn, tail, out_dtype, elem_bytes):
    """Shared body of the plain twins: scores of row tiles ``[T, Q]``,
    padding rows past ``n`` set to ``tail``, lane pack, per-block min,
    written out as ``[Q, NB]``."""
    n = data.shape[0]
    num_q = q_op.shape[0]
    nb = -(-n // _LANES)
    dev = data.device
    out = torch.empty((num_q, nb), dtype=out_dtype, device=dev)
    step = max(_LANES, _PLAIN_SCORE_BYTES // (elem_bytes * num_q) // _LANES * _LANES)
    lane = (torch.arange(_LANES, dtype=torch.int32, device=dev))[None, :, None]
    for start in range(0, n, step):
        stop = min(start + step, n)
        scores = score_fn(data[start:stop])  # [T, Q]
        rows = _round_up(stop - start, _LANES)
        if rows > stop - start:
            scores = torch.nn.functional.pad(
                scores, (0, 0, 0, rows - (stop - start)), value=tail
            )
        packed = pack_fn(scores.reshape(rows // _LANES, _LANES, num_q), lane)
        out[:, start // _LANES : start // _LANES + rows // _LANES] = torch.amin(
            packed, dim=1
        ).T
    return out


def _dense_block_scan_plain(data: torch.Tensor, q_op: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 on the same operands: bf16 rows
    ``[N, Dp]`` and augmented bf16 queries ``[Q, Dp]`` upcast to f32, one
    full-f32 matmul (products of bf16 values are exact in f32), the row in
    block packed into the 7 low mantissa bits, the min of each 128-row
    block (NaN propagates, as ``jnp.min``). Tiled so no more than
    ``_PLAIN_SCORE_BYTES`` of scores exist at once. Returns ``[Q, NB]``
    f32 packed winners, ``NB = ceil(N / 128)``."""
    _check_operands(data, q_op, torch.bfloat16, 8)
    q = q_op.to(torch.float32)

    def score(tile):
        return matmul(tile.to(torch.float32), q.T, "highest")

    def pack(s3, lane):
        return ((s3.view(torch.int32) & ~127) | lane).view(torch.float32)

    return _plain_blocks(data, q_op, score, pack, _TAIL_F32, torch.float32, 4)


def _dense_block_scan_plain_i8(data_i8: torch.Tensor, q_i8: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: int8 rows ``[N, Dp]`` against int8
    queries ``[Q, Dp]``, exact in float64 (a float32 matmul of int8 values
    is exact only while partial sums stay below 2^24, which deep operands
    exceed), then the integer lane pack ``(s & ~127) | row`` and the min of
    each 128-row block. Returns ``[Q, NB]`` int32, equal bit for bit to
    K3's output."""
    _check_operands(data_i8, q_i8, torch.int8, 32)
    q = q_i8.to(torch.float64)

    def score(tile):
        return torch.matmul(tile.to(torch.float64), q.T).to(torch.int32)

    def pack(s3, lane):
        return (s3 & ~127) | lane

    return _plain_blocks(data_i8, q_i8, score, pack, _TAIL_I32, torch.int32, 8)


_LIB = None


def _kernel():
    """The built K2/K3 library, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from gulon_tpu_torch.ops.cuda import _build

        lib = _build.load("dense_scan")
        for fn in (lib.gulon_dense_scan_bf16, lib.gulon_dense_scan_i8):
            fn.argtypes = (
                [ctypes.c_void_p] * 3  # data, queries, out
                + [ctypes.c_int] * 3  # n, num_q, dp
                + [ctypes.c_void_p]  # stream
            )
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _launch(name: str, data, q_op, out_dtype) -> torch.Tensor:
    data, q_op = data.contiguous(), q_op.contiguous()
    for t in (data, q_op):
        if t.data_ptr() % 16:  # a TMA tensor map needs a 16-byte-aligned base
            raise ValueError("operands must be 16-byte aligned")
    n, dp = data.shape
    num_q = q_op.shape[0]
    lib = _kernel()
    with torch.cuda.device(data.device):
        out = torch.empty(
            (num_q, -(-n // _LANES)), dtype=out_dtype, device=data.device
        )
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            data.data_ptr(), q_op.data_ptr(), out.data_ptr(), n, num_q, dp,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    return out


def dense_block_scan(data: torch.Tensor, q_op: torch.Tensor) -> torch.Tensor:
    """Packed block winners ``[Q, ceil(N/128)]`` f32 of K2.

    CUDA tensors launch the kernel on the current stream (or raise); CPU
    tensors take :func:`_dense_block_scan_plain`. Operands as it
    documents. Each launch adds one to the counter ``k2.launches``
    (``utils/tracing.py``)."""
    _check_operands(data, q_op, torch.bfloat16, 8)
    if not data.is_cuda:
        return _dense_block_scan_plain(data, q_op)
    out = _launch("gulon_dense_scan_bf16", data, q_op, torch.float32)
    tracing.count("k2.launches")
    return out


def dense_block_scan_i8(data_i8: torch.Tensor, q_i8: torch.Tensor) -> torch.Tensor:
    """Packed block winners ``[Q, ceil(N/128)]`` int32 of K3.

    CUDA tensors launch the kernel on the current stream (or raise); CPU
    tensors take :func:`_dense_block_scan_plain_i8`. Each launch adds one
    to the counter ``k3.launches``."""
    _check_operands(data_i8, q_i8, torch.int8, 32)
    if not data_i8.is_cuda:
        return _dense_block_scan_plain_i8(data_i8, q_i8)
    out = _launch("gulon_dense_scan_i8", data_i8, q_i8, torch.int32)
    tracing.count("k3.launches")
    return out


def _check_k(k: int, n: int) -> int:
    kk = min(k, n)
    if kk > _LANES:
        raise ValueError(f"dense kernel supports k <= 128, got {k}")
    if n < 256 * kk:
        raise ValueError(
            f"dense kernel needs n >= 256*k rows (n={n}, k={kk}); use "
            "the exact_scan for small corpora"
        )
    return kk


def _fetch(kk: int, rescore: int, nb: int) -> int:
    return min(max(kk, rescore * kk if rescore else kk), _LANES, nb)


def _bmm_highest(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``[Q, F, D] . [Q, D] -> [Q, F]`` in full f32."""
    return matmul(rows, q[:, :, None], "highest")[..., 0]


def _pad_k(best_d, best_ids, k: int, kk: int):
    if kk < k:
        best_d = torch.nn.functional.pad(best_d, (0, k - kk), value=float("inf"))
        best_ids = torch.nn.functional.pad(best_ids, (0, k - kk), value=-1)
    return best_d, best_ids


def _rerank(exact, best_ids, invalid, kk: int):
    exact = torch.where(invalid, float("inf"), exact)
    best_d, pos2 = smallest_k_nan_last(exact, kk)
    best_ids = torch.gather(torch.where(invalid, -1, best_ids), 1, pos2.long())
    return best_d, best_ids


def dense_scan_fused(
    queries: torch.Tensor,  # [Q, D] f32
    data: torch.Tensor,  # [N, Dp] bf16 (prepare_data layout)
    norms: torch.Tensor,  # [N] f32 = ||x||^2 (exact-rescore term)
    *,
    k: int,
    tile_rows: int = 0,  # validated; the answer does not depend on it
    rescore_rows: Optional[torch.Tensor] = None,  # [N, D] f32: exact rescore
    rescore: int = 0,  # >0: over-fetch rescore*k block winners, re-rank
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused exact scan through K2 (counterpart of ``dense_scan_pallas``).
    Returns ([Q, k] squared-L2 ascending, [Q, k] int32 row ids)."""
    num_q, d = queries.shape
    n, dp = data.shape
    if dp != padded_dim(d):
        raise ValueError(
            f"data trailing dim must be padded_dim(D) = {padded_dim(d)} "
            f"(D data lanes + 2 norm lanes, 8-aligned), got {dp}"
        )
    kk = _check_k(k, n)
    _check_tile_rows(tile_rows)
    dev = queries.device
    q_aug = torch.cat(
        [
            -2.0 * queries,
            torch.zeros((num_q, dp - d - 2), dtype=queries.dtype, device=dev),
            torch.ones((num_q, 2), dtype=queries.dtype, device=dev),
        ],
        dim=1,
    )
    q_bf = q_aug.to(torch.bfloat16)
    packed = dense_block_scan(data, q_bf)

    # strip the lane bits first and rank with an exact top-k: equal
    # scores keep the lowest column = block = earliest rows
    bits_all = packed.view(torch.int32)
    vals_all = (bits_all & ~127).view(torch.float32)
    best_v, pos = smallest_k_nan_last(vals_all, _fetch(kk, rescore, packed.shape[1]))
    pos = pos.long()
    best_ids = pos.to(torch.int32) * _LANES + torch.gather(bits_all & 127, 1, pos)
    invalid = best_v >= _INVALID_MIN
    qn = sq_norms(queries)
    if rescore:
        safe = torch.where(invalid, 0, best_ids).long()
        if rescore_rows is not None:
            # exact f32 re-rank: ||x||^2 + ||q||^2 - 2<x, q>
            exact = norms[safe] + qn[:, None] - 2.0 * _bmm_highest(
                rescore_rows[safe].to(torch.float32), queries
            )
        else:
            # from the bf16 operand: its norm lanes make rows . q_aug =
            # ||x||^2 - 2<x, q> (bf16 products are exact in f32)
            exact = _bmm_highest(
                data[safe].to(torch.float32), q_bf.to(torch.float32)
            ) + qn[:, None]
        best_d, best_ids = _rerank(exact, best_ids, invalid, kk)
    else:
        best_d = torch.where(invalid, float("inf"), best_v + qn[:, None])[:, :kk]
        best_ids = torch.where(invalid, -1, best_ids)[:, :kk]
    return _pad_k(best_d, best_ids, k, kk)


def dense_scan_fused_i8(
    queries: torch.Tensor,  # [Q, D] f32
    data_i8: torch.Tensor,  # [N, Dp] int8 (prepare_data_i8 layout)
    meta: DenseI8Meta,
    norms: torch.Tensor,  # [N] f32 (exact-rescore term)
    *,
    k: int,
    tile_rows: int = 0,  # validated; the answer does not depend on it
    rescore_rows: Optional[torch.Tensor] = None,  # [N, D]: exact re-rank rows
    rescore: int = 0,  # >0: over-fetch rescore*k winners and re-rank
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused exact scan over the int8 operand through K3 (counterpart of
    ``dense_scan_pallas_i8``). Without ``rescore`` the distances are the
    dequantized kernel scores; with it, re-ranked from ``rescore_rows`` or
    from the dequantized int8 rows and their own norms."""
    num_q, d = queries.shape
    n, dp = data_i8.shape
    if d != meta.d or dp != meta.dp:
        raise ValueError(
            f"operand/meta mismatch: data {(n, dp)}, queries D={d}, "
            f"meta (d={meta.d}, dp={meta.dp})"
        )
    kk = _check_k(k, n)
    _check_tile_rows(tile_rows)
    dev = queries.device
    qf = queries.to(torch.float32)
    qi = torch.clamp(torch.round(-qf / (meta.scale * meta.gain)), -127, 127)
    q_aug = torch.cat(
        [
            qi,
            torch.zeros((num_q, dp - d - 2), dtype=torch.float32, device=dev),
            torch.full((num_q, 1), 127.0, dtype=torch.float32, device=dev),
            torch.ones((num_q, 1), dtype=torch.float32, device=dev),
        ],
        dim=1,
    ).to(torch.int8)
    packed = dense_block_scan_i8(data_i8, q_aug)  # [Q, NB] int32

    vals_all = packed & ~127
    best_v, pos = smallest_k_nan_last(vals_all, _fetch(kk, rescore, packed.shape[1]))
    pos = pos.long()
    best_ids = pos.to(torch.int32) * _LANES + torch.gather(packed & 127, 1, pos)
    invalid = best_ids >= n  # padding rows (no sentinel range in int32)
    qn = sq_norms(qf)
    if rescore:
        safe = torch.where(invalid, 0, best_ids).long()
        if rescore_rows is not None:
            rows = rescore_rows[safe].to(torch.float32)  # [Q, F, D]
            row_norms = norms[safe]
        else:
            rows = data_i8[safe][..., :d].to(torch.float32) * meta.scale
            # norms of the DEQUANTIZED rows: the distance reported is then
            # exactly ||q - dequant(x)||^2 (within f32 rounding)
            row_norms = torch.sum(rows * rows, dim=2)
        exact = row_norms + qn[:, None] - 2.0 * _bmm_highest(rows, qf)
        best_d, best_ids = _rerank(exact, best_ids, invalid, kk)
    else:
        unit = float(np.float32(2.0 * meta.scale * meta.scale * meta.gain))
        nmean = float(np.float32(meta.nmean))
        raw = best_v.to(torch.float32) * unit + qn[:, None] + nmean
        best_d = torch.where(invalid, float("inf"), raw)[:, :kk]
        best_ids = torch.where(invalid, -1, best_ids)[:, :kk]
    return _pad_k(best_d, best_ids, k, kk)
