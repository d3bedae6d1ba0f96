"""The IVF winner selection: the ``fetch`` smallest of K1's block winners
over the columns of each query's probed partitions.

The kernel (``csrc/ivf_topk.cu``) replaces no TPU kernel: the JAX
package's IVF ``pallas`` epilogue masks every winner column with the
probe and ranks them with ``lax.top_k``. Its plain twin here,
:func:`_select_plain`, gathers each query's probed columns in column
order and runs the same stable sort; CPU tensors take it, CUDA tensors
launch the kernel or raise (:func:`ivf_select`).

Both return, per query, what the IVF route ranked first when it sorted
every column (``models/ivf.py::_pallas_ivf_query``): every winner column
with its key ``(v + group_term[q, p]) + qn[q]`` where the column's
partition ``p`` is probed and ``v = bits & ~127`` is below
``_INVALID_MIN``, +inf elsewhere, sorted stably (NaN after +inf), cut
to ``fetch``. A partition owns a contiguous range of 128-row blocks of
the partition-padded layout (``ranges``); blocks past ``real_blocks``
are padding and belong where that sort's clamp put them,
``blk_part[min(b, nbp - 1)]``. Where a position holds +inf the column
is that of a probed +inf key, or -1 for one of the unprobed columns:
the epilogue reads no id there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from gulon_tpu_torch.ops.cuda.adc import _INVALID_MIN, _winner_blocks
from gulon_tpu_torch.ops.topk import smallest_k_nan_last
from gulon_tpu_torch.utils import tracing

_INF = float("inf")
_LIB = None


def _kernel():
    """The built selection library, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from gulon_tpu_torch.ops.cuda import _build

        lib = _build.load("ivf_topk")
        fn = lib.gulon_ivf_topk
        fn.argtypes = (
            [ctypes.c_void_p] * 9  # packed gt qn mask ranges blk_part best cols scratch
            + [ctypes.c_int] * 8  # num_q num_p nw winners nblk fetch real_blocks nbp
            + [ctypes.c_void_p]  # stream
        )
        fn.restype = ctypes.c_int
        fn = lib.gulon_ivf_topk_plan
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=64)
def topk_plan(fetch: int) -> dict:
    """The kernel's candidate buffer at this ``fetch``, as its own plan
    function gives it: ``cap`` keys a query, ``shared`` 1 in shared
    memory, 0 in a global scratch slice the launch allocates."""
    out = (ctypes.c_int * 2)()
    err = _kernel().gulon_ivf_topk_plan(fetch, out)
    if err != 0:
        raise RuntimeError(f"no ivf_topk plan for fetch={fetch}: cudaError_t {err}")
    return dict(cap=out[0], shared=out[1])


def column_partitions(
    ranges: torch.Tensor, blk_part: torch.Tensor, real_blocks: int, num_cols: int,
    winners: int, nblk: int,
) -> torch.Tensor:
    """``[num_cols]`` int64: the partition of each winner column's block,
    from the block-range table on the real blocks and from ``blk_part``'s
    clamp past them."""
    dev = ranges.device
    b0, nb = ranges[:, 0].long(), (ranges[:, 1] - ranges[:, 0]).long()
    nbc = num_cols // winners
    block_part = blk_part[torch.clamp(torch.arange(nbc, device=dev), max=blk_part.shape[0] - 1)]
    owned = (torch.repeat_interleave(b0 - (torch.cumsum(nb, 0) - nb), nb, output_size=real_blocks)
             + torch.arange(real_blocks, device=dev))
    block_part[owned] = torch.repeat_interleave(
        torch.arange(ranges.shape[0], device=dev), nb, output_size=real_blocks)
    blocks, _ = _winner_blocks(num_cols, winners, nblk, dev)
    return block_part[blocks]


def _select_plain(
    packed, group_term, qn, probe_mask, ranges, blk_part, real_blocks: int, *,
    winners: int, nblk: int, fetch: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on the same operands: each
    query's probed columns gathered in column order, their keys by the
    route's arithmetic, one stable sort, then the unprobed columns'
    +inf placed before the NaN keys, as a sort over every column ranks
    them."""
    num_q, nw = packed.shape
    dev = packed.device
    col_part = column_partitions(ranges, blk_part, real_blocks, nw, winners, nblk)
    probed = probe_mask[:, col_part]  # [Q, NW]
    n_probed = probed.sum(dim=1)
    cmax = int(n_probed.max()) if num_q else 0
    # the probed columns of each query in column order; nw past them
    cols = torch.full((num_q, cmax + 1), nw, dtype=torch.int64, device=dev)
    at = torch.cumsum(probed, dim=1) - 1
    qi, ci = torch.nonzero(probed, as_tuple=True)
    cols[qi, at[qi, ci]] = ci
    real = cols < nw
    safe = torch.clamp(cols, max=nw - 1)
    bits = torch.gather(packed.view(torch.int32), 1, safe)
    v = (bits & ~127).view(torch.float32)
    g = torch.gather(group_term, 1, col_part[safe])
    keys = torch.where(v < _INVALID_MIN, v + g + qn[:, None], _INF)
    # after every real key, NaN ones too: a sort on the card ranks NaNs by
    # their bits, and these are the largest, the canonical NaN's
    keys = torch.where(real, keys, torch.tensor(0x7FFFFFFF, dtype=torch.int32,
                                                device=dev).view(torch.float32))
    vals, pos = smallest_k_nan_last(keys, cmax + 1)
    scols = torch.gather(cols, 1, pos.long())
    n_lo = (real & ~torch.isnan(keys)).sum(dim=1, keepdim=True)
    unprobed = nw - n_probed[:, None]
    i = torch.arange(fetch, device=dev)[None, :]
    src = torch.where(i < n_lo, i, torch.where(i < n_lo + unprobed, -1, i - unprobed))
    src = torch.where((src < 0) | (src >= n_probed[:, None]), cmax, src)
    vals[:, cmax], scols[:, cmax] = _INF, -1
    return torch.gather(vals, 1, src), torch.gather(scols, 1, src).to(torch.int32)


def _check(packed, group_term, qn, probe_mask, ranges, blk_part, winners, nblk, fetch):
    num_q, nw = packed.shape
    num_p = group_term.shape[1]
    if packed.dtype != torch.float32 or group_term.dtype != torch.float32 or qn.dtype != torch.float32:
        raise ValueError("packed winners, group terms and query norms must be f32")
    if group_term.shape != (num_q, num_p) or qn.shape != (num_q,):
        raise ValueError(f"group_term must be [{num_q}, P] and qn [{num_q}]")
    if probe_mask.shape != (num_q, num_p) or probe_mask.dtype != torch.bool:
        raise ValueError(f"probe_mask must be [{num_q}, {num_p}] bool")
    if ranges.shape != (num_p, 2) or ranges.dtype != torch.int32:
        raise ValueError(f"ranges must be [{num_p}, 2] int32")
    if blk_part.dim() != 1 or blk_part.dtype != torch.int64 or blk_part.shape[0] == 0:
        raise ValueError("blk_part must be a non-empty [NBP] int64")
    if not 1 <= winners <= 4 or nblk < 1 or nw % (winners * nblk):
        raise ValueError(f"{nw} columns are no whole row tiles of {winners} x {nblk} blocks")
    if not 0 <= fetch <= nw:
        raise ValueError(f"fetch must be in 0..{nw}, got {fetch}")


def ivf_select(
    packed: torch.Tensor,  # [Q, NW] f32 K1's lane-packed winners
    group_term: torch.Tensor,  # [Q, P] f32
    qn: torch.Tensor,  # [Q] f32
    probe_mask: torch.Tensor,  # [Q, P] bool
    ranges: torch.Tensor,  # [P, 2] int32 block range [b0, b1) of each partition
    blk_part: torch.Tensor,  # [NBP] int64 partition of each layout block
    real_blocks: int,  # the blocks the ranges cover; past them padding
    *,
    winners: int,
    nblk: int,
    fetch: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(best [Q, fetch] f32, column [Q, fetch] int32)``: the module's
    selection. CUDA tensors launch the kernel on the current stream (one
    ``ivf.topk.launches`` each) or raise; CPU tensors take
    :func:`_select_plain`."""
    tensors = (packed, group_term, qn, probe_mask, ranges, blk_part)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands must share one device, got {devices}")
    _check(packed, group_term, qn, probe_mask, ranges, blk_part, winners, nblk, fetch)
    if not packed.is_cuda:
        return _select_plain(packed, group_term, qn, probe_mask, ranges, blk_part, real_blocks,
                             winners=winners, nblk=nblk, fetch=fetch)
    num_q, nw = packed.shape
    dev = packed.device
    best = torch.empty((num_q, fetch), dtype=torch.float32, device=dev)
    cols = torch.empty((num_q, fetch), dtype=torch.int32, device=dev)
    if num_q == 0 or fetch == 0:
        return best, cols
    packed, group_term, qn, probe_mask, ranges, blk_part = (t.contiguous() for t in tensors)
    plan = topk_plan(fetch)
    scratch = None if plan["shared"] else torch.empty(
        (num_q, plan["cap"]), dtype=torch.int64, device=dev)
    lib = _kernel()
    with torch.cuda.device(dev):
        err = lib.gulon_ivf_topk(
            packed.data_ptr(), group_term.data_ptr(), qn.data_ptr(), probe_mask.data_ptr(),
            ranges.data_ptr(), blk_part.data_ptr(), best.data_ptr(), cols.data_ptr(),
            None if scratch is None else scratch.data_ptr(), num_q, group_term.shape[1], nw,
            winners, nblk, fetch, real_blocks, blk_part.shape[0],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ivf_topk kernel launch failed: cudaError_t {err}")
    tracing.count("ivf.topk.launches")
    return best, cols
