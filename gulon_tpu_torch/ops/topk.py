"""Top-k-smallest selection and merge (counterpart of ``gulon_tpu/ops/topk.py``).

``lax.top_k`` returns equal values lowest index first, and the epilogues
rely on it: ``finish_scan`` ranks block winners so that equal scores keep
the earliest rows, the reference heap's rule (``TopKHeap.scala:69-79``).
``torch.topk`` promises no order among ties, so selection here is a
stable sort, which ranks on (value, index).

``lax.top_k`` of the negated distances ranks on the IEEE total order:
``-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN``. ``smallest_k``
sorts on an integer key with that order, so a NaN distance ranks where
the JAX package ranks it (a positive NaN after every number and after
the ``+inf`` of an empty slot), not where ``torch.sort`` puts every NaN.
The kernels' epilogues rank with :func:`smallest_k_nan_last`, the plain
stable sort, which gives the same order on what they rank.

``approx_smallest_k`` is ``lax.approx_min_k`` as the JAX package runs it
off the TPU: a sort of the whole row on ``<``, under which a NaN compares
false with everything. A row whose every value is NaN then comes out in
the order libstdc++'s ``std::sort`` leaves a range of incomparable
elements; that order is a function of the row's length alone, and
:func:`incomparable_order` computes it. Other rows rank as ``smallest_k``
(equal values lowest index first, where ``std::sort`` promises nothing).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from gulon_tpu_torch.utils import tracing

# float dtype -> (integer dtype of its bits, magnitude mask)
_KEY_DTYPES = {
    torch.float64: (torch.int64, 0x7FFF_FFFF_FFFF_FFFF),
    torch.float32: (torch.int32, 0x7FFF_FFFF),
    torch.float16: (torch.int16, 0x7FFF),
    torch.bfloat16: (torch.int16, 0x7FFF),
}
_INSERTION_SORT = 16  # libstdc++'s _S_threshold


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Integers that order as ``x`` under the IEEE total order (integer
    tensors are their own key)."""
    if x.dtype not in _KEY_DTYPES:
        return x
    itype, mag = _KEY_DTYPES[x.dtype]
    bits = x.contiguous().view(itype)
    return bits ^ ((bits >> (bits.element_size() * 8 - 1)) & mag)


def smallest_k(dists: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest values (ascending, IEEE total order) and their int32
    indices along the last axis; among equal values the lowest index
    comes first."""
    _, idx = torch.sort(_total_order_key(dists), dim=-1, stable=True)
    idx = idx[..., :k]
    return torch.gather(dists, -1, idx), idx.to(torch.int32)


def smallest_k_nan_last(
    dists: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`smallest_k` on ``torch.sort``'s order, which puts a NaN of
    either sign after ``+inf``: one sort, no key. For the kernels'
    epilogues, whose block winners carry no sign of NaN or zero that
    the two orders rank apart (a NaN winner's lane bits are stripped
    before the sort, and an all-NaN row keeps its columns' order under
    both)."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


@functools.lru_cache(maxsize=64)
def incomparable_order(length: int, k: int) -> np.ndarray:
    """The first ``k`` positions of a range of ``length`` elements that
    all compare false with each other, after libstdc++'s ``std::sort``
    (introsort: median-of-three pivot moved to the front, unguarded
    partition, insertion sort below 16 elements). With every comparison
    false the median step swaps the front with the middle, the partition
    reverses the rest and cuts it in half, and the insertion sort moves
    nothing; only the parts that reach the first ``k`` positions are
    followed."""
    perm = np.arange(length, dtype=np.int64)

    def loop(lo: int, hi: int, depth: int) -> None:
        while hi - lo > _INSERTION_SORT:
            if depth == 0:  # halving cuts never exhaust 2 log2(n)
                raise AssertionError("introsort depth limit reached")
            depth -= 1
            mid = lo + (hi - lo) // 2
            perm[[lo, mid]] = perm[[mid, lo]]
            perm[lo + 1 : hi] = perm[lo + 1 : hi][::-1].copy()
            cut = lo + 1 + (hi - lo - 1) // 2
            if cut < k:
                loop(cut, hi, depth)
            hi = cut

    loop(0, length, 2 * max(length, 1).bit_length() - 2)
    return perm[:k].copy()


@functools.lru_cache(maxsize=64)
def _incomparable_order_on(length: int, k: int, device: torch.device) -> torch.Tensor:
    """:func:`incomparable_order` as an int32 tensor on ``device``, copied
    there once."""
    with tracing.span("gulon.wait.upload_order"):
        return torch.from_numpy(incomparable_order(length, k)).to(device, torch.int32)


def approx_smallest_k(
    dists: torch.Tensor, k: int, *, length: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.approx_min_k(dists, k)`` as the JAX package runs it on the
    CPU (module docstring): ``k`` must be positive; a row of NaN takes
    :func:`incomparable_order`; other rows rank as :func:`smallest_k`.
    ``length``: the row's length in the JAX package, when it pads the
    row past ``dists``' width (a scan's last tile, padded with rows that
    score +inf, or NaN where every row does); slots past the width then
    read ``(+inf, width)``, and a NaN row's positions may pass it, as
    the JAX package's padding rows do."""
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    width = dists.shape[-1]
    length = max(length, width)
    vals, pos = smallest_k(dists, min(k, width))
    if vals.shape[-1] < k:  # the padding rows' +inf
        vals = torch.nn.functional.pad(vals, (0, k - width), value=float("inf"))
        pos = torch.nn.functional.pad(pos, (0, k - width), value=width)
    order = _incomparable_order_on(length, k, dists.device).expand_as(pos)
    all_nan = torch.isnan(dists).all(dim=-1, keepdim=True)
    return (
        torch.where(all_nan, dists[..., :1], vals),
        torch.where(all_nan, order, pos),
    )


def merge_topk(
    dists_a: torch.Tensor,
    ids_a: torch.Tensor,
    dists_b: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (distance, id) candidate sets, keeping the k smallest."""
    dists = torch.cat([dists_a, dists_b], dim=-1)
    ids = torch.cat([ids_a, ids_b], dim=-1)
    vals, pos = smallest_k(dists, k)
    return vals, torch.gather(ids, -1, pos.long())
