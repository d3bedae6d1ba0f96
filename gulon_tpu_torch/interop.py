"""Carry an index's arrays across from numpy or from the JAX package.

``from_reference`` reads a ``gulon_tpu`` ``FlatIndex``, ``ExactIndex`` or
``IVFIndex`` by duck typing (``np.asarray`` on its arrays) and never
imports jax, so the port serves exactly the arrays the JAX index serves.
"""

from __future__ import annotations

import numpy as np
import torch

from gulon_tpu_torch.models.keyindex import GroupedKeyIndex, SortedKeyIndex
from gulon_tpu_torch.models.metric import Metric
from gulon_tpu_torch.models.exact import ExactIndex
from gulon_tpu_torch.models.flat import FlatIndex
from gulon_tpu_torch.models.ivf import IVFIndex, LimitGroups, LimitVectors
from gulon_tpu_torch.ops.cuda.dense import DenseI8Meta
from gulon_tpu_torch.ops.pq import ProductQuantizer, code_dtype
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE

# serving knobs copied from a reference index, so both compute alike
_KNOBS = (
    "scan_strategy", "tile_rows", "precision", "topk_impl", "recall_target",
    "rerank_factor", "pallas_winners",
)
_IVF_KNOBS = (
    "scan_strategy", "tile_rows", "precision", "topk_impl", "recall_target",
    "pallas_winners", "pallas_rescore",
)
_EXACT_KNOBS = (
    "scan_strategy", "tile_rows", "precision", "topk_impl", "recall_target",
    "rescore_factor", "exact_rescore", "operand",
)


def flat_index_from_numpy(
    keys,
    codebooks,
    bounds,
    num_clusters: int,
    codes,
    recon_norms,
    metric: Metric = Metric.L2,
    *,
    device=DEFAULT_DEVICE,
) -> FlatIndex:
    """A ``FlatIndex`` over given arrays: ``keys`` globally sorted,
    ``codebooks [m, K, dsub]`` f32, ``codes [N, m]``, ``recon_norms [N]``."""
    keys = np.asarray(keys, dtype=object)
    codes = np.asarray(codes)
    if codes.ndim != 2 or len(codes) != len(keys):
        raise ValueError(
            f"codes must be [{len(keys)}, m], got {codes.shape}"
        )
    return FlatIndex(
        _key_index=SortedKeyIndex(keys),
        pq=_pq_from_numpy(codebooks, bounds, num_clusters, device),
        codes=_codes_tensor(codes, num_clusters, device),
        recon_norms=torch.from_numpy(np.array(recon_norms, np.float32)).to(device),
        metric=metric,
    )


def _pq_from_numpy(codebooks, bounds, num_clusters, device) -> ProductQuantizer:
    return ProductQuantizer(
        codebooks=torch.from_numpy(np.array(codebooks, np.float32)).to(device),
        bounds=tuple((int(s), int(w)) for s, w in bounds),
        num_clusters=int(num_clusters),
    )


def _codes_tensor(codes: np.ndarray, num_clusters: int, device) -> torch.Tensor:
    return torch.from_numpy(codes.astype(np.int64)).to(
        device=device, dtype=code_dtype(num_clusters)
    )


def ivf_index_from_numpy(
    keys,
    group_offsets,
    codebooks,
    bounds,
    num_clusters: int,
    codes,
    row_const,
    group_ids,
    centroids,
    metric: Metric = Metric.L2,
    strategy=None,
    *,
    device=DEFAULT_DEVICE,
) -> IVFIndex:
    """An ``IVFIndex`` over given arrays in grouped row order: ``keys``
    sorted within each group, ``group_offsets`` the internal group
    boundaries, residual ``codebooks [m, K, dsub]`` f32, ``codes [N, m]``,
    ``row_const [N]``, ``group_ids [N]``, ``centroids [P, D]``;
    ``strategy`` defaults to ``LimitGroups(max(0.05 * P, 5))``."""
    keys = np.asarray(keys, dtype=object)
    codes = np.asarray(codes)
    cents = np.array(centroids, np.float32)
    if codes.ndim != 2 or len(codes) != len(keys):
        raise ValueError(f"codes must be [{len(keys)}, m], got {codes.shape}")
    if strategy is None:
        strategy = LimitGroups(max(int(0.05 * len(cents)), 5))
    return IVFIndex(
        _key_index=GroupedKeyIndex(keys, group_offsets),
        pq=_pq_from_numpy(codebooks, bounds, num_clusters, device),
        codes=_codes_tensor(codes, num_clusters, device),
        row_const=torch.from_numpy(np.array(row_const, np.float32)).to(device),
        group_ids=torch.from_numpy(np.array(group_ids, np.int32)).to(device),
        centroids=torch.from_numpy(cents).to(device),
        metric=metric,
        strategy=strategy,
    )


def _rotation_tensor(ref, device):
    rotation = getattr(ref, "rotation", None)
    if rotation is None:
        return None
    return torch.from_numpy(np.array(rotation, np.float32)).to(device)


def _ivf_from_reference(ref, device) -> IVFIndex:
    # the JAX strategy classes live in a jax-importing module: map by
    # their proto value (LIMIT_GROUPS=0, LIMIT_VECTORS=2) and count
    kind = {0: LimitGroups, 2: LimitVectors}[ref.strategy.proto_value]
    index = ivf_index_from_numpy(
        ref.key_index.keys,
        ref.key_index.group_offsets,
        np.asarray(ref.pq.codebooks),
        ref.pq.bounds,
        ref.pq.num_clusters,
        np.asarray(ref.codes),
        np.asarray(ref.row_const),
        np.asarray(ref.group_ids),
        np.asarray(ref.centroids),
        Metric(ref.metric.value),
        kind(int(ref.strategy.count)),
        device=device,
    )
    for name in _IVF_KNOBS:
        setattr(index, name, getattr(ref, name))
    index.rotation = _rotation_tensor(ref, device)
    cache = getattr(ref, "recon_cache", None)
    if cache is not None:
        bf16 = str(cache.dtype) == "bfloat16"
        index.enable_cache(torch.bfloat16 if bf16 else torch.float32)
    return index


def exact_index_from_numpy(
    keys, vectors, metric: Metric = Metric.L2, *, device=DEFAULT_DEVICE
) -> ExactIndex:
    """An ``ExactIndex`` over given arrays: ``keys`` globally sorted,
    ``vectors [N, D]`` in key order (already normalized for Cosine)."""
    keys = np.asarray(keys, dtype=object)
    x = np.array(vectors, np.float32)  # a writable copy the tensor owns
    if x.ndim != 2 or len(x) != len(keys):
        raise ValueError(f"vectors must be [{len(keys)}, D], got {x.shape}")
    return ExactIndex(
        _key_index=SortedKeyIndex(keys),
        vectors=torch.from_numpy(x).to(device),
        metric=metric,
    )


def _exact_from_reference(ref, device, prepared_i8) -> ExactIndex:
    index = exact_index_from_numpy(
        ref.key_index.keys, np.asarray(ref.vectors), Metric(ref.metric.value),
        device=device,
    )
    for name in _EXACT_KNOBS:
        setattr(index, name, getattr(ref, name))
    if prepared_i8 is not None:
        data_i8, meta = prepared_i8
        index._data_i8 = (
            torch.from_numpy(np.array(data_i8, np.int8)).to(device),
            DenseI8Meta(meta.scale, meta.nmean, meta.d, meta.dp, meta.gain),
        )
    return index


def from_reference(jax_index, *, device=DEFAULT_DEVICE, prepared_i8=None):
    """The port's ``FlatIndex``, ``ExactIndex`` or ``IVFIndex`` over a
    ``gulon_tpu`` index's arrays and serving knobs. An exact index is
    recognised by having ``vectors`` and no ``pq``; ``prepared_i8=(data_i8,
    meta)`` then hands it an int8 operand prepared by the JAX package,
    which it serves unchanged. An IVF index is recognised by ``centroids``
    and ``group_ids``; its strategy carries across by kind and count. A
    flat or IVF index with a decoded cache gets its cache rebuilt (the
    decode is exact) in the same dtype; an OPQ rotation carries across, and
    so do packed codes (``pack_memory``): the bytes and ``packed_width``,
    one layout in both packages."""
    ref = jax_index
    if hasattr(ref, "vectors") and not hasattr(ref, "pq"):
        return _exact_from_reference(ref, device, prepared_i8)
    if prepared_i8 is not None:
        raise ValueError("prepared_i8 applies to an exact index only")
    if hasattr(ref, "centroids") and hasattr(ref, "group_ids"):
        return _ivf_from_reference(ref, device)
    index = flat_index_from_numpy(
        ref.key_index.keys,
        np.asarray(ref.pq.codebooks),
        ref.pq.bounds,
        ref.pq.num_clusters,
        np.asarray(ref.codes),
        np.asarray(ref.recon_norms),
        Metric(ref.metric.value),
        device=device,
    )
    for name in _KNOBS:
        setattr(index, name, getattr(ref, name))
    index.packed_width = int(getattr(ref, "packed_width", 0))
    index.rotation = _rotation_tensor(ref, device)
    cache = getattr(ref, "decoded_cache", None)
    if cache is not None or getattr(ref, "_cache_aug", None) is not None:
        bf16 = cache is None or str(cache.dtype) == "bfloat16"
        index.enable_cache(torch.bfloat16 if bf16 else torch.float32)
    return index
