"""Carry an index's arrays across from numpy or from the JAX package.

``from_reference`` reads a ``gulon_tpu`` ``FlatIndex`` by duck typing
(``np.asarray`` on its arrays) and never imports jax, so the port serves
exactly the codebooks, codes and norms the JAX index serves.
"""

from __future__ import annotations

import numpy as np
import torch

from gulon_tpu.models.keyindex import SortedKeyIndex
from gulon_tpu.models.metric import Metric
from gulon_tpu_torch.models.flat import FlatIndex
from gulon_tpu_torch.ops.pq import ProductQuantizer, code_dtype

# serving knobs copied from a reference index, so both compute alike
_KNOBS = (
    "scan_strategy", "tile_rows", "precision", "topk_impl", "recall_target",
    "rerank_factor", "pallas_winners",
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
    device="cpu",
) -> FlatIndex:
    """A ``FlatIndex`` over given arrays: ``keys`` globally sorted,
    ``codebooks [m, K, dsub]`` f32, ``codes [N, m]``, ``recon_norms [N]``."""
    keys = np.asarray(keys, dtype=object)
    codes = np.asarray(codes)
    if codes.ndim != 2 or len(codes) != len(keys):
        raise ValueError(
            f"codes must be [{len(keys)}, m], got {codes.shape}"
        )
    pq = ProductQuantizer(
        codebooks=torch.from_numpy(np.array(codebooks, np.float32)).to(device),
        bounds=tuple((int(s), int(w)) for s, w in bounds),
        num_clusters=int(num_clusters),
    )
    return FlatIndex(
        _key_index=SortedKeyIndex(keys),
        pq=pq,
        codes=torch.from_numpy(codes.astype(np.int64)).to(
            device=device, dtype=code_dtype(num_clusters)
        ),
        recon_norms=torch.from_numpy(np.array(recon_norms, np.float32)).to(device),
        metric=metric,
    )


def from_reference(jax_flat_index, *, device="cpu") -> FlatIndex:
    """The port's ``FlatIndex`` over a ``gulon_tpu`` ``FlatIndex``'s
    arrays and serving knobs. Packed codes and OPQ rotations come with
    later slices of the port."""
    ref = jax_flat_index
    if getattr(ref, "packed_width", 0):
        raise NotImplementedError(
            "packed codes (pack_memory) come with a later slice of the port"
        )
    if getattr(ref, "rotation", None) is not None:
        raise NotImplementedError(
            "OPQ rotations come with a later slice of the port"
        )
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
    return index
