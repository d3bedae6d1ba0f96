"""Flat index builder (counterpart of ``gulon_tpu/models/build.py``,
``BuildIndex.scala:84-93``): sort keys -> train PQ -> chunked encode ->
reconstruction norms -> ``FlatIndex``, on an explicit ``device``.

OPQ rotations, mesh (multi-device) builds and the IVF builder come with
later slices of the port.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gulon_tpu.models.keyindex import SortedKeyIndex
from gulon_tpu.models.metric import Metric
from gulon_tpu_torch.models.flat import FlatIndex
from gulon_tpu_torch.ops.pq import PQConfig, ProductQuantizer, train_product_quantizer

_DEFAULT_ENCODE_CHUNK = 1 << 20


def _normalize_np(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return np.where(norms > 0, x / np.where(norms > 0, norms, 1.0), x)


def _encode_chunked(
    pq: ProductQuantizer, x: np.ndarray, chunk: int
) -> torch.Tensor:
    """Encode host rows ``chunk`` at a time on the quantizer's device;
    the codes stay there."""
    parts = [pq.encode(x[start : start + chunk]) for start in range(0, len(x), chunk)]
    if not parts:
        return torch.zeros(
            (0, pq.num_quantizers), dtype=pq.dtype_codes, device=pq.device
        )
    return torch.cat(parts, dim=0)


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
    device="cpu",
) -> FlatIndex:
    """Linear build: sort -> PQ train -> encode (``BuildIndex.scala:84-93``).

    ``vectors`` is host data (numpy or nested lists); training sample,
    codes and norms live on ``device``."""
    if opq_iters > 0:
        raise NotImplementedError(
            "OPQ rotations (opq_iters > 0) come with a later slice of the "
            "PyTorch port"
        )
    if mesh is not None:
        raise NotImplementedError(
            "mesh builds come with the parallel slice of the PyTorch port"
        )
    x = np.asarray(vectors, np.float32)
    keys = np.asarray(keys, dtype=object)
    if len(keys) != len(x):
        raise ValueError("keys and vectors must have equal length")
    if metric.normalized:
        x = _normalize_np(x)

    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    x = x[order]

    pq = train_product_quantizer(x, pq_config, report_fn, device=device)
    codes = _encode_chunked(pq, x, encode_chunk)
    recon_norms = pq.reconstruction_norms(codes)
    return FlatIndex(
        _key_index=SortedKeyIndex(keys),
        pq=pq,
        codes=codes,
        recon_norms=recon_norms,
        metric=metric,
    )
