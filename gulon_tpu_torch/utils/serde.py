"""Index files in the reference's protobuf format (counterpart of
``gulon_tpu/utils/serde.py``; reference ``Index.scala:147-207``,
``ProductQuantizer.scala:88-105``, ``EncodedMatrix.scala:38-51``).

- codebooks serialize per quantizer as (start_index, dimension,
  centroids), padding stripped;
- codes serialize quantizer-major: one ``bytes`` blob per subquantizer
  holding its code for every row, bit-packed at the storage width of
  ``ops/coder.py``;
- ``GroupedIndex.offsets`` are the internal group boundaries;
- an OPQ rotation rides the extension field 100 (absent for plain PQ, so
  those bytes stay the reference writer's).

The bytes are read and written by ``proto/index_wire.py``, which needs no
protobuf library; a file saved by either package loads in the other. The
derived arrays (reconstruction norms, IVF group ids and row constants)
are not on the wire: they are rebuilt on load, on ``device``.
``ExactIndex`` files are npz, told apart by their magic bytes.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

from gulon_tpu_torch.interop import _codes_tensor
from gulon_tpu_torch.models.exact import ExactIndex
from gulon_tpu_torch.models.flat import FlatIndex
from gulon_tpu_torch.models.ivf import IVFIndex, LimitGroups, LimitVectors
from gulon_tpu_torch.models.keyindex import GroupedKeyIndex, SortedKeyIndex
from gulon_tpu_torch.models.metric import Metric
from gulon_tpu_torch.ops import coder
from gulon_tpu_torch.ops.pq import ProductQuantizer
from gulon_tpu_torch.proto import index_wire as wire
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE

AnyIndex = Union[FlatIndex, IVFIndex]


def _pq_to_proto(pq: ProductQuantizer) -> wire.ProductQuantizer:
    cb = pq.codebooks.cpu().numpy()
    return wire.ProductQuantizer(
        num_clusters=pq.num_clusters,
        quantizers=[
            wire.Quantizer(
                start_index=start, dimension=width,
                centroids=[wire.FloatVector(row) for row in cb[s, :, :width]],
            )
            for s, (start, width) in enumerate(pq.bounds)
        ],
    )


def _pq_from_proto(msg: wire.ProductQuantizer, device) -> ProductQuantizer:
    bounds = tuple((q.start_index, q.dimension) for q in msg.quantizers)
    pad_width = max(w for _, w in bounds)
    k = msg.num_clusters
    cb = np.zeros((len(bounds), k, pad_width), np.float32)
    for s, q in enumerate(msg.quantizers):
        for j, cvec in enumerate(q.centroids):
            cb[s, j, : q.dimension] = cvec.values
    return ProductQuantizer(
        codebooks=torch.from_numpy(cb).to(device), bounds=bounds, num_clusters=k
    )


def _codes_to_proto(codes: np.ndarray, num_clusters: int) -> wire.EncodedMatrix:
    n, m = codes.shape
    logical = max(1, math.ceil(math.log2(num_clusters))) if num_clusters > 1 else 0
    width = coder.storage_width(logical)
    return wire.EncodedMatrix(
        code_width=width, length=n,
        encodings=[coder.pack(codes[:, s].astype(np.int64), width) for s in range(m)],
    )


def _codes_from_proto(msg: wire.EncodedMatrix) -> np.ndarray:
    n = msg.length
    cols = [coder.unpack(enc, n, msg.code_width) for enc in msg.encodings]
    return np.stack(cols, axis=1) if cols else np.zeros((n, 0), np.int32)


def _rotation_proto(rotation):
    if rotation is None:
        return None
    return wire.FloatVector(rotation.cpu().numpy().reshape(-1))


def _rotation_from_proto(msg, d: int, device):
    if msg is None or not len(msg.values):
        return None
    return torch.from_numpy(msg.values.reshape(d, d).copy()).to(device)


def index_to_proto(index: AnyIndex) -> wire.Index:
    # packed codes (pack_memory) are a serving layout only: the wire holds
    # the [N, m] codes (gulon_tpu/utils/serde.py:87-90)
    codes = index._unpacked_codes() if isinstance(index, FlatIndex) else index.codes
    pqi = wire.PQIndex(
        product_quantizer=_pq_to_proto(index.pq),
        data=_codes_to_proto(codes.cpu().numpy(), index.pq.num_clusters),
    )
    keys = [str(w) for w in index.key_index.keys]
    rotation = _rotation_proto(index.rotation)
    if isinstance(index, FlatIndex):
        return wire.Index(sorted=wire.SortedIndex(
            sorted_words=keys, vector_index=pqi,
            metric=index.metric.proto_value, rotation=rotation,
        ))
    if isinstance(index, IVFIndex):
        return wire.Index(grouped=wire.GroupedIndex(
            grouped_words=keys, vector_index=pqi,
            metric=index.metric.proto_value,
            centroids=[wire.FloatVector(row) for row in index.centroids.cpu().numpy()],
            offsets=[int(o) for o in np.asarray(index.key_index.group_offsets)],
            strategy=index.strategy.proto_value, limit=index.strategy.count,
            rotation=rotation,
        ))
    raise TypeError(f"cannot serialize {type(index)!r}")


def index_from_proto(msg: wire.Index, *, device=DEFAULT_DEVICE) -> AnyIndex:
    """The index a message holds, its arrays on ``device``; the derived
    arrays are rebuilt there."""
    which = msg.which()
    if which is None:
        raise ValueError("index proto has no implementation set")
    body = getattr(msg, which)
    pq = _pq_from_proto(body.vector_index.product_quantizer, device)
    codes_np = _codes_from_proto(body.vector_index.data)
    codes = _codes_tensor(codes_np, pq.num_clusters, device)
    rotation = _rotation_from_proto(body.rotation, pq.dimension, device)
    metric = Metric.from_proto(body.metric)
    if which == "sorted":
        return FlatIndex(
            _key_index=SortedKeyIndex(np.array(body.sorted_words, object)),
            pq=pq,
            codes=codes,
            recon_norms=pq.reconstruction_norms(codes),
            metric=metric,
            rotation=rotation,
        )
    offsets = np.asarray(body.offsets, np.int32)
    n = codes_np.shape[0]
    centroids = torch.from_numpy(
        np.stack([c.values for c in body.centroids]).astype(np.float32)
    ).to(device)
    bounds = np.concatenate([[0], offsets, [n]])
    group_ids = torch.from_numpy(
        np.repeat(np.arange(len(bounds) - 1, dtype=np.int32), np.diff(bounds))
    ).to(device)
    # the expanded-distance row term ||r^||^2 + 2<c_g, r^> by
    # per-partition LUT gathers, never decoding the corpus
    row_const = pq.reconstruction_norms(codes) + 2.0 * pq.centroid_code_dot(
        codes, centroids, group_ids
    )
    strategy_cls = LimitGroups if body.strategy == wire.LIMIT_GROUPS else LimitVectors
    return IVFIndex(
        _key_index=GroupedKeyIndex(np.array(body.grouped_words, object), offsets),
        pq=pq,
        codes=codes,
        row_const=row_const,
        group_ids=group_ids,
        centroids=centroids,
        metric=metric,
        strategy=strategy_cls(body.limit),
        rotation=rotation,
    )


def save_index(index, path) -> None:
    """Persist an index: PQ indices as reference-format protobuf,
    ``ExactIndex`` as npz (raw vectors have no reference wire format)."""
    if isinstance(index, ExactIndex):
        index.save(path)
        return
    data = index_to_proto(index).encode()
    with open(path, "wb") as f:
        f.write(data)


def load_index(path, *, device=DEFAULT_DEVICE):
    """Load an index file of either format, sniffed by its magic bytes:
    npz (zip, ``PK\\x03\\x04``) -> ``ExactIndex``, anything else ->
    protobuf. The index lives on ``device`` (default: the CUDA card, with
    no CPU fallback)."""
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == b"PK\x03\x04":
            return ExactIndex.load(f, device=device)
        blob = f.read()
    return index_from_proto(wire.Index.decode(blob), device=device)
