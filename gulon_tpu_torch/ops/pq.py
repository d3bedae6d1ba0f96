"""Product quantization: per-subspace codebooks, trained together.

Counterpart of ``gulon_tpu/ops/pq.py`` (reference ``ProductQuantizer.scala``
and ``Vectors.scala``):

- the subspace split reproduces ``Vectors.subvectors``
  (``Vectors.scala:91-103``): with ``ideal = ceil(D/m)`` the first
  ``m - (ideal*m - D)`` subspaces get ``ideal`` dims, the rest ``ideal-1``;
- subspaces are zero-padded to one width and stacked ``[m, n, dsub]``,
  so all m codebooks train in one batched Lloyd loop; zero padding adds
  nothing to inner products or norms;
- encode is a blocked per-subspace argmin to an ``[n, m]`` code matrix,
  decode gathers codebook rows, and ``lut`` builds the ADC table
  ``||q_sub - c||^2`` for every (query, subspace, centroid).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gulon_tpu_torch.ops.distance import sq_norms
from gulon_tpu_torch.ops.kmeans import KMeansConfig, _assign_blocked, fit_kmeans
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.utils import tracing
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE


def subspace_bounds(dimension: int, num_quantizers: int) -> Tuple[Tuple[int, int], ...]:
    """(start, width) of each subspace; matches ``Vectors.scala:91-103``."""
    if not 0 < num_quantizers <= dimension:
        raise ValueError(f"need 0 < m={num_quantizers} <= d={dimension}")
    ideal = -(-dimension // num_quantizers)
    num_large = num_quantizers - (ideal * num_quantizers - dimension)
    bounds = []
    start = 0
    for i in range(num_quantizers):
        width = ideal if i < num_large else ideal - 1
        bounds.append((start, width))
        start += width
    assert start == dimension
    return tuple(bounds)


def code_dtype(num_clusters: int) -> torch.dtype:
    """Storage type of codes: uint8 up to 256 clusters, else int32.

    The JAX package stores 16-bit codes as uint16; torch's uint16 lacks
    most CUDA ops the scans need, so the port widens them to int32."""
    if num_clusters <= 256:
        return torch.uint8
    if num_clusters <= 65536:
        return torch.int32
    raise ValueError(f"num_clusters {num_clusters} > 65536 unsupported")


def code_width(num_clusters: int) -> int:
    """Logical bits per code: ``ceil(log2(k))`` (``ProductQuantizer.scala:11-16``)."""
    return max(0, math.ceil(math.log2(num_clusters))) if num_clusters > 1 else 0


def split_subspaces(x: torch.Tensor, bounds, pad_width: int) -> torch.Tensor:
    """``[n, D] -> [m, n, pad_width]`` zero-padded subspace stack."""
    n = x.shape[0]
    out = torch.zeros(
        (len(bounds), n, pad_width), dtype=x.dtype, device=x.device
    )
    for s, (start, width) in enumerate(bounds):
        out[s, :, :width] = x[:, start : start + width]
    return out


class PQConfig(NamedTuple):
    """Mirrors ``ProductQuantizer.Config`` (``ProductQuantizer.scala:107-111``);
    the same fields and defaults as ``gulon_tpu.ops.pq.PQConfig``, and
    ``encode_precision``."""

    num_clusters: int = 256
    num_quantizers: int = 25
    max_iters: int = 100
    seed: int = 0
    block_rows: int = 65536
    # the training's matmul precision, see ops/precision.py
    precision: str = "default"
    # optional row subsample for codebook training
    train_sample: Optional[int] = None
    # "sample" (uniform rows) or "kmeans++"
    init: str = "sample"
    # snap trained centroids to bf16-representable values: the fused
    # scan's operands are bf16, so its reconstruction points are then
    # exactly the codebook's
    snap_bf16: bool = True
    # the precision at which the trained quantizer assigns codes
    # (ProductQuantizer.encode_precision)
    encode_precision: str = "highest"


@dataclasses.dataclass(frozen=True)
class ProductQuantizer:
    """Trained PQ: padded stacked codebooks + subspace geometry."""

    codebooks: torch.Tensor  # [m, K, pad_width] f32, zero-padded
    bounds: Tuple[Tuple[int, int], ...]  # (start, width) per subspace
    num_clusters: int
    # the encode's matmul precision (PQConfig.encode_precision); a saved
    # index does not keep it, and loads at the default
    encode_precision: str = "highest"

    @property
    def num_quantizers(self) -> int:
        return len(self.bounds)

    @property
    def dimension(self) -> int:
        return sum(w for _, w in self.bounds)

    @property
    def pad_width(self) -> int:
        return int(self.codebooks.shape[2])

    @property
    def device(self) -> torch.device:
        return self.codebooks.device

    @property
    def dtype_codes(self) -> torch.dtype:
        return code_dtype(self.num_clusters)

    @property
    def code_bits(self) -> int:
        return code_width(self.num_clusters)

    def cnorms(self) -> torch.Tensor:
        """Squared norms of the codebook entries: ``[m, K]``."""
        return sq_norms(self.codebooks)

    def split(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor) and x.device == self.device:
            x = x.to(torch.float32)
        else:  # rows copied in from elsewhere: the copy waits for the stream
            with tracing.span("gulon.wait.upload_rows"):
                x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return split_subspaces(x, self.bounds, self.pad_width)

    def encode(
        self, x, block_rows: int = 65536, precision: Optional[str] = None
    ) -> torch.Tensor:
        """``[n, D] -> [n, m]`` nearest-codeword index per subspace, at
        ``precision`` or else the quantizer's ``encode_precision``, full f32
        by default: the reference's f32 argmin
        (``ProductQuantizer.scala:25-35``). Under TF32 a row can take a
        codeword farther than its nearest by about 5e-4 of ``||x_s||^2 +
        ||c||^2``; codes are assigned once, so the f32 product costs little."""
        xs = self.split(x)
        assigns = _assign_blocked(
            xs, self.codebooks, block_rows, precision or self.encode_precision
        )
        return assigns.T.to(self.dtype_codes)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """``[n, m] -> [n, D]`` reconstruction (``ProductQuantizer.scala:37-78``)."""
        codes = codes.long()
        parts = [
            self.codebooks[s, codes[:, s], :width]
            for s, (_, width) in enumerate(self.bounds)
        ]
        return torch.cat(parts, dim=1)

    def reconstruction_norms(self, codes: torch.Tensor) -> torch.Tensor:
        """``||decode(codes)||^2`` per row, ``[n]``, as a sum of codeword
        norms (the subspaces are orthogonal coordinate ranges)."""
        cn = self.cnorms()  # [m, K]
        codes = codes.long()
        m = cn.shape[0]
        return cn[torch.arange(m, device=cn.device)[None, :], codes].sum(dim=1)

    def lut(self, queries) -> torch.Tensor:
        """ADC lookup table ``[Q, m, K]`` of ``||q_sub - c||^2``."""
        return _lut(self.split(queries), self.codebooks)

    def centroid_code_dot(
        self, codes, centroids, group_ids, chunk_rows: int = 1 << 20
    ) -> torch.Tensor:
        """``<centroids[group_ids[i]], decode(codes[i])>`` per row: ``[n]``
        f32 on the quantizer's device.

        Computed without decoding the corpus: per-partition LUTs
        ``lut[p, m, K] = <centroid_p restricted to subspace m, codebook[m, K]>``
        for the partition range each row chunk touches, then
        ``sum_m lut[g_i, m, codes[i, m]]``. Assumes the grouped row layout
        (``group_ids`` nondecreasing), so a chunk's partition range stays
        narrow."""
        dev = self.device
        codes, centroids, gids = (
            a.to(dev) if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a)).to(dev)
            for a in (codes, centroids, group_ids)
        )
        gids = gids.long()
        cs = self.split(centroids)  # [m, P, dp]
        n = codes.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=dev)
        for start in range(0, n, chunk_rows):
            stop = min(start + chunk_rows, n)
            g = gids[start:stop]
            with tracing.span("gulon.wait.partition_range"):
                g0, g1 = int(g.min()), int(g.max()) + 1
            out[start:stop] = _centroid_code_dot_chunk(
                codes[start:stop], g - g0, cs[:, g0:g1], self.codebooks
            )
        return out


def _centroid_code_dot_chunk(
    codes: torch.Tensor,  # [R, m] codes
    gid_rel: torch.Tensor,  # [R] relative to the chunk's first partition
    cs_chunk: torch.Tensor,  # [m, Pc, dp] centroid subspace stack
    codebooks: torch.Tensor,  # [m, K, dp]
) -> torch.Tensor:
    lut = matmul(cs_chunk, codebooks.transpose(1, 2), "highest")  # [m, Pc, K]
    m = codes.shape[1]
    sub = torch.arange(m, device=codes.device)[None, :]
    return lut[sub, gid_rel[:, None], codes.long()].sum(dim=1)


def _lut(qs: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """``[m, Q, dp], [m, K, dp] -> [Q, m, K]`` at full f32."""
    qn = sq_norms(qs)  # [m, Q]
    cn = sq_norms(codebooks)  # [m, K]
    ip = matmul(qs, codebooks.transpose(1, 2), "highest")  # [m, Q, K]
    lut = qn[:, :, None] + cn[:, None, :] - 2.0 * ip
    return lut.permute(1, 0, 2)


def train_product_quantizer(
    x,
    config: PQConfig,
    report_fn=None,
    mesh=None,
    *,
    device=None,
    init_indices=None,
) -> ProductQuantizer:
    """Train per-subspace codebooks (``ProductQuantizer.scala:121-153``).

    Host (numpy) input is subsampled on the host with the same numpy
    draw as the JAX package (``gulon_tpu/ops/pq.py:318-321``), then moved
    to ``device`` (default: the CUDA card, with no CPU fallback); tensor
    input stays on its device (or moves to ``device`` when given) and is
    subsampled with a ``torch.Generator`` seeded by ``config.seed``.
    With ``mesh`` the codebooks train distributed over its devices
    (``parallel/ops.py::sharded_fit_kmeans``, no progress reports, as in
    the JAX package) and land on that same device. ``init_indices`` is
    passed on to the k-means.
    """
    from gulon_tpu_torch.parallel.mesh import check_mesh

    check_mesh(mesh)
    on_device = isinstance(x, torch.Tensor)
    if on_device:
        x = x.to(torch.float32)
        if device is not None:
            x = x.to(device)
    else:
        x = np.asarray(x, np.float32)
    n, d = x.shape
    bounds = subspace_bounds(d, config.num_quantizers)
    pad_width = max(w for _, w in bounds)

    train_x = x
    if config.train_sample is not None and config.train_sample < n:
        if on_device:
            gen = torch.Generator().manual_seed(config.seed)
            idx = torch.randperm(n, generator=gen)[: config.train_sample]
            train_x = x[torch.sort(idx).values.to(x.device)]
        else:
            rng = np.random.default_rng(config.seed)
            idx = rng.choice(n, size=config.train_sample, replace=False)
            train_x = x[np.sort(idx)]
    with tracing.span("gulon.wait.upload_train"):
        train_x = torch.as_tensor(
            train_x, dtype=torch.float32,
            device=x.device if on_device else (device or DEFAULT_DEVICE),
        )

    xs = split_subspaces(train_x, bounds, pad_width)
    kmeans_cfg = KMeansConfig(
        k=config.num_clusters,
        max_iters=config.max_iters,
        seed=config.seed,
        block_rows=config.block_rows,
        precision=config.precision,
        init=config.init,
    )
    if mesh is not None:
        from gulon_tpu_torch.parallel.ops import sharded_fit_kmeans

        res = sharded_fit_kmeans(xs, kmeans_cfg, mesh, init_indices=init_indices)
    else:
        res = fit_kmeans(xs, kmeans_cfg, report_fn, init_indices=init_indices)
    centroids = res.centroids.to(train_x.device)
    if config.snap_bf16:
        centroids = centroids.to(torch.bfloat16).to(torch.float32)
    return ProductQuantizer(
        codebooks=centroids, bounds=bounds, num_clusters=config.num_clusters,
        encode_precision=config.encode_precision,
    )
