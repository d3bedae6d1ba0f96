"""Lloyd's k-means with the PQ subspaces as a batch dimension.

Counterpart of ``gulon_tpu/ops/kmeans.py`` (reference ``KMeans.scala``):

- assignment is one batched product per row block and an argmin
  (``||c||^2 - 2<x,c>``, ``KMeans.scala:37-52``): the rows carry two
  lanes of ones and the centroids ``-2 c`` and ``||c||^2`` split in two,
  so the product is the score and each score tile is written once and
  read once; no ``[n, k]`` score matrix of the whole input is held;
- the centroid update sorts each subspace's rows by assignment (one
  stable sort) and sums each cluster's run of rows in a fixed order, the
  reference's segment sum (``gulon_tpu/ops/kmeans.py:154``) at about
  ``n d`` reads, not ``n k d`` multiply-adds: a fixed input gives the
  same bits on every run, on the card too (no float atomics); empty
  clusters become zero vectors (``KMeans.scala:198-226``);
- all m subspaces of a stacked ``[m, n, d]`` input train at once, and
  each stops at its own fixpoint ("assignment unchanged",
  ``KMeans.scala:149``): a converged subspace keeps its centroids and
  assignments while the others iterate.

The JAX version runs the loop inside ``lax.while_loop``; here it is a
Python loop that reads the ``done`` mask back once per iteration. The
init is a uniform row sample or k-means++ (D^2-weighted) seeding, both
drawn from ``torch.Generator``s.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gulon_tpu_torch.ops.distance import sq_norms
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.utils import tracing
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE


class KMeansConfig(NamedTuple):
    """Mirrors ``KMeans.Config`` (reference ``KMeans.scala:129-132``)."""

    k: int
    max_iters: int = 100
    seed: int = 0
    block_rows: int = 65536
    # matmul precision of the assignment, see ops/precision.py
    precision: str = "default"
    # "sample" = uniform rows with replacement; "kmeans++" = D^2-weighted
    init: str = "sample"


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # [m, k, d] (or [k, d] for unstacked input)
    assignments: torch.Tensor  # [m, n] int32 (or [n])
    iterations: int
    converged: torch.Tensor  # [m] bool (or scalar)


# the assignment's product has a depth (the d lanes and two of ||c||^2)
# and a width (the centroids) rounded up to this: rows of 32 bytes, which
# the tensor cores' loads and the score tile's stores want (on an H100,
# the product over 9,990 centroids took 1.8x the time of 9,992 at
# deep-image-96's coarse shape)
_ALIGN = 8
# the update sums a cluster's sorted rows in pieces of at most this many
# rows, each in row order, then the pieces in order
_PIECE_ROWS = 128
# the norm of a padding centroid: its score, above any real one
_PAD_NORM = 2.0 ** 100


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _score_centroids(centroids: torch.Tensor) -> torch.Tensor:
    """``[m, k, d] -> [m, k', w]``: ``-2 c``, then ``||c||^2`` as a part on
    the TF32 grid (its low 13 bits cleared) and the rest, then zeros; and
    padding centroids up to ``k'`` whose score is ``_PAD_NORM``. A row
    ``[x, 1, 1, 0...]`` times it is ``||c||^2 - 2<x,c>``: ``-2 c`` is on
    the grid ``c`` is on, and the norm keeps its f32 bits to within 2^-20
    of it under TF32 (the rest is at most 2^-10 of the norm)."""
    m, k, d = centroids.shape
    cn = sq_norms(centroids)
    hi = (cn.view(torch.int32) & -(1 << 13)).view(torch.float32)
    out = centroids.new_zeros((m, _aligned(k), _aligned(d + 2)))
    out[:, :k, :d] = -2.0 * centroids
    out[:, :k, d] = hi
    out[:, :k, d + 1] = cn - hi
    out[:, k:, d] = _PAD_NORM
    return out


def _assign_blocked(
    x: torch.Tensor, centroids: torch.Tensor, block: int,
    precision: str = "default",
) -> torch.Tensor:
    """Nearest centroid, tiled over rows: ``[m, n, d], [m, k, d] -> [m, n]``
    int32 (ties to the lowest centroid, as ``jnp.argmin``). Each block's
    scores are one batched product (:func:`_score_centroids`), at
    ``precision``; the padding centroids never win."""
    m, n, d = x.shape
    block = max(1, min(block, n))
    ct = _score_centroids(centroids.to(torch.float32)).transpose(1, 2)  # [m, w, k]
    xa = x.new_zeros((m, block, ct.shape[1]), dtype=torch.float32)
    xa[:, :, d : d + 2] = 1.0
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    for start in range(0, n, block):
        rows = min(block, n - start)
        xa[:, :rows, :d] = x[:, start : start + rows]
        out[:, start : start + rows] = torch.argmin(matmul(xa[:, :rows], ct, precision), dim=-1)
    return out


def _ordered_segment_sum(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``[S, d]`` sums of the consecutive runs of ``rows`` ``[R, d]``, run
    ``s`` being ``lengths[s]`` rows (the lengths add up to ``R``).

    Each run is summed in pieces of ``_PIECE_ROWS`` rows, each piece in
    row order, then its pieces in order (``torch.segment_reduce``: a
    thread a piece and lane): the order of addition depends on the
    lengths alone, and nothing is read back to the host. The piece count
    is padded to a bound known on the host, the spare pieces empty and
    the last run's."""
    (num,), dev, piece = lengths.shape, lengths.device, _PIECE_ROWS
    total = rows.shape[0] // piece + num  # >= sum of max(ceil(len / piece), 1)
    pieces = torch.clamp((lengths + piece - 1) // piece, min=1)
    pieces[-1] += total - pieces.sum()
    run = torch.repeat_interleave(torch.arange(num, device=dev), pieces, output_size=total)
    nth = torch.arange(total, device=dev) - (torch.cumsum(pieces, 0) - pieces)[run]
    sizes = torch.clamp(lengths[run] - nth * piece, min=0, max=piece)
    partial = torch.segment_reduce(rows, "sum", lengths=sizes, axis=0, unsafe=True)
    return torch.segment_reduce(partial, "sum", lengths=pieces, axis=0, unsafe=True)


def _segment_sums(
    x: torch.Tensor, assignments: torch.Tensor, k: int,
    valid: Optional[torch.Tensor] = None,
):
    """Per-cluster sums ``[m, k, d]`` and counts ``[m, k, 1]`` (f32) of
    the rows, leaving out rows where the ``[n]`` mask ``valid`` is False.

    Each subspace's rows are stably sorted by cluster, then each
    cluster's run is summed in a fixed order (:func:`_ordered_segment_sum`),
    so a fixed input gives the same bits on every run; ``index_add_``
    adds with float atomics on the card, in no fixed order. Rows left out
    sort into one more cluster, dropped. The counts are an integer
    ``bincount``."""
    m, n, d = x.shape
    keys = assignments.to(torch.int32)
    if valid is not None:
        keys = torch.where(valid[None, :], keys, k)
    order = torch.sort(keys, dim=1, stable=True).indices  # [m, n]
    rows = torch.gather(x.to(torch.float32), 1, order[:, :, None].expand(m, n, d))
    runs = keys.long() + torch.arange(m, device=x.device)[:, None] * (k + 1)
    counts = torch.bincount(runs.reshape(-1), minlength=m * (k + 1))
    sums = _ordered_segment_sum(rows.reshape(m * n, d), counts)
    return (sums.reshape(m, k + 1, d)[:, :k],
            counts.reshape(m, k + 1, 1)[:, :k].to(torch.float32))


def _means(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``sums / counts``; empty clusters -> zeros (``KMeans.scala:198-226``)."""
    means = sums / torch.clamp(counts, min=1.0)
    return torch.where(counts > 0, means, torch.zeros_like(means))


def _update(x: torch.Tensor, assignments: torch.Tensor, k: int) -> torch.Tensor:
    """Per-cluster means ``[m, k, d]`` (:func:`_segment_sums`); empty
    clusters -> zeros."""
    return _means(*_segment_sums(x, assignments, k))


def draw_init_indices(
    m: int, n: int, k: int, seed: int, device="cpu"
) -> torch.Tensor:
    """``[m, k]`` init row samples, uniform with replacement. Subspace i
    draws from its own ``torch.Generator`` seeded from ``(seed, i)`` only,
    so its init does not depend on how many subspaces are stacked with it
    (the reference seeds subspace i with ``seed + i``,
    ``ProductQuantizer.scala:140``). These are not ``jax.random``'s
    draws: pass ``init_indices=`` to :func:`fit_kmeans` to replay those."""
    rows = []
    for i in range(m):
        gen = torch.Generator().manual_seed(seed * 1_000_003 + i)
        rows.append(torch.randint(0, n, (k,), generator=gen))
    return torch.stack(rows).to(device)


def kmeans_pp_indices(x: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """``[m, k]`` k-means++ seed rows of stacked ``[m, n, d]`` input
    (Arthur-Vassilvitskii, as ``gulon_tpu/ops/kmeans.py:219-263``): the
    first row uniform, each next row drawn with probability proportional
    to its squared distance to the nearest row chosen so far, all m
    subspaces a step at a time. Where every remaining distance is 0 the
    draw is uniform. Subspace i draws from its own ``torch.Generator``
    seeded from ``(seed, i)`` by inverting the distances' running sum, so
    its rows do not depend on how many subspaces are stacked with it.
    These are not ``jax.random``'s draws: pass ``init_indices=`` to
    :func:`fit_kmeans` to replay those."""
    m, n, _ = x.shape
    dev = x.device
    u = torch.stack([
        torch.rand(k, generator=torch.Generator().manual_seed(
            seed * 1_000_003 + i + 0x9E37), dtype=torch.float64)
        for i in range(m)
    ], dim=1).to(dev)  # [k, m]
    xn = sq_norms(x)  # [m, n]
    sub = torch.arange(m, device=dev)

    def dist_to(picks):  # [m] rows -> [m, n] squared distances
        c = x[sub, picks]  # [m, d]
        ip = matmul(x, c[:, :, None], "highest")[..., 0]
        return torch.clamp(xn + sq_norms(c)[:, None] - 2.0 * ip, min=0.0)

    idx = torch.empty((m, k), dtype=torch.long, device=dev)
    idx[:, 0] = torch.clamp((u[0] * n).long(), max=n - 1)
    d2 = dist_to(idx[:, 0])
    for j in range(1, k):
        cdf = torch.cumsum(d2.double(), dim=1)  # [m, n]
        total = cdf[:, -1]
        drawn = torch.searchsorted(cdf, (u[j] * total)[:, None], right=True)[:, 0]
        uniform = (u[j] * n).long()
        idx[:, j] = torch.clamp(torch.where(total > 0, drawn, uniform), max=n - 1)
        d2 = torch.minimum(d2, dist_to(idx[:, j]))
    return idx


def fit_kmeans(
    x,
    config: KMeansConfig,
    report_fn=None,
    *,
    device=None,
    init_indices: Optional[torch.Tensor] = None,
) -> KMeansResult:
    """Train k-means. ``x`` is ``[n, d]`` or stacked ``[m, n, d]``.

    ``init_indices`` (``[m, k]`` ints) overrides the seeded draw of
    initial rows, for either init; the parity tests pass the JAX package's
    draw through it. ``report_fn(iteration, step mean, converged count,
    step std, step min, step max)`` is called once per Lloyd iteration
    with the distribution of the centroids' movement over every
    (subspace, centroid), the reference's ``KMeans.ProgressReport``
    (``KMeans.scala:119-127,160-168``). Host (numpy) input trains on
    ``device`` (default: the CUDA card, with no CPU fallback); tensor input
    stays on its device (or moves to ``device`` when given).
    """
    if config.init not in ("sample", "kmeans++"):
        raise ValueError(
            f"unknown init {config.init!r} (expected 'sample' or 'kmeans++')"
        )
    if isinstance(x, torch.Tensor):
        x = x.to(dtype=torch.float32, device=device or x.device)
    else:
        x = torch.as_tensor(x, dtype=torch.float32, device=device or DEFAULT_DEVICE)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    m, n, _ = x.shape
    k = config.k
    if init_indices is not None:
        if not isinstance(init_indices, torch.Tensor):
            init_indices = torch.from_numpy(np.array(init_indices, np.int64))
        idx = init_indices.to(device=x.device, dtype=torch.long)
        if idx.shape != (m, k):
            raise ValueError(f"init_indices must be [{m}, {k}], got {tuple(idx.shape)}")
    elif config.init == "kmeans++":
        idx = kmeans_pp_indices(x, k, config.seed)
    else:
        idx = draw_init_indices(m, n, k, config.seed, x.device)
    centroids = torch.stack([x[i, idx[i]] for i in range(m)])
    bs = config.block_rows
    assignments = _assign_blocked(x, centroids, bs, config.precision)
    done = torch.zeros(m, dtype=torch.bool, device=x.device)
    it = 0
    running = it < config.max_iters and not bool(done.all())
    while running:
        # one Lloyd iteration, its device time included: the check that
        # ends it reads ``done`` back
        with tracing.span("gulon.kmeans.iter"):
            new_c = _update(x, assignments, k)
            new_c = torch.where(done[:, None, None], centroids, new_c)
            new_a = _assign_blocked(x, new_c, bs, config.precision)
            new_a = torch.where(done[:, None], assignments, new_a)
            done = done | torch.all(new_a == assignments, dim=1)
            it += 1
            if report_fn is not None:
                moved = torch.sqrt(torch.sum((new_c - centroids) ** 2, dim=-1))
                with tracing.span("gulon.wait.kmeans_report"):
                    stats = torch.stack([
                        moved.mean(), moved.std(unbiased=False), moved.min(), moved.max(),
                    ]).tolist()
                    converged = int(done.sum())
                report_fn(it, stats[0], converged, stats[1], stats[2], stats[3])
            centroids, assignments = new_c, new_a
            with tracing.span("gulon.wait.kmeans_done"):
                running = it < config.max_iters and not bool(done.all())
    if squeeze:
        return KMeansResult(centroids[0], assignments[0], it, done[0])
    return KMeansResult(centroids, assignments, it, done)


def lloyd_step(
    x: torch.Tensor, centroids: torch.Tensor, block_rows: int = 65536
):
    """One assign+update Lloyd step on ``[n, d]`` input (benchmark unit).
    Returns (new_centroids, assignments)."""
    a = _assign_blocked(x[None], centroids[None], block_rows)
    c = _update(x[None], a, centroids.shape[0])
    return c[0], a[0]


def kmeans_objective(x, centroids, assignments) -> torch.Tensor:
    """Mean squared distance to the assigned centroid."""
    picked = centroids[assignments.long()]
    return torch.mean(torch.sum((x - picked) ** 2, dim=-1))
