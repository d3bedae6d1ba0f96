"""Distance primitives as matmuls (counterpart of ``gulon_tpu/ops/distance.py``).

    ||x - c||^2 = ||x||^2 - 2<x, c> + ||c||^2

For argmin ranking the ``||x||^2`` term is dropped, as in the reference's
assignment trick (``KMeans.scala:37-52``).
"""

from __future__ import annotations

import torch

from gulon_tpu_torch.ops.precision import matmul


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Squared L2 norm of each row: ``[..., n, d] -> [..., n]``."""
    return torch.sum(x * x, dim=-1)


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """L2-normalize rows; zero rows are left unchanged (no NaNs)."""
    norms = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    return torch.where(norms > 0, x / safe, x)


def assign_scores(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Ranking scores ``||c||^2 - 2<x,c>`` (x-norm dropped): ``[n, k]``.

    Full f32 ("highest"): code assignment ranks like the reference's f32
    scalar loops."""
    cn = sq_norms(centroids)
    return cn[None, :] - 2.0 * matmul(x, centroids.T, "highest")


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Full squared L2 distances ``[n, k]`` between rows of x and c."""
    return assign_scores(x, c) + sq_norms(x)[:, None]


def nearest(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Index of the nearest centroid per row: ``[n] int32``; ties go to
    the lowest index, as ``jnp.argmin``'s do."""
    return torch.argmin(assign_scores(x, centroids), dim=-1).to(torch.int32)
