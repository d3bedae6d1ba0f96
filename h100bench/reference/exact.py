"""Exact nearest neighbours and exact distances, in float64.

Everything here works on device tensors in blocks of queries, so that a
1.2M-row corpus is ranked in a few seconds on the card and a tiny one on
the CPU.
"""

from __future__ import annotations

import torch

_BLOCK_ELEMS = 1 << 28  # f64 distance elements held at once (2 GiB)


def normalized(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit length (zero rows stay zero), as the angular
    metric asks: ``Metric.scala:3-9``'s ingest and query transform."""
    n = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return torch.where(n > 0, x / torch.where(n > 0, n, 1.0), x)


def sq_dist_rows(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``||q_i - rows_i||^2`` row by row, direct form: ``[n]`` or ``[Q, k]``
    when ``rows`` is ``[Q, k, D]`` and ``q`` is ``[Q, D]``."""
    if rows.ndim == 3:
        return ((rows - q[:, None, :]) ** 2).sum(dim=-1)
    return ((rows - q) ** 2).sum(dim=-1)


def topk_smallest(
    q: torch.Tensor,  # [Q, D] f64
    x: torch.Tensor,  # [N, D] f64
    k: int,
    *,
    allowed=None,  # None, or fn(q_start, q_stop) -> [Qb, N] bool mask
):
    """``([Q, k] squared distances, [Q, k] rows)`` of the k nearest rows,
    by the expansion ``||q||^2 + ||x||^2 - 2 q.x`` in float64."""
    xn = (x * x).sum(dim=1)
    qn = (q * q).sum(dim=1)
    step = max(1, _BLOCK_ELEMS // max(x.shape[0], 1))
    vals, rows = [], []
    for s in range(0, q.shape[0], step):
        e = min(s + step, q.shape[0])
        d = qn[s:e, None] + xn[None, :] - 2.0 * (q[s:e] @ x.T)
        if allowed is not None:
            d = torch.where(allowed(s, e), d, torch.inf)
        v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
        vals.append(v)
        rows.append(i)
    return torch.cat(vals), torch.cat(rows)
