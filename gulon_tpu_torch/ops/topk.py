"""Top-k-smallest selection and merge (counterpart of ``gulon_tpu/ops/topk.py``).

``lax.top_k`` returns equal values lowest index first, and the epilogues
rely on it: ``finish_scan`` ranks block winners so that equal scores keep
the earliest rows, the reference heap's rule (``TopKHeap.scala:69-79``).
``torch.topk`` promises no order among ties, so selection here is a
stable sort, which ranks on (value, index).
"""

from __future__ import annotations

from typing import Tuple

import torch


def smallest_k(dists: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest values (ascending) and their int32 indices along the
    last axis; among equal values the lowest index comes first."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


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
