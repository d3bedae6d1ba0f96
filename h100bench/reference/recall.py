"""Distance-cutoff recall@k, copied from ``gulon_tpu_torch/utils/eval.py``
(``recall_of``, the reference's ``Tests.scala:22-40``).

A returned neighbour counts iff its exact distance to the query is within
``(sqrt(true_kth) * (1 + eps))^2``, the true k-th nearest distance with
slack ``eps``; ties and duplicate rows cannot make a right answer wrong.
"""

from __future__ import annotations

import torch


def cutoff_hits(
    returned_dist: torch.Tensor,  # [Q, k] exact distances of the answers
    valid: torch.Tensor,  # [Q, k] bool: an answer holds a row
    true_kth: torch.Tensor,  # [Q] exact k-th nearest distance
    epsilon: float,
) -> torch.Tensor:
    """Hits of each query: ``[Q]`` counts in ``0..k``."""
    cutoff = true_kth * (1.0 + epsilon) ** 2
    exact = torch.where(valid, returned_dist, torch.inf)
    return (exact <= cutoff[:, None]).sum(dim=1)
