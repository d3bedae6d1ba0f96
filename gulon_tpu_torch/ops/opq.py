"""Optimized product quantization: a learned orthogonal rotation before PQ
(counterpart of ``gulon_tpu/ops/opq.py``).

Non-parametric OPQ (Ge, He, Ke, Sun, "Optimized Product Quantization",
CVPR 2013) alternates, for ``min ||X R - Q(X R)||_F^2`` over orthogonal
``R`` and the codebooks:

- fix ``R``, train the codebooks: ordinary PQ training on ``X R``;
- fix the codebooks, solve for ``R``: with ``X_hat = Q(X R)`` the
  Procrustes optimum is ``U V^T`` from the SVD ``X^T X_hat = U S V^T``.

Both halves run on the device of the data at full f32 (the ``D x D``
SVD is ``torch.linalg.svd``). The rotation costs queries one ``[Q, D] x
[D, D]`` matmul and codes nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gulon_tpu_torch.ops.pq import PQConfig, ProductQuantizer, train_product_quantizer
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE


def procrustes_rotation(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Orthogonal ``R`` minimizing ``||x R - x_hat||_F``: ``U V^T`` of
    ``x^T x_hat``. Inputs ``[n, D]``; returns ``[D, D]`` f32."""
    u, _, vt = torch.linalg.svd(matmul(x.T, x_hat, "highest"), full_matrices=False)
    return matmul(u, vt, "highest")


def train_opq(
    x,
    config: PQConfig,
    *,
    opq_iters: int = 8,
    inner_iters: int = 8,
    report_fn=None,
    mesh=None,
    device=None,
    init_indices: Optional[Sequence] = None,
) -> Tuple[torch.Tensor, ProductQuantizer]:
    """Learn ``(rotation [D, D] f32, ProductQuantizer over x @ rotation)``.

    ``opq_iters`` alternating rounds train PQ capped at ``inner_iters``
    Lloyd iterations, the seed folded with the round (``config.seed +
    7919 * round``, as the JAX package does); then one full ``config``
    training fixes the codebooks against the learned rotation.
    ``opq_iters=0`` is plain PQ with an identity rotation.
    ``report_fn(round, mean squared error)`` follows each round.
    ``init_indices``, one ``[m, k]`` init draw per round and one for the
    final training, replaces the seeded draws (the parity tests pass the
    JAX package's through it). Host input trains on ``device`` (default:
    the CUDA card); a tensor stays on its device. With ``mesh`` every PQ
    training runs distributed over its devices.
    """
    if init_indices is not None and len(init_indices) != opq_iters + 1:
        raise ValueError(
            f"init_indices needs {opq_iters + 1} draws (one per round and "
            f"the final training), got {len(init_indices)}"
        )
    if isinstance(x, torch.Tensor):
        x = x.to(dtype=torch.float32, device=device or x.device)
    else:
        x = torch.as_tensor(
            np.asarray(x, np.float32), device=device or DEFAULT_DEVICE
        )
    d = x.shape[1]
    rot = torch.eye(d, dtype=torch.float32, device=x.device)
    inner = config._replace(max_iters=min(inner_iters, config.max_iters))
    for it in range(opq_iters):
        z = matmul(x, rot, "highest")
        pq = train_product_quantizer(
            z, inner._replace(seed=config.seed + 7919 * it), mesh=mesh,
            init_indices=None if init_indices is None else init_indices[it],
        )
        x_hat = pq.decode(pq.encode(z))
        rot = procrustes_rotation(x, x_hat)
        if report_fn is not None:
            report_fn(it, float(torch.mean(torch.sum((z - x_hat) ** 2, dim=1))))
    z = matmul(x, rot, "highest")
    pq = train_product_quantizer(
        z, config, mesh=mesh,
        init_indices=None if init_indices is None else init_indices[-1],
    )
    return rot, pq


def reconstruction_mse(
    pq: ProductQuantizer, x, rotation: Optional[torch.Tensor] = None
) -> float:
    """Mean squared reconstruction error of ``x`` under ``pq``, after the
    optional rotation: the quantity OPQ minimizes. Runs on the
    quantizer's device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    x = x.to(dtype=torch.float32, device=pq.device)
    z = x if rotation is None else matmul(x, rotation.to(pq.device), "highest")
    x_hat = pq.decode(pq.encode(z))
    return float(torch.mean(torch.sum((z - x_hat) ** 2, dim=1)))
