"""Product quantization as the reference defines it, in plain PyTorch.

The subspace split is ``Vectors.subvectors`` (``Vectors.scala:91-103``):
with ``ideal = ceil(D / m)`` the first ``m - (ideal * m - D)`` subspaces
take ``ideal`` dimensions and the rest ``ideal - 1``. Codebooks are kept
as ``[m, K, width]`` with a subspace's unused lanes zero, so a row's
reconstruction is the concatenation of its codewords' leading lanes.

``rounded(x, precision)`` puts a tensor on the grid of a lower precision
(``f64``, ``f32``, ``tf32``, ``bf16``, ``fp8``), and :func:`mm` multiplies
two tensors whose operands are rounded so and whose products add up in
float32 (float64 for ``f64``): how a matrix unit of that precision
computes. The check runs everything in ``f64``; the control runs the
same code one precision below the one the configuration states.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

Bounds = List[Tuple[int, int]]


def subspace_bounds(dim: int, m: int) -> Bounds:
    ideal = -(-dim // m)
    num_large = m - (ideal * m - dim)
    out, start = [], 0
    for i in range(m):
        width = ideal if i < num_large else ideal - 1
        out.append((start, width))
        start += width
    return out


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` on the grid of ``precision``, returned as float32 (float64 for
    ``f64``)."""
    if precision == "f64":
        return x.to(torch.float64)
    x = x.to(torch.float32)
    if precision == "f32":
        return x
    if precision == "tf32":  # 10 mantissa bits, round to nearest
        bits = x.view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` with operands rounded to ``precision``; exact float32 (or
    float64) products and sums."""
    a, b = rounded(a, precision), rounded(b, precision)
    if a.is_cuda:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return a @ b


def split(x: torch.Tensor, bounds: Bounds, width: int) -> torch.Tensor:
    """``[n, D] -> [m, n, width]``, unused lanes zero."""
    out = x.new_zeros((len(bounds), x.shape[0], width))
    for s, (start, w) in enumerate(bounds):
        out[s, :, :w] = x[:, start : start + w]
    return out


def decode(codebooks: torch.Tensor, codes: torch.Tensor, bounds: Bounds) -> torch.Tensor:
    """``[n, m]`` codes -> ``[n, D]`` reconstruction."""
    codes = codes.long()
    return torch.cat(
        [codebooks[s, codes[:, s], :w] for s, (_, w) in enumerate(bounds)], dim=1
    )


def sub_distances(xs: torch.Tensor, codebooks: torch.Tensor, precision: str) -> torch.Tensor:
    """``[m, n, K]`` squared distances of each subspace row to each codeword,
    ``||x||^2 + ||c||^2 - 2 x.c`` with the product at ``precision``."""
    xn = (rounded(xs, "f64" if precision == "f64" else "f32") ** 2).sum(-1)
    cn = (rounded(codebooks, "f64" if precision == "f64" else "f32") ** 2).sum(-1)
    return xn[:, :, None] + cn[:, None, :] - 2.0 * mm(xs, codebooks.transpose(1, 2), precision)


def assign(x: torch.Tensor, centroids: torch.Tensor, precision: str, block: int = 1 << 15):
    """Nearest centroid of each row of ``x``: ``[m, n, d]`` against ``[m, K,
    d]`` (or ``[n, d]`` against ``[K, d]``), in blocks of rows."""
    squeeze = x.ndim == 2
    if squeeze:
        x, centroids = x[None], centroids[None]
    out = torch.empty(x.shape[:2], dtype=torch.long, device=x.device)
    for s in range(0, x.shape[1], block):
        d = sub_distances(x[:, s : s + block], centroids, precision)
        out[:, s : s + block] = d.argmin(dim=-1)
    return out[0] if squeeze else out


def means(x: torch.Tensor, a: torch.Tensor, centroids: torch.Tensor):
    """Per-cluster means of ``x`` (``[m, n, d]``, assignments ``[m, n]``),
    and the counts; an empty cluster keeps its centroid."""
    m, _, d = x.shape
    k = centroids.shape[1]
    sums = x.new_zeros((m, k, d))
    counts = x.new_zeros((m, k))
    for s in range(m):
        sums[s].index_add_(0, a[s], x[s])
        counts[s].index_add_(0, a[s], x.new_ones(a.shape[1]))
    mean = sums / counts.clamp(min=1)[:, :, None]
    return torch.where(counts[:, :, None] > 0, mean, centroids), counts


def kmeans(
    x: torch.Tensor,  # [m, n, d]
    k: int,
    iters: int,
    seed: int,
    *,
    precision: str,
    storage: str,
) -> torch.Tensor:
    """Lloyd's k-means from ``k`` distinct rows drawn from ``seed``: assign at
    ``precision``, means in float32, centroids stored at ``storage``;
    stops early once no assignment changes. Returns ``[m, k, d]``."""
    m, n, _ = x.shape
    g = torch.Generator(device=x.device)
    g.manual_seed(int(seed))
    idx = torch.stack([torch.randperm(n, generator=g, device=x.device)[:k] for _ in range(m)])
    c = rounded(torch.stack([x[s, idx[s]] for s in range(m)]), storage)
    a = assign(x, c, precision)
    for _ in range(iters):
        c = rounded(means(x, a, c)[0], storage)
        new_a = assign(x, c, precision)
        if torch.equal(new_a, a):
            break
        a = new_a
    return c
