"""The numbers that decide ``correct``, worked out in float64 by the
plain reference (``h100bench/reference``) from the cell's raw data, the
index the program built and the answers it gave.

The build is judged by itself (``code_gap``, ``lloyd_gain``,
``norm_err``, ``coarse_gain``, ``part_miss``, ``row_err``); the answers
are judged against the reference's own scan over that index (``dist_err``,
``adc_miss``). A PQ index (``flat``, ``ivf``; a flat one with its cache
decoded is ``flat``) is scanned over its codes' reconstruction; an
``exact`` index over the data itself, in float64 from the raw rows (never
the rows the program stored, which ``row_err`` judges), so that there
``dist_err`` is the gap to the exact distance and ``adc_miss`` the share
of answers farther than the exact k-th nearest. Each number is a widest
gap or a share, 0 for a perfect result:

- ``dist_err``: widest gap between a reported distance and the exact
  distance from the query to the reported row's reconstruction, over
  ``||q||^2 + ||x^||^2``; a missing answer reads 1;
- ``adc_miss``: share of answers farther from the query than the
  reference's k-th nearest reconstruction among the rows the
  configuration scans (all rows; for IVF, those of the ``probe``
  partitions with the nearest centroids), by more than ``1e-6`` of the
  scale above;
- ``row_err`` (exact): widest relative gap ``||v - x|| / ||x||`` of a
  stored row ``v`` to the data's row ``x`` (normalised for angular);
- ``code_gap``: widest gap between a row's distance to its code's
  codeword and to the nearest codeword, per subspace, over ``||x_s||^2 +
  ||c||^2`` (IVF: on the residuals to the row's partition);
- ``lloyd_gain``: share of the quantization error one more exact Lloyd
  step from the codebooks would remove;
- ``norm_err``: widest relative gap of the stored reconstruction norms;
- ``coarse_gain``: ``lloyd_gain`` of the partition centroids;
- ``part_miss``: share of rows whose partition's centroid is farther than
  the nearest centroid by more than TF32 products can err (an exact
  comparison: a sound build reads 0).

``code_gap``, ``lloyd_gain`` and ``norm_err`` read PQ codes: asked of an
exact index, they raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from h100bench.reference import exact
from h100bench.reference import pq as rpq

MISS_TOL = 1e-6
# Twice the widest error that products of TF32 operands (10 mantissa bits,
# truncated) and float32 sums put on the gap of two distances
# ||c||^2 - 2 x.c: 2^-8 of sum_i |x_i c_i| over both centroids.
PART_ROUNDING = 2.0 ** -7


@dataclasses.dataclass
class IndexState:
    """What the check reads of a built index, in the corpus's row order."""

    kind: str  # "flat" | "ivf" | "exact"
    bounds: Optional[List[Tuple[int, int]]] = None  # (PQ kinds)
    codebooks: Optional[torch.Tensor] = None  # [m, K, width] f32 (PQ kinds)
    codes: Optional[torch.Tensor] = None  # [N, m] int64 (PQ kinds)
    norms: Optional[torch.Tensor] = None  # [N] f32 stored ||x^||^2 (flat)
    part: Optional[torch.Tensor] = None  # [N] int64 partition (IVF)
    centroids: Optional[torch.Tensor] = None  # [P, D] f32 (IVF)
    probe: int = 0  # partitions a query probes (IVF)
    vectors: Optional[torch.Tensor] = None  # [N, D] f32 stored rows (exact)


@dataclasses.dataclass
class Answers:
    """A sample of the answers the timed path gave."""

    query_rows: np.ndarray  # [A] row of each answered query in the query set
    dists: np.ndarray  # [A, k] f32 reported distances
    rows: np.ndarray  # [A, k] int64 corpus rows (-1 = no answer)


def _residual(state: IndexState, x: torch.Tensor, sl: slice = slice(None)) -> torch.Tensor:
    """Rows ``sl`` of ``x`` in the space the codes quantize: the residual to
    the row's partition centroid for IVF, the row itself for flat."""
    if state.kind == "ivf":
        return x[sl] - state.centroids.to(torch.float64)[state.part[sl]]
    return x[sl]


def reconstruction(state: IndexState, corpus: torch.Tensor) -> torch.Tensor:
    """``[N, D]`` float64 rows the answers are judged against: the codes'
    reconstruction of every row, or for an exact index ``corpus``, the
    reference's own float64 rows."""
    if state.kind == "exact":
        return corpus
    xr = rpq.decode(state.codebooks.to(torch.float64), state.codes, state.bounds)
    if state.kind == "ivf":
        xr = xr + state.centroids.to(torch.float64)[state.part]
    return xr


def _blocks(n: int, step: int) -> Iterable[slice]:
    return (slice(s, min(s + step, n)) for s in range(0, n, step))


def _pq(state: IndexState, name: str) -> IndexState:
    """``state``, which must hold PQ codes for the number ``name``."""
    if state.codes is None:
        raise ValueError(f"{name} reads PQ codes; a {state.kind} index has none")
    return state


def code_gap(state: IndexState, x: torch.Tensor, block: int = 1 << 15) -> float:
    cb = _pq(state, "code_gap").codebooks.to(torch.float64)
    cn = (cb * cb).sum(-1)  # [m, K]
    width = cb.shape[2]
    worst = 0.0
    for sl in _blocks(x.shape[0], block):
        xs = rpq.split(_residual(state, x, sl), state.bounds, width)
        d = rpq.sub_distances(xs, cb, "f64")  # [m, b, K]
        codes = state.codes[sl].T  # [m, b]
        d_code = torch.gather(d, 2, codes[:, :, None])[..., 0]
        d_min, best = d.min(dim=2)
        c_code = torch.gather(cn, 1, codes)
        c_best = torch.gather(cn, 1, best)
        scale = (xs * xs).sum(-1) + torch.maximum(c_code, c_best) + 1e-30
        worst = max(worst, float(((d_code - d_min) / scale).max()))
    return worst


def lloyd_gain(points: torch.Tensor, centroids: torch.Tensor) -> float:
    """``[m, n, d]`` points against ``[m, K, d]`` centroids, float64."""
    a = rpq.assign(points, centroids, "f64")
    new_c, counts = rpq.means(points, a, centroids)
    moved = (counts * ((new_c - centroids) ** 2).sum(-1)).sum()
    picked = torch.stack([centroids[s, a[s]] for s in range(points.shape[0])])
    err = ((points - picked) ** 2).sum()
    return float(moved / err) if float(err) > 0 else 0.0


def part_miss(state: IndexState, x: torch.Tensor, block: int = 1 << 14) -> float:
    """Share of rows whose partition's centroid is farther from the row, in
    float64, than the nearest centroid by more than ``PART_ROUNDING`` of
    ``sum_i |x_i| (|c_i| + |b_i|)`` (``c`` the row's centroid, ``b`` the
    nearest): the assignment's rounding cannot reach that far."""
    c = state.centroids.to(torch.float64)
    cn = (c * c).sum(-1)
    bad = 0
    for sl in _blocks(x.shape[0], block):
        xb = x[sl]
        d = cn[None, :] - 2.0 * (xb @ c.T)  # the row's own norm left out
        d_min, best = d.min(dim=1)
        a = state.part[sl]
        gap = torch.gather(d, 1, a[:, None])[:, 0] - d_min
        room = (xb.abs() * (c[a].abs() + c[best].abs())).sum(-1)
        bad += int((gap > PART_ROUNDING * room).sum())
    return bad / x.shape[0]


def row_err(state: IndexState, x: torch.Tensor, block: int = 1 << 16) -> float:
    """Widest ``||v - x|| / ||x||`` of the stored rows ``v`` (exact)."""
    if state.vectors is None:
        raise ValueError(f"row_err reads stored rows; a {state.kind} index has none")
    worst = 0.0
    for sl in _blocks(x.shape[0], block):
        xb = x[sl]
        gap = torch.linalg.vector_norm(state.vectors[sl].to(torch.float64) - xb, dim=1)
        worst = max(worst, float((gap / (torch.linalg.vector_norm(xb, dim=1) + 1e-30)).max()))
    return worst


def answer_numbers(
    state: IndexState,
    xr: torch.Tensor,  # [N, D] f64 reconstruction
    q: torch.Tensor,  # [A, D] f64 (normalised for angular)
    dists: torch.Tensor,  # [A, k] f64 reported
    rows: torch.Tensor,  # [A, k] int64
) -> Dict[str, float]:
    n, k = xr.shape[0], rows.shape[1]
    valid = (rows >= 0) & (rows < n) & torch.isfinite(dists)
    safe = torch.where(valid, rows, 0)
    picked = xr[safe]  # [A, k, D]
    d_ref = exact.sq_dist_rows(q, picked)
    scale = (q * q).sum(-1)[:, None] + (picked * picked).sum(-1)
    err = torch.where(valid, (dists - d_ref).abs() / scale, 1.0)
    allowed = None
    if state.kind == "ivf":
        c = state.centroids.to(torch.float64)
        _, probed = exact.topk_smallest(q, c, min(state.probe, c.shape[0]))
        hit = torch.zeros((q.shape[0], c.shape[0]), dtype=torch.bool, device=q.device)
        hit.scatter_(1, probed, True)
        allowed = lambda s, e: hit[s:e][:, state.part]  # noqa: E731
    kth, _ = exact.topk_smallest(q, xr, k, allowed=allowed)
    cut = kth[:, -1:]
    tol = MISS_TOL * ((q * q).sum(-1)[:, None] + (picked * picked).sum(-1))
    miss = ~valid | (d_ref > cut + tol)
    return {
        "dist_err": float(err.max()),
        "adc_miss": float(miss.to(torch.float64).mean()),
    }


def numbers(
    names: Iterable[str],
    state: IndexState,
    corpus: torch.Tensor,  # [N, D] f64 on the device (normalised for angular)
    queries: Optional[torch.Tensor] = None,  # [Qset, D] f64, same transform
    answers: Optional[Answers] = None,
) -> Dict[str, float]:
    """The named numbers, each computed once."""
    names = list(names)
    out: Dict[str, float] = {}
    dev = corpus.device
    if {"dist_err", "adc_miss"} & set(names):
        xr = reconstruction(state, corpus)
        q = queries[torch.from_numpy(answers.query_rows).to(dev)]
        out.update(answer_numbers(
            state, xr, q,
            torch.from_numpy(answers.dists).to(dev, torch.float64),
            torch.from_numpy(answers.rows).to(dev),
        ))
        del xr
    if "code_gap" in names:
        out["code_gap"] = code_gap(state, corpus)
    if "lloyd_gain" in names:
        cb = _pq(state, "lloyd_gain").codebooks.to(torch.float64)
        width = cb.shape[2]
        pts = rpq.split(_residual(state, corpus), state.bounds, width)
        out["lloyd_gain"] = lloyd_gain(pts, cb)
        del pts
    if "norm_err" in names:
        cb = _pq(state, "norm_err").codebooks.to(torch.float64)
        xr = rpq.decode(cb, state.codes, state.bounds)
        ref = (xr * xr).sum(-1)
        out["norm_err"] = float(
            ((state.norms.to(torch.float64) - ref).abs() / (ref + 1e-30)).max()
        )
        del xr
    if "coarse_gain" in names:
        c = state.centroids.to(torch.float64)
        out["coarse_gain"] = lloyd_gain(corpus[None], c[None])
    if "part_miss" in names:
        out["part_miss"] = part_miss(state, corpus)
    if "row_err" in names:
        out["row_err"] = row_err(state, corpus)
    missing = [n for n in names if n not in out]
    if missing:
        raise ValueError(f"no such check number: {missing}")
    return {n: out[n] for n in names}
