"""gist-960-euclidean's shape on the port's flat path: 960 dimensions over
25 quantizers of 256 codes (10 subspaces of 39 lanes, then 15 of 38), L2,
built by ``build_flat_index`` and queried through ``auto``.

On the CPU a seeded 8,192-row index answers 64 and 12 queries (12: a
ragged query tile), held to the benchmark's plain float64 reference
(``h100bench/reference``: the reconstruction of the index's own codes and
an exact top-10 over it): ``auto`` (the decode scan on the CPU) and K1's
plain twin (``scan_strategy="pallas"``), whose one winner a 128-row block
is held to the reference's own block winners. On a card (tests marked
``cuda``) a 262,144-row index answers 1,024 queries through ``auto``,
which takes K1 in its streamed plan: every launch streamed, codebooks
from global memory, each block decoded once per 256-query tile, on
operands laid out at 40 lanes a subspace (the plan's ``width``), so
8 lanes a gather; its winners equal the plain twin's but at near-ties.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
import gulon_tpu_torch as gt
from gulon_tpu_torch.ops.cuda import adc
from gulon_tpu_torch.ops.distance import sq_norms
from gulon_tpu_torch.utils import tracing
from h100bench.corpus import low_rank
from h100bench.reference import exact
from h100bench.reference import pq as rpq

D, M, K = 960, 25, 256
BOUNDS = [(39 * s, 39) for s in range(10)] + [(390 + 38 * s, 38) for s in range(15)]


def _corpus(rows: int, queries: int, device="cpu"):
    x = low_rank(960, rows + queries, D, intrinsic=32, clusters=64, noise=0.05, device=device)
    x = x.cpu().numpy()
    return x[:rows], x[rows:]


def _build(x, device, max_iters):
    keys = np.array([f"{i:06d}" for i in range(len(x))], dtype=object)
    return gt.build_flat_index(keys, x, gt.Metric.L2, gt.PQConfig(max_iters=max_iters),
                               device=device)


@pytest.fixture(scope="module")
def cpu_case():
    torch.manual_seed(0)
    x, q = _corpus(8192, 64)
    return _build(x, "cpu", 8), q


def _bf16_tol(q: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
    """What K1's bf16 operands may move a distance by, ``q`` [Q, D] against
    ``xr`` [Q, k, D] (float64). K1 rounds each ``-2 q`` lane to bf16, an
    error of at most 2^-9 of the lane, independent from lane to lane,
    against codewords already on the bf16 grid: a score moves by a sum of
    independent terms within 2^-8 |q_i xr_i| each, whose standard
    deviation is 2^-8 / sqrt(3) of ``sqrt(sum_i (q_i xr_i)^2)``. 2^-6 of
    that root is 6.9 deviations (sound runs of this size reach about 3.3;
    queries rounded to fp8 first reach 20). The norm lanes' hi/lo split
    (2^-17), the lane pack (2^-17 of the score) and the f32 sums stay
    under 2^-14 of ``||q||^2 + ||xr||^2``."""
    root = ((q[:, None, :] * xr) ** 2).sum(-1).sqrt()
    return 2.0 ** -6 * root + 2.0 ** -14 * ((q * q).sum(-1)[:, None] + (xr * xr).sum(-1))


def _reference(index, q):
    """``(recon [N, D], q [Q, D], d_all [Q, N])`` float64: the
    reconstruction of the index's codes and every ADC distance."""
    xr = rpq.decode(index.pq.codebooks.to(torch.float64), index.codes.long(), index.pq.bounds)
    qd = torch.from_numpy(q).to(torch.float64)
    d_all = (qd * qd).sum(-1)[:, None] + (xr * xr).sum(-1)[None, :] - 2.0 * qd @ xr.T
    return xr, qd, d_all


def test_the_subspaces_are_gulons_split(cpu_case):
    index, _ = cpu_case
    assert [tuple(b) for b in index.pq.bounds] == BOUNDS
    assert (index.pq.num_quantizers, index.pq.num_clusters, index.pq.pad_width) == (M, K, 39)
    assert adc.padded_depth(M, 39) == 984


@pytest.mark.parametrize("nq", [64, 12], ids=["q64", "q12-ragged"])
def test_auto_answers_within_the_reference(cpu_case, nq):
    """``auto`` on the CPU (the decode scan): every answered row lies within
    the reference's 10th ADC distance plus 1e-6 of the scale, and every
    reported distance within the bf16-operand tolerance."""
    index, q = cpu_case
    q = q[:nq]
    assert index.resolve_strategy(nq, 10) == "decode"
    dists, ids = index.query_arrays(10, q)
    xr, qd, d_all = _reference(index, q)
    assert bool((ids >= 0).all())
    picked = xr[ids.long()]
    d_ref = exact.sq_dist_rows(qd, picked)
    scale = (qd * qd).sum(-1)[:, None] + (picked * picked).sum(-1)
    kth, _ = exact.topk_smallest(qd, xr, 10)
    assert bool((d_ref <= kth[:, -1:] + 1e-6 * scale).all())
    assert bool(((dists.to(torch.float64) - d_ref).abs() <= _bf16_tol(qd, picked)).all())


@pytest.mark.parametrize("nq", [64, 12], ids=["q64", "q12-ragged"])
def test_k1_twin_answers_within_the_reference_block_winners(cpu_case, nq):
    """K1's plain twin at depth 984, rerank 1 and one winner a block: each
    answer is one block's winner, within the tolerance of the reference's
    10th best block winner, and its reported distance within the same
    tolerance of the reference's."""
    index, q = cpu_case
    q = q[:nq]
    twin = dataclasses.replace(index, scan_strategy="pallas", _k1_operands=None)
    assert (twin.resolved_rerank_factor(), twin.resolved_pallas_winners()) == (1, 1)
    dists, ids = twin.query_arrays(10, q)
    xr, qd, d_all = _reference(index, q)
    picked = xr[ids.long()]
    d_ref = exact.sq_dist_rows(qd, picked)
    tol = _bf16_tol(qd, picked)
    assert bool(((dists.to(torch.float64) - d_ref).abs() <= tol).all())
    blocks = ids.long() // 128
    assert all(len(set(b.tolist())) == 10 for b in blocks)  # one winner a block
    block_min, block_row = d_all.reshape(nq, -1, 128).min(dim=2)
    kth_v, kth_b = torch.topk(block_min, 10, dim=1, largest=False)
    kth_row = kth_b[:, -1] * 128 + torch.gather(block_row, 1, kth_b[:, -1:])[:, 0]
    tol_k = _bf16_tol(qd, xr[kth_row][:, None, :])
    assert bool((d_ref <= kth_v[:, -1:] + tol + tol_k).all())


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K1 runs only on the card")
    return torch.device("cuda")


K1_PLAN_COUNTERS = ("k1.launches", "k1.launches.streamed", "k1.launches.cb_global",
                    "k1.blocks", "k1.block_decodes", "k1.gather_lanes",
                    "k1.launches.lane_padded")


@pytest.mark.cuda
def test_auto_takes_k1_streamed_on_the_card(card):
    """1,024 queries over 262,144 rows: ``auto`` resolves to K1 with one
    winner a block and no rescore; every launch is streamed with its
    codebooks in global memory, on operands padded from 39 lanes a
    subspace to 40 (the plan at the index's own shape gathers one lane,
    at 40 it gathers 8), and decodes each block 4 times (256 queries a
    tile); the ids equal the plain twin's on the same operands but at
    near-ties within ``2^-14 max(|v|, S)``, ``S = ||q||^2 + center`` the
    size of the terms a centered score sums."""
    x, q = _corpus(262_144, 1024, device=card)
    index = _build(x, card, 5)
    assert index.resolve_strategy(1024, 10) == "pallas"
    assert (index.resolved_rerank_factor(), index.resolved_pallas_winners()) == (1, 1)
    before = {c: tracing.counter(c) for c in K1_PLAN_COUNTERS}
    dists, ids = index.query_arrays(10, q)
    torch.cuda.synchronize()
    n = {c: tracing.counter(c) - before[c] for c in K1_PLAN_COUNTERS}
    assert n["k1.launches"] == 1
    assert n["k1.launches.streamed"] == n["k1.launches.cb_global"] == n["k1.launches"]
    assert n["k1.gather_lanes"] == 8 * n["k1.launches"]
    assert n["k1.launches.lane_padded"] == n["k1.launches"]
    assert n["k1.blocks"] == adc._round_up(262_144, 2048) // 128
    assert n["k1.block_decodes"] == 4 * n["k1.blocks"]
    assert adc.k1_plan(M, K, 39) == dict(streamed=1, cb_smem=0, stages=5, lanes=1,
                                          smem=214_096, width=40, qtile=256)
    assert adc.k1_plan(M, K, 40) == dict(streamed=1, cb_smem=0, stages=5, lanes=8,
                                          smem=214_096, width=40, qtile=256)

    k1 = index._k1_operands
    assert k1.lane_padded and tuple(k1.cb.shape) == (M, K, 40)
    qt = index._prepare_queries(q)
    args, nblk = k1.operands(qt)
    _, base_cols = k1.geometry(len(qt))
    got = adc.fused_block_scan(*args, winners=1, nblk=nblk)
    ref = adc._block_scan_plain(*args, winners=1, nblk=nblk)
    # a centered score is the f32 sum of the ||q||^2 + center lane and the
    # -2 q.x terms, each about that large, so its rounding grows with that
    # sum and not with the score: near neighbours score far below it here
    scale = (sq_norms(qt) + k1.center)[:, None]
    result = cs.compare_packed(got, ref, scale.expand_as(got))
    assert result["ok"], result

    def finish(packed):
        return adc.finish_scan(
            packed, base_cols, None, k1.codes_t, queries=qt, codebooks=index.pq.codebooks,
            k=10, kk=10, rescore=False, centered=True,
        )

    d_k, i_k = finish(got)
    d_p, i_p = finish(ref)
    assert torch.equal(i_k, ids) and torch.equal(d_k, dists)
    tol = 2.0 ** -14 * torch.maximum(d_p.abs(), scale)
    assert bool(((d_k - d_p).abs() <= tol).all())  # an id that differs is a near-tie
    assert float((i_k == i_p).float().mean()) >= 0.99
