"""The IVF K1 route's winner selection (``ops/cuda/ivf_topk.py``): the
``fetch`` smallest winners over the columns of each query's probed
partitions, read from the layout's block-range table
(``models/ivf.py::PartitionBlocks``).

Each result is held, bit for bit, to the expression the route ran before
the selection read only the probed columns, kept as the oracle
(``chip_smoke.masked_ivf_select``, :func:`masked_sort_route`): the probe
mask and group term gathered onto every winner column by ``blk_part``,
the unprobed and invalid columns set to +inf, one stable sort over all of
them. Where the
oracle ranks +inf the column it names is not compared: the route reads
no id there. On the CPU the plain twin answers; on a card (tests marked
``cuda``) the kernel is held to the twin, bit for bit, columns too.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gulon_tpu_torch.models.ivf import (
    _pallas_ivf_query,
    _probe_mask_limit_groups,
    _probe_mask_limit_vectors,
    _rank_and_probe,
    partition_layout,
)
from gulon_tpu_torch.ops import scan as scan_ops
from gulon_tpu_torch.ops.cuda import ivf_topk
from gulon_tpu_torch.ops.cuda.adc import (
    _INVALID_MIN,
    K1Operands,
    _base_cols,
    unpack_block_winners,
)
from gulon_tpu_torch.ops.pq import subspace_bounds
from gulon_tpu_torch.ops.topk import smallest_k_nan_last
from gulon_tpu_torch.utils import tracing

INF = float("inf")


def masked_sort_route(q, qn, group_term, probe_mask, k1, blk_part, row_map, *, k, winners,
                 rescore=0):
    """K1 and the route's epilogue over every winner column."""
    npad = row_map.shape[0]
    packed, base_cols = k1.scan(q, winners=winners)
    bv, bi = unpack_block_winners(packed, base_cols)
    col_part = blk_part[torch.clamp(base_cols.long() // 128, max=blk_part.shape[0] - 1)]
    gt = group_term[:, col_part]
    valid = (bv < _INVALID_MIN) & probe_mask[:, col_part]
    d = torch.where(valid, bv + gt + qn[:, None], INF)
    kk = min(k, d.shape[1])
    fetch = min(rescore * kk, d.shape[1]) if rescore else kk
    best, pos = smallest_k_nan_last(d, fetch)
    pos = pos.long()
    win_rows = torch.gather(bi, 1, pos)
    if rescore:
        best, win_rows = scan_ops.ivf_block_rescore(
            q, qn, k1.codebooks, k1.codes_t, k1.norms, best, win_rows,
            torch.gather(gt, 1, pos), bounds=k1.bounds, k=kk,
        )
    ids = row_map[torch.clamp(win_rows.long(), max=npad - 1)]
    ids = torch.where(torch.isinf(best), -1, ids)
    if kk < k:
        best = torch.nn.functional.pad(best, (0, k - kk), value=INF)
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return best, ids


def _same_bits(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _same_as_masked_sort(best, cols, ref_best, ref_pos):
    _same_bits(best, ref_best)
    named = ~torch.isposinf(ref_best)
    assert torch.equal(cols[named], ref_pos[named])


# Scenarios of the selection: a layout, a probe and winners. Partitions of
# 0-700 rows (up to 6 blocks) over row tiles of nblk = 2 blocks, so each
# partition's columns cross tiles.
SCENARIOS = {
    "tiles": {},
    "empty_partitions": dict(empty=0.5),
    "limit_vectors": dict(kind="vectors", count=900),
    "tied_keys": dict(grid=(0.0, 0.5, 1.0), tied_terms=True),
    "few_valid": dict(invalid=0.97),
    "nan_query": dict(nan_rows=(0, 3)),
    "nan_query_every_column_probed": dict(nan_rows=(0, 3), all_probed=True),
    "one_shard": dict(shard=True, extra=4),
    # K1 gives padding rows no valid winner; with them valid the columns of
    # the padding blocks count for the partition the clamp names: the last
    # real block's (row-tile padding), 0 (a shard's blocks past its own)
    "padding_winners_valid": dict(padding_valid=True, nblk=4),
    "one_shard_padding_winners_valid": dict(shard=True, extra=4, padding_valid=True),
}


def _layout(rng, sizes, parts, num_parts, extra, device, m=2):
    """:func:`partition_layout` over random codes: ``(codes_t, rc_pal,
    blocks, row_map)``, ``extra`` padding blocks past the partitions."""
    n = max(int(sizes.sum()), 1)
    codes = torch.from_numpy(rng.integers(0, 256, (n, m), dtype=np.uint8)).to(device)
    rc = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(device)
    fill = int((-(-sizes // 128) * 128).sum())
    return partition_layout(codes, rc, sizes, parts, 256, fill + 128 * extra,
                            num_parts=num_parts)


def _sizes(rng, num_parts, empty=0.0, low=0, high=700):
    sizes = rng.integers(low, high, num_parts).astype(np.int64)
    sizes[rng.random(num_parts) < empty] = 0
    return sizes


def _mask(rng, num_q, all_sizes, kind, count, device, all_probed=False):
    cdist = torch.from_numpy(rng.normal(size=(num_q, len(all_sizes))).astype(np.float32))
    if all_probed:
        mask = torch.ones_like(cdist, dtype=torch.bool)
    elif kind == "groups":
        mask = _probe_mask_limit_groups(cdist, count)
    else:
        mask = _probe_mask_limit_vectors(cdist, torch.from_numpy(all_sizes), count)
    return mask.to(device)


def select_case(scenario, winners, seed=0, device="cpu", *, num_parts=16, num_q=7, nblk=2,
                count=4, sizes=None):
    """Inputs of the selection for a scenario: ``(packed, base_cols,
    group_term, qn, mask, blocks, nblk, probe)``."""
    sc = SCENARIOS[scenario]
    nblk = sc.get("nblk", nblk)
    rng = np.random.default_rng(seed)
    all_sizes = _sizes(rng, num_parts, sc.get("empty", 0.0)) if sizes is None else sizes
    if sc.get("shard"):
        parts = rng.permutation(num_parts)[: num_parts * 5 // 8]
    else:
        parts = np.arange(num_parts)
    _, _, blocks, _ = _layout(rng, all_sizes[parts], parts, num_parts, sc.get("extra", 0),
                              device)
    nbp = blocks.blk_part.shape[0]
    n_cols = -(-nbp // nblk) * nblk * 128
    base_cols = _base_cols(n_cols, nblk * 128, winners, device)
    nw = base_cols.shape[0]
    grid = np.asarray(sc.get("grid", rng.normal(size=64)), np.float32)
    v = rng.choice(grid, size=(num_q, nw)).astype(np.float32)
    v[rng.random((num_q, nw)) < sc.get("invalid", 0.2)] = 2.0e38
    v[rng.random((num_q, nw)) < 0.05] = np.nan  # K1's NaN winners: invalid
    if not sc.get("padding_valid"):  # K1's winners of padding rows
        v[:, base_cols.cpu().numpy() // 128 >= blocks.real_blocks] = 2.0e38
    bits = (v.view(np.int32) & ~127) | rng.integers(0, 128, v.shape, dtype=np.int32)
    packed = torch.from_numpy(bits.view(np.float32)).to(device)
    if sc.get("tied_terms"):
        gt = np.repeat(rng.choice(grid, size=(num_q, 1)), num_parts, axis=1)
    else:
        gt = rng.normal(size=(num_q, num_parts))
    qn = rng.uniform(0.5, 2.0, num_q)
    for r in sc.get("nan_rows", ()):
        if r < num_q:
            gt[r], qn[r] = np.nan, np.nan
    kind = sc.get("kind", "groups")
    probe = (kind, sc.get("count", count))
    mask = _mask(rng, num_q, all_sizes, kind, probe[1], device, sc.get("all_probed", False))
    return (packed, base_cols, torch.from_numpy(gt.astype(np.float32)).to(device),
            torch.from_numpy(qn.astype(np.float32)).to(device), mask, blocks, nblk, probe)


def _fetch(fetch, nw):
    return nw if fetch == "all" else min(fetch, nw)


@pytest.mark.parametrize("fetch", [1, 10, 40, "all"])
@pytest.mark.parametrize("winners", [1, 2, 3, 4])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_the_selection_equals_the_sort_over_every_column(scenario, winners, fetch):
    packed, base_cols, gt, qn, mask, blocks, nblk, _ = select_case(scenario, winners)
    f = _fetch(fetch, packed.shape[1])
    best, cols = ivf_topk.ivf_select(packed, gt, qn, mask, blocks.ranges, blocks.blk_part,
                                     blocks.real_blocks, winners=winners, nblk=nblk, fetch=f)
    ref_best, ref_pos = cs.masked_ivf_select(packed, base_cols, gt, qn, mask, blocks.blk_part,
                                             f)
    _same_as_masked_sort(best, cols, ref_best, ref_pos)
    if scenario.startswith("nan_query") and fetch == "all":
        assert bool(torch.isnan(best).any())  # the NaN keys come out, last
    if scenario == "few_valid" and fetch == 40:
        assert bool(torch.isposinf(best).any())  # fewer valid columns than fetch


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_the_block_range_table_agrees_with_blk_part(scenario):
    """Each partition's range holds its blocks of ``blk_part`` and no
    other; the ranges fill the real blocks; the padding blocks read 0;
    :func:`column_partitions` is the masked sort's column partition on every
    column, padding included; ``largest_blocks`` sums the largest partitions."""
    packed, base_cols, _, _, _, blocks, nblk, _ = select_case(scenario, 4)
    blk = blocks.blk_part.numpy()
    ranges = blocks.ranges.numpy()
    lengths = ranges[:, 1] - ranges[:, 0]
    assert lengths.min() >= 0 and int(lengths.sum()) == blocks.real_blocks
    seen = np.zeros(blocks.real_blocks, np.int64)
    for p, (b0, b1) in enumerate(ranges):
        assert (blk[b0:b1] == p).all()
        seen[b0:b1] += 1
    assert (seen == 1).all()
    assert (blk[blocks.real_blocks:] == 0).all()
    got = ivf_topk.column_partitions(blocks.ranges, blocks.blk_part, blocks.real_blocks,
                                     packed.shape[1], 4, nblk)
    ref = blocks.blk_part[torch.clamp(base_cols.long() // 128, max=len(blk) - 1)]
    assert torch.equal(got, ref)
    assert blocks.largest_blocks.tolist() == np.cumsum(np.sort(lengths)[::-1]).tolist()


@pytest.mark.parametrize("kind", ["groups", "vectors"])
@pytest.mark.parametrize("scenario", ["tiles", "empty_partitions", "one_shard"])
def test_the_column_bound_holds_every_probe(scenario, kind):
    """:meth:`PartitionBlocks.column_bound`, the figure ``ivf.select_keys``
    counts a query, is at least the probed columns of every query, under
    the probe it is given: below all the columns under a narrow
    ``LimitGroups``, all of them under ``LimitVectors``."""
    packed, base_cols, _, _, _, blocks, nblk, _ = select_case(scenario, 4, num_q=64)
    rng = np.random.default_rng(1)
    count = 4 if kind == "groups" else 900
    all_sizes = _sizes(np.random.default_rng(0), 16, SCENARIOS[scenario].get("empty", 0.0))
    mask = _mask(rng, 64, all_sizes, kind, count, "cpu")
    col_part = ivf_topk.column_partitions(blocks.ranges, blocks.blk_part, blocks.real_blocks,
                                          packed.shape[1], 4, nblk)
    probed = mask[:, col_part].sum(dim=1)
    bound = blocks.column_bound((kind, count), 4, packed.shape[1])
    assert int(probed.max()) <= bound
    assert (bound < packed.shape[1]) if kind == "groups" else (bound == packed.shape[1])


def route_case(rng, device, *, num_parts=12, sizes=None, parts=None, extra=0, d=18, m=4,
               num_q=9, nan_rows=(4,)):
    """A partition-padded layout over random codes, K1's operands on it and
    a probed batch: ``(q, all_sizes, centroids, k1, blocks, row_map)``."""
    all_sizes = _sizes(rng, num_parts, 0.2, 0, 900) if sizes is None else sizes
    parts = np.arange(num_parts) if parts is None else parts
    codes_t, rc_pal, blocks, row_map = _layout(rng, all_sizes[parts], parts, num_parts, extra,
                                               device, m=m)
    bounds = subspace_bounds(d, m)
    dsub = max(w for _, w in bounds)
    cb = rng.normal(size=(m, 256, dsub)).astype(np.float32)
    for s, (_, w) in enumerate(bounds):
        cb[s, :, w:] = 0.0
    k1 = K1Operands(torch.from_numpy(cb).to(device), codes_t, rc_pal, bounds=bounds,
                    num_rows=codes_t.shape[1])
    q = rng.normal(size=(num_q, d)).astype(np.float32)
    q[list(nan_rows)] = np.nan
    centroids = torch.from_numpy(rng.normal(size=(num_parts, d)).astype(np.float32)).to(device)
    return torch.from_numpy(q).to(device), all_sizes, centroids, k1, blocks, row_map


@pytest.mark.parametrize("rescore", [0, 2, 4])
@pytest.mark.parametrize("winners", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["groups", "vectors"])
def test_the_route_equals_the_sort_over_every_column(kind, winners, rescore):
    """``_pallas_ivf_query`` over K1's plain twin: best and ids, NaN query
    rows included, bit for bit the route's over every column."""
    rng = np.random.default_rng(winners * 10 + rescore)
    q, all_sizes, centroids, k1, blocks, row_map = route_case(rng, "cpu")
    count = 3 if kind == "groups" else 1200
    gt, qn, _, mask = _rank_and_probe(q, centroids, torch.from_numpy(all_sizes), kind=kind,
                                      count=count)
    got = _pallas_ivf_query(q, qn, gt, mask, k1, blocks, row_map, k=10, winners=winners,
                            rescore=rescore, probe=(kind, count))
    ref = masked_sort_route(q, qn, gt, mask, k1, blocks.blk_part, row_map, k=10, winners=winners,
                       rescore=rescore)
    _same_bits(got[0], ref[0])
    assert torch.equal(got[1], ref[1])
    assert bool((got[1][4] == -1).all())  # the NaN query finds nothing


@pytest.mark.parametrize("rescore", [0, 4])
def test_one_shards_layout_equals_the_sort_over_every_column(rescore):
    """A shard's layout: some partitions in their local order, the rest
    absent (empty ranges), padding blocks past them up to the shards'
    common length; the mask and group terms over every partition."""
    rng = np.random.default_rng(7)
    parts = rng.permutation(12)[:7]
    q, all_sizes, centroids, k1, blocks, row_map = route_case(rng, "cpu", parts=parts, extra=5)
    gt, qn, _, mask = _rank_and_probe(q, centroids, torch.from_numpy(all_sizes), kind="groups",
                                      count=5)
    got = _pallas_ivf_query(q, qn, gt, mask, k1, blocks, row_map, k=10, winners=4,
                            rescore=rescore, probe=("groups", 5))
    ref = masked_sort_route(q, qn, gt, mask, k1, blocks.blk_part, row_map, k=10, winners=4,
                       rescore=rescore)
    _same_bits(got[0], ref[0])
    assert torch.equal(got[1], ref[1])


def test_k_past_the_columns_pads_as_the_route_did():
    rng = np.random.default_rng(3)
    sizes = np.array([100, 0, 30], np.int64)
    q, _, centroids, k1, blocks, row_map = route_case(rng, "cpu", num_parts=3, sizes=sizes)
    gt, qn, _, mask = _rank_and_probe(q, centroids, torch.from_numpy(sizes), kind="groups",
                                      count=2)
    nw = k1.scan(q, winners=1)[0].shape[1]
    got = _pallas_ivf_query(q, qn, gt, mask, k1, blocks, row_map, k=nw + 3, winners=1,
                            probe=("groups", 2))
    ref = masked_sort_route(q, qn, gt, mask, k1, blocks.blk_part, row_map, k=nw + 3, winners=1)
    _same_bits(got[0], ref[0])
    assert torch.equal(got[1], ref[1])


# ---------------------------------------------------------------------------
# On a card: the kernel against its plain twin, bit for bit.


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the selection kernel runs only on the card")
    return torch.device("cuda")


def _kernel_and_twin(args, winners, fetch):
    packed, _, gt, qn, mask, blocks, nblk, _ = args
    launches = tracing.counter("ivf.topk.launches")
    got = ivf_topk.ivf_select(packed, gt, qn, mask, blocks.ranges, blocks.blk_part,
                              blocks.real_blocks, winners=winners, nblk=nblk, fetch=fetch)
    torch.cuda.synchronize()
    assert tracing.counter("ivf.topk.launches") - launches == 1
    ref = ivf_topk._select_plain(packed, gt, qn, mask, blocks.ranges, blocks.blk_part,
                                 blocks.real_blocks, winners=winners, nblk=nblk, fetch=fetch)
    _same_bits(got[0], ref[0])
    assert torch.equal(got[1], ref[1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("fetch", [1, 10, 40, 3000, "all"])
@pytest.mark.parametrize("winners", [1, 2, 3, 4])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_the_kernel_equals_its_twin(card, scenario, winners, fetch):
    """Every scenario of the CPU tests on the card, 300 queries, up to
    every winner column."""
    args = select_case(scenario, winners, device=card, num_q=300)
    f = _fetch(fetch, args[0].shape[1])
    best, cols = _kernel_and_twin(args, winners, f)
    ref_best, ref_pos = cs.masked_ivf_select(*args[:5], args[5].blk_part, f)
    _same_as_masked_sort(best, cols, ref_best, ref_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["sift128", "deep96"])
def test_the_kernel_at_the_cells_shapes(card, shape):
    """sift-128's 1,000 partitions, probe 50 (rows as its cell's, about
    1,000 a partition), and deep-96's 9,990 partitions, probe 499, at
    about 300 rows a partition; W = 4, 16 blocks a row tile (K1's at
    1,024 queries), fetch 10 and 40; at sift-128's also 8,000, past what
    the kernel holds in shared memory (its buffer in global memory)."""
    rng = np.random.default_rng(5)
    num_parts, count, num_q, high = ((1000, 50, 1024, 2000) if shape == "sift128"
                                     else (9990, 499, 256, 600))
    sizes = rng.integers(100, high, num_parts).astype(np.int64)
    for fetch in (10, 40) + ((8000,) if shape == "sift128" else ()):
        assert ivf_topk.topk_plan(fetch)["shared"] == (fetch < 8000)
        args = select_case("tiles", 4, seed=fetch, device=card, num_parts=num_parts,
                           num_q=num_q, nblk=16, count=count, sizes=sizes)
        best, cols = _kernel_and_twin(args, 4, fetch)
        ref_best, ref_pos = cs.masked_ivf_select(*args[:5], args[5].blk_part, fetch)
        _same_as_masked_sort(best, cols, ref_best, ref_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("rescore", [0, 4])
def test_the_route_on_the_card_syncs_nothing(card, rescore):
    """``_pallas_ivf_query`` on the card: one kernel launch, no host sync
    once K1's operands are held, and best and ids bit for bit the route's
    over every column (K1 the same on both sides)."""
    rng = np.random.default_rng(11)
    q, all_sizes, centroids, k1, blocks, row_map = route_case(
        rng, card, num_parts=200, d=96, m=24, num_q=1024, nan_rows=(4, 900),
        sizes=rng.integers(0, 3000, 200).astype(np.int64))
    gt, qn, _, mask = _rank_and_probe(q, centroids, torch.from_numpy(all_sizes).to(card),
                                      kind="groups", count=10)
    kwargs = dict(k=10, winners=4, rescore=rescore)
    _pallas_ivf_query(q, qn, gt, mask, k1, blocks, row_map, probe=("groups", 10), **kwargs)
    torch.cuda.synchronize()
    launches = tracing.counter("ivf.topk.launches")
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _pallas_ivf_query(q, qn, gt, mask, k1, blocks, row_map, probe=("groups", 10),
                                **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tracing.counter("ivf.topk.launches") - launches == 1
    ref = masked_sort_route(q, qn, gt, mask, k1, blocks.blk_part, row_map, **kwargs)
    _same_bits(got[0], ref[0])
    assert torch.equal(got[1], ref[1])
