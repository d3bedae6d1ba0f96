"""K1's operands, held by their owner (``ops/cuda/adc.py::K1Operands``).

What depends only on the rows and the launch geometry (the padded code
operand, the hi/lo norm rows, the center, ``base_cols``, the bf16
codebooks) is built once per geometry and held by ``FlatIndex`` /
``IVFIndex`` and by each shard of their sharded forms; a batch builds its
query operand alone, in one pass. The oracle below is the construction
these replaced (every operand rebuilt per batch, the query operand by a
loop over subspaces): each operand must equal it bit for bit, so K1 sees
what it saw before. The IVF partition-padded layout of a sharded index is
held to the host construction it replaced the same way.

The CPU tests run K1's plain twin; the card tests (``cuda``) hold two
queries on one index against a freshly loaded index's first query and
against K1 on the oracle's operands, bit for bit. This file imports no
JAX, so the card runs it with ``--noconftest``."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gulon_tpu_torch as gt
from gulon_tpu_torch.ops.cuda import adc
from gulon_tpu_torch.ops.distance import sq_norms
from gulon_tpu_torch.ops.pq import split_subspaces, subspace_bounds
from gulon_tpu_torch.parallel import make_mesh, shard_index
from gulon_tpu_torch.parallel import ops as pops
from gulon_tpu_torch.probes.adc_probes import probe_scan_operands
from gulon_tpu_torch.utils import tracing

N, D, M, K_CODES = 9000, 24, 5, 256  # D = 24 over M = 5: one padded subspace lane


def _oracle(queries, codebooks, codes, recon_norms, *, bounds, tile_rows, num_rows,
            winners, center_scores):
    """The operands as they were built for every batch before an index
    held them."""
    num_q = queries.shape[0]
    m, k_codes, dsub = codebooks.shape
    pretransposed = num_rows > 0
    n = num_rows if pretransposed else codes.shape[0]
    mdp = adc.padded_depth(m, dsub)
    qt, t, _, _ = adc.block_layout(num_q, k_codes, mdp, n, tile_rows, winners)
    md = m * dsub
    dev = queries.device
    qs = split_subspaces(queries, bounds, dsub)
    q_pad = qs.permute(1, 0, 2).reshape(num_q, md) * -2.0
    if center_scores:
        nf = torch.clamp(recon_norms.to(torch.float32), max=adc._BIG)
        valid = nf < adc._INVALID_MIN
        center = torch.sum(torch.where(valid, nf, 0.0)) / torch.clamp(
            torch.sum(valid.to(torch.float32)), min=1.0
        )
        qc = sq_norms(queries) + center
        qc_hi = qc.to(torch.bfloat16).to(torch.float32)
        qn_lanes = torch.stack([qc_hi, qc - qc_hi], dim=1)
    else:
        center = torch.zeros((), dtype=torch.float32, device=dev)
        qn_lanes = torch.zeros((num_q, 2), dtype=q_pad.dtype, device=dev)
    q_pad = torch.cat(
        [q_pad, torch.ones((num_q, 2), dtype=q_pad.dtype, device=dev), qn_lanes], dim=1
    )
    q_pad = torch.nn.functional.pad(q_pad, (0, mdp - md - 4, 0, (-num_q) % qt))
    if pretransposed:
        codes_t = torch.nn.functional.pad(codes, (0, (-codes.shape[1]) % t))
    else:
        codes_i = torch.nn.functional.pad(codes.to(torch.int32), (0, 0, 0, (-n) % t))
        codes_t = codes_i.T.contiguous()
    norms = recon_norms.to(torch.float32)
    if norms.shape[0] < codes_t.shape[1]:
        norms = torch.nn.functional.pad(
            norms, (0, codes_t.shape[1] - norms.shape[0]), value=adc._BIG
        )
    nblk = t // 128
    wn = winners * nblk
    cols = np.arange(codes_t.shape[1] // t * wn, dtype=np.int64)
    base_cols = ((cols // wn) * t + (cols % wn) % nblk * 128).astype(np.int32)
    return dict(
        q_pad=q_pad, q_op=q_pad[:num_q].to(torch.bfloat16), codes_t=codes_t, norms=norms,
        norms_hl=adc._split_hi_lo(norms, center), center=center,
        base_cols=torch.from_numpy(base_cols).to(dev), qs=qs, t=t, qt=qt,
        cb=codebooks.to(torch.bfloat16).contiguous(),
    )


def _oracle_ivf_codes(index):
    """The IVF layout's code operand as it was scattered before."""
    sizes = index.partition_sizes().astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    psz = -(-sizes // 128) * 128
    pstarts = np.concatenate([[0], np.cumsum(psz)[:-1]])
    dev = index.device
    shift = torch.from_numpy(pstarts - starts).to(dev)
    dst = shift[index.group_ids.long()] + torch.arange(index.size, device=dev)
    codes_pal = torch.zeros((int(psz.sum()), index.pq.num_quantizers), dtype=torch.int32,
                            device=dev)
    codes_pal[dst] = index.codes.to(torch.int32)
    return adc.pack_codes_t(codes_pal, index.pq.num_clusters)


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    assert torch.equal(a, b)


def _problem(num_q, seed=0, dev="cpu"):
    rng = np.random.default_rng(seed)
    bounds = subspace_bounds(D, M)
    dsub = max(w for _, w in bounds)
    cb = rng.normal(size=(M, K_CODES, dsub)).astype(np.float32)
    for s, (_, w) in enumerate(bounds):
        cb[s, :, w:] = 0.0
    cb = torch.from_numpy(cb).to(torch.bfloat16).to(torch.float32)
    codes = torch.from_numpy(rng.integers(0, K_CODES, size=(N, M)).astype(np.uint8))
    norms = (cb[torch.arange(M)[None], codes.long()] ** 2).sum((1, 2))
    q = rng.normal(size=(num_q, D)).astype(np.float32)
    if num_q == 17:
        q[3, 2] = np.inf  # an infinite lane: NaN and inf lanes keep their bits too
    return bounds, cb.to(dev), codes.to(dev), norms.to(dev), torch.from_numpy(q).to(dev)


@pytest.mark.parametrize("winners", [1, 4])
@pytest.mark.parametrize("centered", [False, True], ids=["uncentered", "centered"])
@pytest.mark.parametrize("num_q", [1, 12, 17, 600])
def test_operands_equal_the_per_batch_construction(num_q, centered, winners):
    """The one-pass query operand, the held hi/lo rows, ``base_cols`` and the
    padded code operand against the oracle, pretransposed (int8) and from
    row-major codes (int32), and the probes' operands, at the own width."""
    bounds, cb, codes, norms, q = _problem(num_q, seed=num_q)
    codes_t = adc.pack_codes_t(codes, K_CODES)
    for src, rows in ((codes_t, N), (codes, 0)):
        kw = dict(bounds=bounds, num_rows=rows, center_scores=centered)
        ref = _oracle(q, cb, src, norms, tile_rows=0, winners=winners, **kw)
        k1 = adc.K1Operands(cb, src, norms, **kw)
        t, base_cols = k1.geometry(num_q, winners=winners)
        assert list(k1._base_cols) == [(t, winners)] and t == ref["t"]
        _same_bits(k1.query_operand(q), ref["q_op"])
        _same_bits(base_cols, ref["base_cols"])
        for name in ("codes_t", "norms_hl", "center", "cb"):
            _same_bits(getattr(k1, name), ref[name])
        probe = probe_scan_operands(q, cb, src, norms, winners=winners, **kw)
        for name in ("q_op", "codes_t", "norms_hl", "base_cols", "cb", "qs"):
            _same_bits(probe[name], ref[name])
        assert probe["nblk"] == ref["t"] // 128


def _flat(dev="cpu", n=N, d=D, m=M, iters=4):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, d)).astype(np.float32)
    keys = np.array([f"w{i:06d}" for i in range(n)], dtype=object)
    index = gt.build_flat_index(keys, x, pq_config=gt.PQConfig(
        num_clusters=256, num_quantizers=m, max_iters=iters), device=dev)
    index.scan_strategy = "pallas"
    index.rerank_factor = 1
    return index, x


def _ivf(dev="cpu", n=N, d=D, m=M, iters=4, partitions=12, probe=4):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, d)).astype(np.float32)
    keys = np.array([f"v{i:06d}" for i in range(n)], dtype=object)
    index = gt.build_ivf_index(
        keys, x, pq_config=gt.PQConfig(num_clusters=256, num_quantizers=m, max_iters=iters),
        num_partitions=partitions, strategy=gt.LimitGroups(probe), coarse_max_iters=iters,
        device=dev)
    index.scan_strategy = "pallas"
    return index, x


@pytest.fixture(scope="module")
def flat():
    return _flat()


@pytest.fixture(scope="module")
def ivf():
    return _ivf()


def _fresh(index):
    return dataclasses.replace(index, **dict.fromkeys(index._LAZY_OPERANDS))


@pytest.mark.parametrize("holder", ["direct", "flat", "ivf"])
def test_operand_builds_once_per_geometry(holder, flat, ivf):
    """Three batches through one holder build the index part once; a batch
    whose row tile differs (4 winners: 4096 rows at 12 queries, 2048 at 600)
    builds its own, and as its width differs it replaces the first."""
    if holder == "direct":
        bounds, cb, codes, norms, _ = _problem(1)
        k1 = adc.K1Operands(cb, adc.pack_codes_t(codes, K_CODES), norms, bounds=bounds,
                            num_rows=N)

        def query(q):
            adc.scan_top_k(k1, q, k=10, winners=4)
    else:
        index = _fresh((flat if holder == "flat" else ivf)[0])
        index.pallas_winners = 4

        def query(q):
            index.query_arrays(10, q)
    q = torch.from_numpy(np.random.default_rng(3).normal(size=(600, D)).astype(np.float32))
    builds, launches = tracing.counter("k1.operand_builds"), tracing.counter("k1.launches")
    for _ in range(3):
        query(q[:12])
    assert tracing.counter("k1.operand_builds") - builds == 1
    assert tracing.counter("k1.launches") == launches  # the plain twin on the CPU
    query(q)
    query(q)
    assert tracing.counter("k1.operand_builds") - builds == 2
    k1 = k1 if holder == "direct" else index._k1_operands
    assert list(k1._base_cols) == [(2048, 4)]


def test_geometries_of_one_width_share_the_code_operand():
    """A row count that both row tiles divide: the second geometry reuses
    the first's code operand and norm rows, and both stay held."""
    bounds, cb, codes, norms, q = _problem(600)
    codes_t = adc.pack_codes_t(codes[:8192], K_CODES)
    k1 = adc.K1Operands(cb, codes_t, norms[:8192], bounds=bounds, num_rows=8192)
    t_small, _ = k1.geometry(12, winners=4)
    held = (k1.codes_t, k1.norms_hl)
    t_big, base_cols = k1.geometry(600, winners=4)
    assert (t_small, t_big) == (4096, 2048) and len(k1._base_cols) == 2
    assert k1.codes_t is held[0] and k1.norms_hl is held[1]
    ref = _oracle(q, cb, codes_t, norms[:8192], bounds=bounds, num_rows=8192, winners=4,
                  tile_rows=0, center_scores=False)
    _same_bits(base_cols, ref["base_cols"])
    for name in ("codes_t", "norms_hl"):
        _same_bits(getattr(k1, name), ref[name])


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_update_drops_the_held_operands_and_a_view_adopts_them(kind, flat, ivf):
    index, x = flat if kind == "flat" else ivf
    index = _fresh(index)
    keys = index.key_index.keys
    index.query_arrays(10, x[:16])
    assert index._k1_operands
    for new in (index.add(["zz-new"], x[:1] + 0.5), index.remove([keys[0]])):
        assert new._k1_operands is None
    fresh = _fresh(index)
    view = dataclasses.replace(fresh, scan_strategy="pallas")
    view.query_arrays(10, x[:16])
    fresh._adopt_operands(view)
    assert fresh._k1_operands is view._k1_operands
    builds = tracing.counter("k1.operand_builds")
    fresh.query_arrays(10, x[:16])
    assert tracing.counter("k1.operand_builds") == builds


def _index_oracle(index, q):
    """The oracle's operands for a batch ``q`` (prepared) of the index's
    ``pallas`` route."""
    if isinstance(index, gt.IVFIndex):
        rc_pal = index._pallas_operands()[0]
        codes_t, norms, winners, centered = _oracle_ivf_codes(index), rc_pal, \
            index.pallas_winners, False
    else:
        codes_t = adc.pack_codes_t(index.codes, index.pq.num_clusters)
        norms, winners, centered = index.recon_norms, index.resolved_pallas_winners(), True
    return _oracle(q, index.pq.codebooks, codes_t, norms, bounds=index.pq.bounds,
                   tile_rows=0, num_rows=codes_t.shape[1], winners=winners,
                   center_scores=centered)


def _check_entry_against_oracle(index, q):
    """The index's one held geometry and its operands equal the oracle's,
    and K1 (or its twin) gives the same packed winners on both."""
    k1 = index._k1_operands
    ((t, winners),) = k1._base_cols
    ref = _index_oracle(index, q)
    _same_bits(k1._base_cols[(t, winners)], ref["base_cols"])
    for name in ("codes_t", "norms_hl", "cb"):
        _same_bits(getattr(k1, name), ref[name])
    q_op = k1.query_operand(q)
    _same_bits(q_op, ref["q_op"])
    kw = dict(winners=winners, nblk=t // 128)
    _same_bits(adc.fused_block_scan(k1.codes_t, k1.norms_hl, q_op, k1.cb, **kw),
               adc.fused_block_scan(ref["codes_t"], ref["norms_hl"], ref["q_op"], ref["cb"], **kw))


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_the_held_entry_equals_the_per_batch_construction(kind, flat, ivf):
    index, x = flat if kind == "flat" else ivf
    index = _fresh(index)
    index.query_arrays(10, x[:40])
    _check_entry_against_oracle(index, index._prepare_queries(x[:40]))


def _batches(query, q, n=3):
    builds = tracing.counter("k1.operand_builds")
    out = [query(q) for _ in range(n)]
    return out, tracing.counter("k1.operand_builds") - builds


@pytest.mark.parametrize("shards", [1, 2])
def test_the_shards_of_a_sharded_flat_index_hold_their_operands(flat, monkeypatch, shards):
    """K1 forced on the CPU mesh (its plain twin, as ``force_kernel`` runs
    it): each shard builds its operands once over three batches, and the
    answers equal the scan over operands built for each call."""
    index, x = flat
    index = _fresh(index)
    sharded = shard_index(index, make_mesh(devices=["cpu"] * shards))
    monkeypatch.setattr(pops, "scan_flat_shards",
                        functools.partial(pops.scan_flat_shards, force_kernel=True))
    q = index._prepare_queries(x[:24] + 0.01)
    got, builds = _batches(lambda b: sharded.query_arrays(10, b), x[:24] + 0.01)
    assert builds == shards and all(k1 is not None for k1 in sharded.k1_sharded)
    ref = pops.sharded_adc_scan(
        q, sharded.codebooks_rep, sharded.codes_sharded, sharded.norms_sharded,
        mesh=sharded.mesh, bounds=index.pq.bounds, k=10,
        winners=index.resolved_pallas_winners(), force_kernel=True,
    )
    for d, ids in got:
        _same_bits(d, ref[0])
        _same_bits(ids, ref[1])


@pytest.mark.parametrize("shards", [1, 2])
def test_the_shards_of_a_sharded_ivf_index_hold_their_operands(ivf, shards):
    """The ``pallas`` route per shard: each shard builds its operands once
    over three batches, which answer alike."""
    index, x = ivf
    sharded = shard_index(_fresh(index), make_mesh(devices=["cpu"] * shards))
    got, builds = _batches(lambda b: sharded.query_arrays(10, b), x[:24] + 0.01)
    assert builds == shards
    for d, ids in got[1:]:
        _same_bits(d, got[0][0])
        _same_bits(ids, got[0][1])


def _oracle_shard_layouts(sharded):
    """Each shard's partition-padded layout as the host built it before the
    layout had one function: ``(codes_t, row constants, blk_part, row
    map)``, one ``npad`` for every shard, row maps holding global rows."""
    base = sharded.base
    sizes = base.partition_sizes().astype(np.int64)
    num_p = len(sizes)
    n_shards = sharded.mesh.shape["rows"]
    g_starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    psz = -(-sizes // 128) * 128
    pstart = np.zeros(num_p, np.int64)
    fill = np.zeros(n_shards, np.int64)
    for p in np.argsort(sharded.local_starts, kind="stable"):
        s = int(sharded.part_shard[p])
        pstart[p] = fill[s]
        fill[s] += psz[p]
    npad = max(int(fill.max()) if num_p else 128, 128)
    codes_np = base.codes.cpu().numpy().astype(np.int32)
    rc_np = base.row_const.cpu().numpy().astype(np.float32)
    codes_pal = np.zeros((n_shards, npad, base.pq.num_quantizers), np.int32)
    rc_pal = np.full((n_shards, npad), 2.0e38, np.float32)
    rmap = np.full((n_shards, npad), -1, np.int32)
    blk_part = np.zeros((n_shards, npad // 128), np.int64)
    for p in range(num_p):
        s, ls = int(sharded.part_shard[p]), int(pstart[p])
        gs, sz = int(g_starts[p]), int(sizes[p])
        codes_pal[s, ls : ls + sz] = codes_np[gs : gs + sz]
        rc_pal[s, ls : ls + sz] = rc_np[gs : gs + sz]
        rmap[s, ls : ls + sz] = np.arange(gs, gs + sz, dtype=np.int32)
        blk_part[s, ls // 128 : (ls + int(psz[p])) // 128] = p
    return [
        (adc.pack_codes_t(torch.from_numpy(codes_pal[r]), base.pq.num_clusters),
         torch.from_numpy(rc_pal[r]), torch.from_numpy(blk_part[r]), torch.from_numpy(rmap[r]))
        for r in range(n_shards)
    ]


@pytest.mark.parametrize("shards", [1, 2])
def test_a_shards_ivf_layout_equals_the_host_construction(ivf, shards):
    """``partition_layout`` over each shard's partitions, in their local
    order, against the numpy construction it replaced, bit for bit."""
    index, _ = ivf
    sharded = shard_index(_fresh(index), make_mesh(devices=["cpu"] * shards))
    layouts = sharded._pallas_layouts()
    for (k1, blocks, rmap), (codes_t, rc_pal, blk_ref, rmap_ref) in zip(
        layouts, _oracle_shard_layouts(sharded)
    ):
        k1.geometry(16, winners=4)
        _same_bits(k1.codes_t[:, : k1.n], codes_t)
        assert not bool(k1.codes_t[:, k1.n :].any())  # the row tile's padding
        for got, ref in ((k1.norms, rc_pal), (blocks.blk_part, blk_ref), (rmap, rmap_ref)):
            _same_bits(got, ref)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K1 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_two_batches_on_the_card_equal_a_fresh_index(card, kind, tmp_path):
    """A 1024-query batch, twice on one index: the second waits on the query
    upload alone and builds nothing; both equal a freshly loaded index's
    first batch bit for bit, and K1 on the held operands equals K1 on the
    oracle's."""
    if kind == "flat":
        index, x = _flat(card, n=262_144, d=96, m=12, iters=5)
    else:
        index, x = _ivf(card, n=262_144, d=96, m=12, iters=5, partitions=200, probe=20)
    q = x[:1024] + 0.01
    builds = tracing.counter("k1.operand_builds")
    first = index.query_arrays(10, q)
    with tracing.span("gulon.test.off"):  # the profiled session starts afresh
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        second = index.query_arrays(10, q)
    torch.cuda.synchronize()
    spans = tracing.snapshot()["spans"]
    waits = {name: v["count"] for name, v in spans.items() if name.startswith("gulon.wait.")}
    assert waits == {"gulon.wait.upload_queries": 1}
    assert tracing.counter("k1.operand_builds") - builds == 1
    path = tmp_path / "index.pb"
    gt.save_index(index, path)
    fresh = gt.load_index(path, device=card)
    fresh.scan_strategy = "pallas"
    if kind == "flat":
        fresh.rerank_factor = index.rerank_factor
    third = fresh.query_arrays(10, q)
    for got in (first, second):
        for a, b in zip(got, third):
            _same_bits(a, b)
    _check_entry_against_oracle(index, index._prepare_queries(q))
