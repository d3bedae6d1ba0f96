"""Port parity: the IVF residual index (``gulon_tpu_torch/models/ivf.py``).

Module by module, the same seeded numpy inputs go through the JAX
function and its port: ``centroid_code_dot`` and the row constants (rtol
1e-5), ``ivf_block_rescore``, the probe masks, the entry planner (array
equal), and every scan strategy on one index served by both packages
through ``from_reference``. The corpus is Gaussian, so rows have
distinct codes and no equal-distance ties: ids are held equal, distances
within 1e-4 (``precision="highest"``; the fused strategy's distances are
bf16-contract sums that differ only in f32 summation order, held to the
same 1e-4). The JAX fused strategy runs its Pallas kernel in interpret
mode, the port K1's plain twin. A port-built index is held to >= 0.99x
the recall@10 of a JAX-built one (the k-means draws differ).
"""

import dataclasses

import numpy as np
import pytest
import torch

from generators import planted_clusters, random_keys
import jax.numpy as jnp

from gulon_tpu.models import build as jbuild_mod
from gulon_tpu.models import ivf as jivf
from gulon_tpu.models.build import build_ivf_index as jax_build
from gulon_tpu.models.metric import Metric as JaxMetric
from gulon_tpu.ops import scan as jscan
from gulon_tpu.ops.pq import PQConfig as JaxPQConfig
from gulon_tpu.utils import eval as jeval
from gulon_tpu_torch.models.metric import Metric
from gulon_tpu_torch import interop
from gulon_tpu_torch.models import build as tbuild_mod
from gulon_tpu_torch.models import ivf as tivf
from gulon_tpu_torch.models.build import build_ivf_index
from gulon_tpu_torch.models.ivf import IVFIndex, LimitGroups, LimitVectors
from gulon_tpu_torch.ops import scan as tscan
from gulon_tpu_torch.ops.cuda import adc as tadc
from gulon_tpu_torch.ops.pq import PQConfig
from gulon_tpu_torch.utils import eval as teval
from gulon_tpu_torch.utils import tracing

torch.set_num_threads(2)

N, D = 8192, 24
PQ = dict(num_clusters=32, num_quantizers=6, max_iters=8)
J_STRATEGIES = {
    "groups": jivf.LimitGroups(4),
    "vectors": jivf.LimitVectors(2000),
}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, D)).astype(np.float32)
    keys = random_keys(rng, N)
    q = x[:32] + 0.05 * rng.normal(size=(32, D)).astype(np.float32)
    return x, keys, q


@pytest.fixture(scope="module")
def jax_index(data):
    x, keys, _ = data
    return jax_build(
        keys, x, pq_config=JaxPQConfig(**PQ), num_partitions=16,
        strategy=jivf.LimitGroups(4), coarse_max_iters=8,
    )


def _jax_variant(jx, **knobs):
    """A fresh JAX index over the same arrays (no lazy layouts or cache)."""
    return dataclasses.replace(
        jx, recon_cache=None, recon_norms_cache=None, _codes_pad=None,
        _row_const_pad=None, _pallas_layout=None, _sizes_dev=None, **knobs,
    )


def _probed(index_centroids, q, strategy, sizes):
    """Reference probe sets, host-side (``Index.scala:285-299``)."""
    cd = ((q[:, None, :] - index_centroids[None]) ** 2).sum(-1)
    out = []
    for row in cd:
        order = np.argsort(row, kind="stable")
        if isinstance(strategy, LimitGroups):
            out.append(set(order[: strategy.count]))
        else:
            cum, probed = 0, set()
            for g in order:
                if cum >= strategy.count:
                    break
                probed.add(g)
                cum += sizes[g]
            out.append(probed)
    return out


def test_centroid_code_dot_and_row_const(jax_index):
    jx = jax_index
    port = interop.from_reference(jx, device="cpu")
    args = (np.asarray(jx.codes), np.asarray(jx.centroids), np.asarray(jx.group_ids))
    ref = jx.pq.centroid_code_dot(*args, chunk_rows=3000)
    got = port.pq.centroid_code_dot(*args, chunk_rows=3000)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    rc = port.pq.reconstruction_norms(port.codes) + 2.0 * got
    np.testing.assert_allclose(rc.numpy(), np.asarray(jx.row_const), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [3, 10])
def test_ivf_block_rescore_matches(jax_index, k):
    """The exact f32 re-rank on the index's own partition-padded operand
    (int8 offset codes), with invalid slots."""
    jx = _jax_variant(jax_index)
    codes_t, rc_pal, _, _, npad = jx._pallas_operands()
    rng = np.random.default_rng(k)
    num_q, fetch = 6, 40
    q = rng.normal(size=(num_q, D)).astype(np.float32)
    real = np.nonzero(np.asarray(rc_pal) < 1e38)[0]
    rows = rng.choice(real, size=(num_q, fetch)).astype(np.int32)
    vals = rng.normal(size=(num_q, fetch)).astype(np.float32)
    vals[:, -5:] = np.inf  # invalid slots
    gt = rng.normal(size=(num_q, fetch)).astype(np.float32)
    qn = (q * q).sum(1)
    dj, rj = jscan.ivf_block_rescore(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(jx.pq.codebooks), codes_t,
        rc_pal, jnp.asarray(vals), jnp.asarray(rows), jnp.asarray(gt),
        bounds=jx.pq.bounds, k=k,
    )
    ct = _t(codes_t)
    assert ct.dtype == torch.int8 and ct.shape[1] == npad
    dt, rt = tscan.ivf_block_rescore(
        _t(q), _t(qn), _t(jx.pq.codebooks), ct, _t(rc_pal), _t(vals),
        _t(rows), _t(gt), bounds=jx.pq.bounds, k=k,
    )
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-5)


def test_probe_masks_match():
    """Both probe rules on one cdist, ties included (equal distances keep
    the lower centroid in LimitGroups; LimitVectors sorts stably)."""
    rng = np.random.default_rng(3)
    cdist = rng.normal(size=(40, 30)).astype(np.float32)
    cdist[:, 7] = cdist[:, 3]  # exact ties
    sizes = rng.integers(1, 200, size=30).astype(np.int32)
    for count in (1, 4, 30, 50):
        np.testing.assert_array_equal(
            tivf._probe_mask_limit_groups(_t(cdist), count).numpy(),
            np.asarray(jivf._probe_mask_limit_groups(jnp.asarray(cdist), count)),
        )
    for count in (1, 150, 900, 10_000):
        np.testing.assert_array_equal(
            tivf._probe_mask_limit_vectors(_t(cdist), _t(sizes), count).numpy(),
            np.asarray(
                jivf._probe_mask_limit_vectors(
                    jnp.asarray(cdist), jnp.asarray(sizes), count
                )
            ),
        )


@pytest.mark.parametrize("kind", ["groups", "vectors"])
def test_rank_and_probe_matches(data, jax_index, kind):
    _, _, q = data
    jx = jax_index
    sizes = jx.partition_sizes()
    count = 4 if kind == "groups" else 2000
    gj, qnj, cdj, pmj = jivf._rank_and_probe(
        jnp.asarray(q), jx.centroids, jnp.asarray(sizes), kind=kind, count=count
    )
    gt_, qnt, cdt, pmt = tivf._rank_and_probe(
        _t(q), _t(jx.centroids), _t(sizes), kind=kind, count=count
    )
    np.testing.assert_allclose(gt_.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(cdt.numpy(), np.asarray(cdj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(qnt.numpy(), np.asarray(qnj), rtol=1e-6)
    np.testing.assert_array_equal(pmt.numpy(), np.asarray(pmj))


@pytest.mark.parametrize("rcap,qcap", [(512, 8), (64, 16)])
def test_plan_entry_schedule_matches(rcap, qcap):
    rng = np.random.default_rng(rcap + qcap)
    sizes = np.array([1300, 7, 430, 256, 3, 0, 90], np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    probe = rng.integers(-1, len(sizes), (50, 3)).astype(np.int32)
    probe[:30, 0] = 0  # a hot partition spans several query sub-buckets
    got = tivf._plan_entry_schedule(probe, sizes, starts, rcap, qcap, 4)
    ref = jivf._plan_entry_schedule(probe, sizes, starts, rcap, qcap, 4)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype
    empty = np.full((5, 2), -1, np.int32)  # no pairs: all-padding schedule
    for g, r in zip(
        tivf._plan_entry_schedule(empty, sizes, starts, rcap, qcap, 4),
        jivf._plan_entry_schedule(empty, sizes, starts, rcap, qcap, 4),
    ):
        np.testing.assert_array_equal(g, r)


# (scan_strategy, pallas_winners, pallas_rescore, reconstruction cache)
STRATEGY_CASES = [
    ("masked", 4, 0, False),
    ("gathered", 4, 0, False),
    ("bucketed", 4, 0, False),
    ("gathered", 4, 0, True),
    ("bucketed", 4, 0, True),
    ("pallas", 1, 0, False),
    ("pallas", 2, 0, False),
    ("pallas", 4, 0, False),
    ("pallas", 1, 4, False),
    ("pallas", 2, 4, False),
    ("pallas", 4, 4, False),
]


@pytest.mark.parametrize("kind", ["groups", "vectors"])
@pytest.mark.parametrize("strategy,winners,rescore,cache", STRATEGY_CASES)
def test_strategy_matches_jax(data, jax_index, kind, strategy, winners, rescore, cache):
    """One index served by both packages: ids equal, distances within
    1e-4, and every returned id inside its query's probed partitions."""
    x, _, q = data
    jx = _jax_variant(
        jax_index, strategy=J_STRATEGIES[kind], scan_strategy=strategy,
        pallas_winners=winners, pallas_rescore=rescore, precision="highest",
    )
    if cache:
        jx.enable_cache()
    port = interop.from_reference(jx, device="cpu")
    assert isinstance(port, IVFIndex)
    assert (port.recon_cache is not None) == cache
    assert port.resolve_strategy(len(q), 10) == strategy
    dj, ij = map(np.asarray, jx.query_arrays(10, q))
    dt, it = port.query_arrays(10, q)
    assert it.dtype == torch.int32 and dt.shape == (len(q), 10)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-4, atol=1e-4)
    gids = port.group_ids.numpy()
    probed = _probed(
        port.centroids.numpy(), q, port.strategy, port.partition_sizes()
    )
    for row, want in zip(it.numpy(), probed):
        assert set(gids[row[row >= 0]]) <= want


@pytest.mark.parametrize("cache", [False, True])
def test_bucketed_chunked_selection_matches_one_shot(data, jax_index, monkeypatch, cache):
    """Above ``_FLAT_TOPK_BYTES`` the entry top-k runs per chunk of
    entries; small chunks and the per-chunk selection change no result."""
    _, _, q = data
    port = interop.from_reference(
        _jax_variant(jax_index, scan_strategy="bucketed", precision="highest"), device="cpu"
    )
    if cache:
        port.enable_cache()
    d1, i1 = port.query_arrays(10, q)
    monkeypatch.setattr(tivf, "_FLAT_TOPK_BYTES", 0)
    monkeypatch.setattr(tivf, "_ENTRY_CHUNK_BYTES", 0)
    d2, i2 = port.query_arrays(10, q)
    np.testing.assert_array_equal(i2.numpy(), i1.numpy())
    np.testing.assert_array_equal(d2.numpy(), d1.numpy())


def test_pallas_without_rescore_is_block_granular(data, jax_index):
    """The raw fused epilogue reports bf16-contract distances near the
    exact ones; rescore turns them into the masked scan's exact f32
    distances."""
    _, _, q = data
    port = interop.from_reference(_jax_variant(jax_index, precision="highest"), device="cpu")
    port.scan_strategy = "masked"
    dm, _ = port.query_arrays(10, q)
    port.scan_strategy = "pallas"
    dp, _ = port.query_arrays(10, q)
    port.pallas_rescore = 4
    dr, _ = port.query_arrays(10, q)
    np.testing.assert_allclose(dp.numpy()[:, 0], dm.numpy()[:, 0], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(dr.numpy(), dm.numpy(), rtol=1e-5, atol=1e-5)


def test_resolve_auto_matches_jax(data, jax_index):
    jx = _jax_variant(jax_index)
    port = interop.from_reference(jx, device="cpu")
    assert port.scan_strategy == jx.scan_strategy == "auto"
    for strategy in (jivf.LimitGroups(1), jivf.LimitGroups(4), jivf.LimitVectors(300),
                     jivf.LimitVectors(2000)):
        jx.strategy = strategy
        port.strategy = interop.from_reference(jx, device="cpu").strategy
        for num_q in (1, 4, 8, 32, 33, 256, 1024):
            for k in (1, 10, 200):
                assert port._resolve_auto(num_q, k) == jx._resolve_auto(num_q, k)
    # on the CPU covering batches take the masked scan, never the kernel
    port.strategy = LimitGroups(4)
    assert port._resolve_auto(1024, 10) == "masked"
    assert port.resolve_strategy(1, 10) == "gathered"
    port.scan_strategy = "pallas"
    assert port.resolve_strategy(1024, 10) == "pallas"
    assert port.resolve_strategy(1024, 200) == "masked"  # k > 128


def test_build_ivf_invariants_and_recall():
    """The port's build keeps the grouping invariants and reaches >= 0.99x
    the recall@10 of the JAX build on the same data (the coarse and PQ
    k-means draws differ, so the builds are held by recall)."""
    rng = np.random.default_rng(11)
    x, _, _ = planted_clusters(rng, 6000, 16, 24, scale=0.3, spread=2.0)
    keys = random_keys(rng, 6000)
    cfg = dict(num_clusters=64, num_quantizers=8, max_iters=10)
    kw = dict(num_partitions=12, coarse_max_iters=10)
    port = build_ivf_index(
        keys, x, pq_config=PQConfig(**cfg), strategy=LimitGroups(4), device="cpu", **kw
    )
    jx = jax_build(keys, x, pq_config=JaxPQConfig(**cfg), strategy=jivf.LimitGroups(4), **kw)
    assert port.num_partitions == len(port.key_index.group_offsets) + 1
    assert (port.partition_sizes() > 0).all()
    gids = port.group_ids.numpy()
    assert np.all(np.diff(gids) >= 0)
    assert sorted(port.key_index.keys) == sorted(keys)
    for g in range(port.num_partitions):
        s, e = port.key_index.group_bounds(g)
        assert list(port.key_index.keys[s:e]) == sorted(port.key_index.keys[s:e])
        assert (gids[s:e] == g).all()
    # row constants as the build defines them
    crdot = port.pq.centroid_code_dot(port.codes, port.centroids, port.group_ids)
    torch.testing.assert_close(
        port.row_const, port.pq.reconstruction_norms(port.codes) + 2.0 * crdot
    )
    truth = jeval.sample_ground_truth(keys, x, num_samples=500, ks=(10,))
    port.scan_strategy = jx.scan_strategy = "masked"
    r_port = teval.recall_of(port, truth, x, keys)[10].mean
    r_jax = jeval.recall_of(jx, truth, x, keys)[10].mean
    assert r_port >= 0.99 * r_jax, (r_port, r_jax)


def test_default_partitions_limit_and_split():
    assert tbuild_mod.default_num_partitions(1_000_000) == 1000
    for n in (10, 999, 5000, 1_000_000):
        assert tbuild_mod.default_num_partitions(n) == jbuild_mod.default_num_partitions(n)
    for p in (1, 20, 100, 1000):
        assert tbuild_mod.default_limit(p) == jbuild_mod.default_limit(p)
    rng = np.random.default_rng(77)
    blob = rng.normal(0, 0.05, (300, 8)).astype(np.float32)
    rest, _, _ = planted_clusters(rng, 300, 8, 6, scale=0.2, spread=3.0)
    x = np.concatenate([blob + 5.0, rest])
    assign = np.r_[np.zeros(300, np.int64), rng.integers(1, 4, 300)]
    cents = np.stack([x[assign == j].mean(0) for j in range(4)]).astype(np.float32)
    got = tbuild_mod._split_oversized_partitions(lambda r: x[r], assign, cents, 64, 3)
    ref = jbuild_mod._split_oversized_partitions(lambda r: x[r], assign, cents, 64, 3)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert np.bincount(got[0]).max() <= 64


def test_build_max_partition_size_and_cosine():
    rng = np.random.default_rng(9)
    x, _, _ = planted_clusters(rng, 1200, 8, 6, scale=0.3, spread=2.0)
    keys = random_keys(rng, 1200)
    pq = PQConfig(num_clusters=16, num_quantizers=4, max_iters=6)
    index = build_ivf_index(
        keys, x, pq_config=pq, num_partitions=4, strategy=LimitGroups(3),
        coarse_max_iters=6, max_partition_size=150, device="cpu",
    )
    assert index.partition_sizes().max() <= 150
    res = index.query_by_word(5, keys[3])
    assert keys[3] in set(res.keys)
    cos = build_ivf_index(
        keys, x * 7.0, metric=Metric.COSINE, pq_config=pq, num_partitions=4,
        strategy=LimitGroups(4), coarse_max_iters=6, device="cpu",
    )
    assert cos.metric is Metric.COSINE
    assert keys[0] in set(cos.query(3, x[0] * 0.5).keys)  # scale-free
    with pytest.raises(ValueError):
        build_ivf_index(keys, x, pq_config=pq, num_partitions=4, max_partition_size=0, device="cpu")


def test_enable_cache_matches_jax(jax_index):
    jx = _jax_variant(jax_index)
    jx.enable_cache()  # f32 on the CPU
    port = interop.from_reference(jx, device="cpu")
    assert port.recon_cache.dtype == torch.float32
    np.testing.assert_array_equal(port.recon_cache.numpy(), np.asarray(jx.recon_cache))
    np.testing.assert_allclose(
        port.recon_norms_cache.numpy(), np.asarray(jx.recon_norms_cache), rtol=1e-6
    )
    jb = _jax_variant(jax_index)
    jb.enable_cache(dtype=jnp.bfloat16)
    pb = interop.from_reference(jb, device="cpu")
    assert pb.recon_cache.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pb.recon_cache.to(torch.float32).numpy(),
        np.asarray(jb.recon_cache.astype(jnp.float32)),
    )


def test_query_lookup_and_batch_results(data, jax_index):
    x, keys, q = data
    jx = _jax_variant(jax_index, precision="highest")
    port = interop.from_reference(jx, device="cpu")
    assert port.strategy == LimitGroups(4) and port.num_partitions == 16
    word = jx.key_index.keys[321]
    np.testing.assert_allclose(port.lookup(word), jx.lookup(word), rtol=1e-6, atol=1e-6)
    assert port.lookup("no-such-word") is None
    res, ref = port.query(5, q[0]), jx.query(5, q[0])
    assert list(res.keys) == list(ref.keys)
    np.testing.assert_allclose(res.distances, ref.distances, rtol=1e-4, atol=1e-4)
    assert port.query_by_word(3, word).keys[0] == word
    batch = port.batch_query(4, q[:3])
    assert len(batch) == 3 and all(len(r) == 4 for r in batch)
    with pytest.raises(ValueError):
        port.query_arrays(5, q[:2, :10])  # wrong dimension
    with pytest.raises(ValueError):
        dataclasses.replace(port, scan_strategy="compacted").query_arrays(5, q[:40])


def test_cosine_index_matches_jax(data):
    x, keys, q = data
    jx = jax_build(
        keys[:3000], x[:3000] * 3.0, metric=JaxMetric.COSINE,
        pq_config=JaxPQConfig(**PQ), num_partitions=8,
        strategy=jivf.LimitGroups(3), coarse_max_iters=6,
    )
    jx.precision = "highest"
    port = interop.from_reference(jx, device="cpu")
    assert port.metric is Metric.COSINE
    for strategy in ("masked", "pallas", "gathered"):
        jx.scan_strategy = port.scan_strategy = strategy
        dj, ij = map(np.asarray, jx.query_arrays(10, q[:8] * 5.0))
        dt, it = port.query_arrays(10, q[:8] * 5.0)
        np.testing.assert_array_equal(it.numpy(), ij)
        np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-4, atol=1e-4)


def test_pallas_falls_back_below_the_envelope(data, jax_index):
    """Below 1024 rows the pallas strategy serves through the masked scan,
    as the JAX package's does; k wider than a small corpus pads."""
    x, keys, q = data
    jx = _jax_variant(jax_index)
    port = interop.from_reference(jx, device="cpu")
    sizes = port.partition_sizes()
    small = interop.ivf_index_from_numpy(
        port.key_index.keys[: sizes[0] + sizes[1]], [int(sizes[0])],
        port.pq.codebooks.numpy(), port.pq.bounds, 32,
        port.codes[: sizes[0] + sizes[1]].numpy(),
        port.row_const[: sizes[0] + sizes[1]].numpy(),
        port.group_ids[: sizes[0] + sizes[1]].numpy(),
        port.centroids[:2].numpy(), device="cpu",
    )
    assert small.size < 1024 and small.strategy == LimitGroups(5)
    small.scan_strategy = "pallas"
    assert small.resolve_strategy(8, 5) == "masked"
    dp, ip = small.query_arrays(5, q[:8])
    small.scan_strategy = "masked"
    dm, im = small.query_arrays(5, q[:8])
    np.testing.assert_array_equal(ip.numpy(), im.numpy())
    d2, i2 = small.query_arrays(small.size + 3, q[:2])
    assert i2.shape == (2, small.size) and (i2.numpy() >= 0).all()


def test_mesh_build_equals_single_process(data):
    """``mesh=`` (four logical CPU shards) runs the coarse k-means, the
    residual PQ training and the encode over the mesh and builds the
    single-process index: the same partitions and codes, centroids and
    row constants within 1e-5."""
    from gulon_tpu_torch.parallel import make_mesh

    x, keys, _ = data
    args = dict(pq_config=PQConfig(**PQ), num_partitions=16, strategy=LimitGroups(4),
                coarse_max_iters=8, device="cpu")
    one = build_ivf_index(keys[:4000], x[:4000], **args)
    mesh = build_ivf_index(keys[:4000], x[:4000], mesh=make_mesh(devices=["cpu"] * 4), **args)
    np.testing.assert_array_equal(mesh.partition_sizes(), one.partition_sizes())
    assert torch.equal(mesh.codes, one.codes)
    np.testing.assert_allclose(mesh.centroids.numpy(), one.centroids.numpy(), atol=1e-5)
    np.testing.assert_allclose(mesh.row_const.numpy(), one.row_const.numpy(), atol=1e-5)


def test_deferred_paths_raise(data, jax_index):
    x, keys, _ = data
    port = interop.from_reference(jax_index, device="cpu")
    pq = PQConfig(num_clusters=8, num_quantizers=4, max_iters=2)
    # add/remove, OPQ, rotations and mesh builds are ported
    # (tests/test_torch_update.py, test_torch_opq.py, test_torch_parallel.py);
    # a mesh that is not a parallel.Mesh raises
    for call in (
        lambda: build_ivf_index(
            keys[:500], x[:500], pq_config=pq, num_partitions=2, mesh=object(), device="cpu"
        ),
    ):
        with pytest.raises(TypeError, match="parallel.Mesh"):
            call()
    rotated = interop.from_reference(
        dataclasses.replace(jax_index, rotation=jnp.eye(D, dtype=jnp.float32)), device="cpu"
    )
    assert torch.equal(rotated.rotation, torch.eye(D))


def test_cpu_index_never_counts_a_kernel_launch(data, jax_index):
    _, _, q = data
    port = interop.from_reference(_jax_variant(jax_index, scan_strategy="pallas"), device="cpu")
    before = tracing.counter("k1.launches")
    port.query_arrays(10, q)
    assert tracing.counter("k1.launches") == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K1 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_w4_on_ivf_operands_on_the_card(cuda_device, data, jax_index):
    """K1 at 4 winners, uncentered, over the partition-padded layout
    (sentinel padding rows): against its plain twin, and the IVF pallas
    strategy launches it once per batch."""
    _, _, q = data
    port = interop.from_reference(jax_index, device=cuda_device)
    args, nblk = port._k1().operands(_t(q).to(cuda_device), winners=4, tile_rows=1024)
    assert nblk == 8
    got = tadc.fused_block_scan(*args, winners=4, nblk=8)
    ref = tadc._block_scan_plain(*args, winners=4, nblk=8)
    base = torch.zeros(got.shape[1], dtype=torch.int32, device=cuda_device)
    vk, ik = (a.cpu().numpy() for a in tadc.unpack_block_winners(got, base))
    vp, ip = (a.cpu().numpy() for a in tadc.unpack_block_winners(ref, base))
    assert np.mean(ik == ip) >= 0.995
    np.testing.assert_array_equal(vk < tadc._INVALID_MIN, vp < tadc._INVALID_MIN)
    assert np.all(np.abs(vk - vp) <= 2.0 ** -14 * np.maximum(np.abs(vp), 1.0))
    port.scan_strategy = "pallas"
    before = tracing.counter("k1.launches")
    _, ids = port.query_arrays(10, q)
    assert tracing.counter("k1.launches") == before + 1 and ids.is_cuda


@pytest.mark.parametrize(
    "strategy,raises",
    [("masked", None), ("pallas", ZeroDivisionError), ("gathered", ZeroDivisionError),
     ("bucketed", ZeroDivisionError), ("auto", ZeroDivisionError)],
)
def test_zero_queries_match_jax(data, jax_index, strategy, raises):
    """A batch of zero queries: ``masked`` gives ``[0, 10]`` arrays in both
    packages; the fused and sublinear strategies (and ``auto``, which
    picks a sublinear one for a small batch) refuse it in both: the JAX
    package's planners divide by Q."""
    x = data[0]
    jx = _jax_variant(jax_index, scan_strategy=strategy)
    port = interop.from_reference(jx, device="cpu")
    q0 = np.zeros((0, x.shape[1]), np.float32)
    if raises:
        with pytest.raises(raises):
            jx.query_arrays(10, q0)
        with pytest.raises(Exception):
            port.query_arrays(10, q0)
        return
    dj, ij = jx.query_arrays(10, q0)
    dt, it = port.query_arrays(10, q0)
    assert dt.shape == it.shape == np.asarray(dj).shape == np.asarray(ij).shape == (0, 10)
    assert port.batch_query(10, q0) == jx.batch_query(10, q0) == []


@pytest.mark.parametrize("strategy", ["masked", "pallas", "gathered", "bucketed", "auto"])
def test_k0_matches_jax(data, jax_index, strategy):
    """k = 0: the masked and sublinear scans refuse it as
    ``lax.approx_min_k`` does (``auto`` picks a sublinear one for this
    small batch); the fused strategy gives ``[Q, 0]`` in both packages."""
    q = data[2][:4]
    jx = _jax_variant(jax_index, scan_strategy=strategy)
    port = interop.from_reference(jx, device="cpu")
    if strategy != "pallas":
        for index in (jx, port):
            with pytest.raises(ValueError, match="k must be positive"):
                index.query_arrays(0, q)
        return
    dj, ij = jx.query_arrays(0, q)
    dt, it = port.query_arrays(0, q)
    assert dt.shape == it.shape == np.asarray(dj).shape == np.asarray(ij).shape == (4, 0)


@pytest.mark.parametrize("strategy", ["masked", "pallas", "gathered", "bucketed"])
def test_nan_query_row_matches_jax(data, jax_index, strategy):
    """A query row with a NaN lane: each strategy gives the JAX package's
    distances (NaN or the +inf of empty slots) and ids, the sublinear
    selections ordering a row of NaN as ``lax.approx_min_k`` does on the
    CPU; the other rows are untouched."""
    q = data[2][:3].copy()
    q[1, 4] = np.nan
    jx = _jax_variant(jax_index, scan_strategy=strategy)
    port = interop.from_reference(jx, device="cpu")
    dj, ij = map(np.asarray, jx.query_arrays(3, q))
    dt, it = port.query_arrays(3, q)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-4, atol=1e-4)
