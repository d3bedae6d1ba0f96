"""Port parity: the sharded layer (``gulon_tpu_torch/parallel``).

Each port function and class against its JAX counterpart on the same
seeded numpy input: the JAX side on the 8 virtual CPU devices of
``tests/conftest.py``, the port on ``make_mesh(devices=["cpu"] * 8)``,
eight logical shards of the CPU. The JAX kernels run in interpret mode,
the port's through their plain versions (``force_kernel`` is the
counterpart of ``force_pallas``). Ids are held equal except at near-ties
(slots whose distances lie within the tolerance of a neighbour's, or of
the k-th), distances within 1e-4 absolute, codes equal. k-means with the
JAX init injected follows the JAX trajectory: >= 99.9 % equal
assignments, centroids within 1e-4. ``tests/test_parallel.py`` is the
spec.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from generators import planted_clusters, random_keys
from gulon_tpu import parallel as jpar
from gulon_tpu.models.build import build_flat_index as jbuild_flat
from gulon_tpu.models.build import build_ivf_index as jbuild_ivf
from gulon_tpu.models.exact import build_exact_index as jbuild_exact
from gulon_tpu.models.ivf import LimitGroups as JLimitGroups
from gulon_tpu.models.ivf import LimitVectors as JLimitVectors
from gulon_tpu.ops import kmeans as jkm
from gulon_tpu.ops.pallas import adc as jadc
from gulon_tpu.ops.pallas import dense as jdense
from gulon_tpu.ops.pq import PQConfig as JPQConfig
from gulon_tpu.ops.pq import train_product_quantizer as jtrain
from gulon_tpu.parallel import ops as jops
from gulon_tpu_torch import interop
from gulon_tpu_torch import parallel as tpar
from gulon_tpu_torch.models.build import build_ivf_index
from gulon_tpu_torch.models.ivf import LimitGroups
from gulon_tpu_torch.ops import kmeans as tkm
from gulon_tpu_torch.ops.cuda import adc as tadc
from gulon_tpu_torch.ops.cuda import dense as tdense
from gulon_tpu_torch.ops.pq import PQConfig
from gulon_tpu_torch.parallel import ops as tops

torch.set_num_threads(2)

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def meshes():
    return jpar.make_mesh(), tpar.make_mesh(devices=["cpu"] * 8)


def _same_topk(d_port, i_port, d_ref, i_ref, atol=ATOL):
    """Distances within ``atol``; ids equal on every slot whose distance
    is clear of its neighbours' and of the k-th (near-ties are
    path-arbitrary), and equal as sets below the k-th distance."""
    d_port, i_port = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                      for a in (d_port, i_port))
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    assert d_port.shape == d_ref.shape and i_port.shape == i_ref.shape
    finite = np.isfinite(d_ref)
    np.testing.assert_array_equal(np.isfinite(d_port), finite)
    np.testing.assert_allclose(d_port[finite], d_ref[finite], rtol=0, atol=atol)
    for q in range(d_ref.shape[0]):
        d = np.where(finite[q], d_ref[q], np.inf)
        near = np.isclose(d[1:], d[:-1], rtol=0, atol=2 * atol)
        strict = np.ones(len(d), bool)
        strict[1:] &= ~near
        strict[:-1] &= ~near
        below = d < d[-1] - 2 * atol  # a tie can straddle the k-th slot
        np.testing.assert_array_equal(i_port[q][strict & below], i_ref[q][strict & below])
        assert set(i_port[q][below]) == set(i_ref[q][below])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    x, _, _ = planted_clusters(rng, 3000, 16, 8, scale=0.4)
    keys = random_keys(rng, 3000)
    q = x[rng.choice(3000, 12, replace=False)] + rng.normal(0, 0.05, (12, 16))
    return keys, x, q.astype(np.float32)


@pytest.fixture(scope="module")
def big():
    """8192 rows: 1024 a shard, inside the kernels' ``256 * k`` envelope."""
    rng = np.random.default_rng(41)
    x, _, _ = planted_clusters(rng, 8192, 16, 16, scale=0.3, spread=2.0)
    keys = random_keys(rng, 8192)
    return keys, x, x[rng.choice(8192, 8, replace=False)].copy()


def test_exports_match_jax():
    """The 13 names of ``gulon_tpu.parallel``, each importable."""
    assert tpar.__all__ == jpar.__all__ and len(tpar.__all__) == 13
    assert all(callable(getattr(tpar, name)) for name in tpar.__all__[2:])


def test_mesh_shapes_match_jax():
    for kwargs in ({}, {"sub_parallel": 2}, {"sub_parallel": 4}):
        j = jpar.make_mesh(**kwargs)
        t = tpar.make_mesh(devices=["cpu"] * 8, **kwargs)
        assert t.shape == dict(j.shape)
    assert tpar.make_mesh(4, devices=["cpu"] * 8).shape == dict(jpar.make_mesh(4).shape)
    for make in (lambda: jpar.make_mesh(sub_parallel=3),
                 lambda: tpar.make_mesh(devices=["cpu"] * 8, sub_parallel=3)):
        with pytest.raises(ValueError):
            make()
    mesh = tpar.make_mesh(devices=["cpu"] * 4, sub_parallel=2)
    assert mesh.flattened().shape == {"rows": 4, "sub": 1}
    assert mesh.local_rows == [0, 1] and not mesh.on_cuda


def test_make_mesh_defaults_to_the_card():
    """Without ``devices`` the mesh is every visible CUDA device; there is
    no CPU fallback."""
    if torch.cuda.is_available():
        assert tpar.make_mesh().on_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_mesh()


@pytest.mark.parametrize("pad_value", [0, np.inf])
def test_shard_rows_and_replicate_match_jax(meshes, pad_value):
    jm, tm = meshes
    a = np.arange(1001 * 3, dtype=np.float32).reshape(1001, 3)
    j = jpar.shard_rows(a, jm, pad_value)
    t = tpar.shard_rows(a, tm, pad_value)
    assert len(t) == 8 and all(s.shape == (126, 3) for s in t)
    np.testing.assert_array_equal(torch.cat(t).numpy(), np.asarray(j))
    t2 = tpar.shard_rows(_t(a), tm, pad_value)  # tensors shard the same way
    np.testing.assert_array_equal(torch.cat(t2).numpy(), np.asarray(j))
    rep = tpar.replicate(a[:5], tm)
    assert len(rep) == 8 and all(torch.equal(r, _t(a[:5])) for r in rep)
    np.testing.assert_array_equal(rep[3].numpy(), np.asarray(jpar.replicate(a[:5], jm)))


def test_merge_over_rows_matches_jax_with_ties(meshes):
    """The all-gather top-k merge: equal values keep the lowest position
    (shard order, then slot), in both packages."""
    jm, tm = meshes
    rng = np.random.default_rng(3)
    q, k = 5, 4
    d = rng.integers(0, 6, size=(q, 8 * k)).astype(np.float32)  # many ties
    ids = rng.permutation(q * 8 * k).reshape(q, 8 * k).astype(np.int32)

    def merge(ld, li):
        return jops._merge_over_rows(ld, li, k)

    dj, ij = jax.jit(jax.shard_map(
        merge, mesh=jm, in_specs=(P(None, "rows"), P(None, "rows")),
        out_specs=(P(), P()), check_vma=False,
    ))(jnp.asarray(d), jnp.asarray(ids))
    dt, it = tops._merge_over_rows(
        [_t(d[:, s * k:(s + 1) * k]) for s in range(8)],
        [_t(ids[:, s * k:(s + 1) * k]) for s in range(8)], k, tm,
    )
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert np.all(tops._globalize_ids(_t(np.array([[0, -1, 5]], np.int32)), 3, 100).numpy()
                  == [[300, -1, 305]])


@pytest.fixture(scope="module")
def big_pq(big):
    _, x, _ = big
    pq = jtrain(x, JPQConfig(num_clusters=16, num_quantizers=4, max_iters=6))
    codes = np.asarray(pq.encode(x))
    norms = np.asarray(pq.reconstruction_norms(jnp.asarray(codes)))
    return pq, codes, norms


@pytest.mark.parametrize("force,winners,rerank_k,codes_t", [
    (False, 1, 0, False),  # the decode scan per shard
    (True, 1, 0, False),  # the kernel over [n_loc, m] codes
    (True, 1, 0, True),  # the kernel over a pretransposed operand
    (True, 2, 4, True),  # two winners, rescore 4 -> 2 per shard
    (True, 3, 0, False),
    (True, 4, 4, True),
])
def test_sharded_adc_scan_matches_jax(meshes, big, big_pq, force, winners, rerank_k, codes_t):
    jm, tm = meshes
    _, _, q = big
    pq, codes, norms = big_pq
    k = 2
    ct_j = ct_t = None
    if codes_t:
        ct_j = jax.device_put(jadc.pack_codes_t(codes, 16), NamedSharding(jm, P(None, "rows")))
        ct_t = [tadc.pack_codes_t(c, 16) for c in tpar.shard_rows(codes, tm, 0)]
    dj, ij = jpar.sharded_adc_scan(
        jnp.asarray(q), pq.codebooks, jpar.shard_rows(codes, jm, 0),
        jpar.shard_rows(norms, jm, np.inf), ct_j, mesh=jm, bounds=pq.bounds, k=k,
        winners=winners, rerank_k=rerank_k, force_pallas=force,
    )
    dt, it = tpar.sharded_adc_scan(
        _t(q), tpar.replicate(pq.codebooks, tm), tpar.shard_rows(codes, tm, 0),
        tpar.shard_rows(norms, tm, np.inf), ct_t, mesh=tm, bounds=pq.bounds, k=k,
        winners=winners, rerank_k=rerank_k, force_kernel=force,
    )
    assert it.dtype == torch.int32
    _same_topk(dt, it, dj, ij)


@pytest.mark.parametrize("n,k", [(3000, 10), (1001, 5)])
def test_sharded_exact_scan_matches_jax(meshes, n, k):
    """Also a row count the shard count does not divide: the +inf padding
    norms keep padding rows out."""
    jm, tm = meshes
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    q = x[:6] + 0.01
    norms = (x * x).sum(1)
    dj, ij = jpar.sharded_exact_scan(
        jnp.asarray(q), jpar.shard_rows(x, jm), jpar.shard_rows(norms, jm, np.inf),
        mesh=jm, k=k, tile_rows=64,
    )
    dt, it = tpar.sharded_exact_scan(
        _t(q), tpar.shard_rows(x, tm), tpar.shard_rows(norms, tm, np.inf),
        mesh=tm, k=k, tile_rows=64,
    )
    assert np.all(it.numpy() < n)
    _same_topk(dt, it, dj, ij)


@pytest.mark.parametrize("rescore_rows", [False, True])
def test_sharded_dense_scan_matches_jax(meshes, big, rescore_rows):
    """K2 per shard (its plain version here) over row shards whose padding
    rows carry the finite ``_BIG`` norm lane."""
    jm, tm = meshes
    _, x, q = big
    x = x[:8190]  # two padding rows on the last shard
    norms = (x * x).sum(1)
    x_pad, _ = jpar.mesh.pad_rows_to_shards(x, jm, 0)
    n_pad, _ = jpar.mesh.pad_rows_to_shards(norms, jm, np.inf)
    aug = jdense.prepare_data(
        jnp.asarray(x_pad), jnp.where(jnp.isinf(n_pad), jdense._BIG, jnp.asarray(n_pad))
    )
    dj, ij = jops.sharded_dense_scan(
        jnp.asarray(q), jax.device_put(aug, NamedSharding(jm, P("rows", None))),
        jpar.shard_rows(norms, jm, np.inf),
        jpar.shard_rows(x, jm) if rescore_rows else None, mesh=jm, k=4, rescore=4,
    )
    xs, ns = tpar.shard_rows(x, tm), tpar.shard_rows(norms, tm, np.inf)
    dt, it = tops.sharded_dense_scan(
        _t(q), [tdense.prepare_data(a, b) for a, b in zip(xs, ns)], ns,
        xs if rescore_rows else None, mesh=tm, k=4, rescore=4,
    )
    _same_topk(dt, it, dj, ij)


@pytest.fixture(scope="module")
def flat_pair(data):
    keys, x, _ = data
    jx = jbuild_flat(keys, x, pq_config=JPQConfig(num_clusters=32, num_quantizers=4,
                                                  max_iters=10))
    return jx, interop.from_reference(jx, device="cpu")


@pytest.mark.parametrize("strategy", ["decode", "cached_xla", "cached_dense"])
def test_sharded_flat_index_matches_jax(meshes, data, flat_pair, strategy):
    jm, tm = meshes
    _, _, q = data
    jx, tx = (dataclasses.replace(i) for i in flat_pair)
    if strategy.startswith("cached"):
        jx.enable_cache()
        tx.enable_cache()
        jx.scan_strategy = tx.scan_strategy = "cached"
    js, ts = jpar.shard_index(jx, jm), tpar.shard_index(tx, tm)
    assert isinstance(ts, tpar.ShardedFlatIndex) and ts.size == jx.size
    if strategy == "cached_dense":
        # 375 rows a shard: the forced dense kernel at k = 1
        js.dense_cached = ts.dense_cached = True
        k = 1
    else:
        js.dense_cached = ts.dense_cached = False
        k = 8
    dj, ij = js.query_arrays(k, q)
    dt, it = ts.query_arrays(k, q)
    _same_topk(dt, it, dj, ij, atol=ATOL if strategy == "decode" else 2e-3)
    got, ref = ts.batch_query(k, q[:2]), js.batch_query(k, q[:2])
    assert [list(r.keys) for r in got] == [list(r.keys) for r in ref]
    assert ts.lookup("nope") is None and ts.dimension == 16


def test_sharded_cached_requires_cache(meshes, data, flat_pair):
    _, tm = meshes
    _, _, q = data
    tx = dataclasses.replace(flat_pair[1], scan_strategy="cached")
    with pytest.raises(ValueError, match="enable_cache"):
        tpar.shard_index(tx, tm).query_arrays(3, q[:2])


@pytest.mark.parametrize("strategy,probe", [
    ("masked", "groups"), ("masked", "vectors"), ("pallas", "groups"),
    ("bucketed", "groups"), ("bucketed", "vectors"), ("gathered", "groups"),
    ("pallas_rescore", "groups"),
])
def test_sharded_ivf_index_matches_jax(meshes, big, strategy, probe):
    """Whole partitions per shard (the greedy balance, equal placement in
    both packages), then each scan strategy shard by shard."""
    jm, tm = meshes
    keys, x, q = big
    jx = jbuild_ivf(
        keys[:4096], x[:4096],
        pq_config=JPQConfig(num_clusters=16, num_quantizers=4, max_iters=6),
        num_partitions=8,
        strategy=JLimitGroups(4) if probe == "groups" else JLimitVectors(1500),
        coarse_max_iters=6,
    )
    jx.topk_impl = "exact"
    jx.scan_strategy = "pallas" if strategy.startswith("pallas") else strategy
    if strategy == "pallas_rescore":
        jx.pallas_winners, jx.pallas_rescore = 1, 4
    tx = interop.from_reference(jx, device="cpu")
    js, ts = jpar.shard_index(jx, jm), tpar.shard_index(tx, tm)
    np.testing.assert_array_equal(ts.part_shard, js.part_shard)
    np.testing.assert_array_equal(ts.local_starts, js.local_starts)
    dj, ij = js.query_arrays(5, x[:16])
    dt, it = ts.query_arrays(5, x[:16])
    _same_topk(dt, it, dj, ij)


def test_sharded_ivf_global_rows_clamp_as_jax(meshes, big):
    """A shard's local ids past its last row (a NaN query row's positions
    in a padded last tile can be) map through the row map clamped, as
    the JAX package's gather does; -1 stays an empty slot."""
    jm, tm = meshes
    keys, x, _ = big
    jx = jbuild_ivf(
        keys[:4096], x[:4096],
        pq_config=JPQConfig(num_clusters=16, num_quantizers=4, max_iters=6),
        num_partitions=8, strategy=JLimitGroups(4), coarse_max_iters=6,
    )
    js = jpar.shard_index(jx, jm)
    ts = tpar.shard_index(interop.from_reference(jx, device="cpu"), tm)
    l2g = np.asarray(js.loc2glob_sharded)
    n_loc = l2g.shape[1]
    ids = np.array([[-1, 0, n_loc - 1, n_loc, n_loc + 17, 3 * n_loc]], np.int32)
    for r in range(l2g.shape[0]):
        ref = jnp.where(ids >= 0, jnp.asarray(l2g[r])[jnp.maximum(ids, 0)], -1)
        np.testing.assert_array_equal(
            ts._global_rows(r, torch.from_numpy(ids)).numpy(), np.asarray(ref)
        )


@pytest.mark.parametrize("exact_rescore", [True, False])
@pytest.mark.parametrize("strategy", ["xla", "pallas"])
def test_sharded_exact_index_matches_jax(meshes, big, strategy, exact_rescore):
    jm, tm = meshes
    keys, x, q = big
    jx = jbuild_exact(keys, x)
    jx.scan_strategy = strategy
    jx.exact_rescore = exact_rescore
    tx = interop.from_reference(jx, device="cpu")
    js, ts = jpar.shard_index(jx, jm), tpar.shard_index(tx, tm)
    assert (ts.data_aug_sharded is not None) == (strategy == "pallas")
    dj, ij = js.query_arrays(4, q)
    dt, it = ts.query_arrays(4, q)
    # the bf16 operand's rescore: both sum the same bf16 products in f32
    _same_topk(dt, it, dj, ij, atol=ATOL if exact_rescore or strategy == "xla" else 2e-3)


@pytest.mark.parametrize("kind", ["flat", "ivf", "exact"])
def test_sharded_add_remove_reshards(meshes, data, kind):
    """add/remove update the base index and re-shard it on the same mesh;
    the results equal the JAX sharded index's after the same updates."""
    jm, tm = meshes
    keys, x, q = data
    if kind == "flat":
        jx = jbuild_flat(keys[:2500], x[:2500], pq_config=JPQConfig(
            num_clusters=32, num_quantizers=4, max_iters=10))
    elif kind == "ivf":
        jx = jbuild_ivf(keys[:2500], x[:2500], pq_config=JPQConfig(
            num_clusters=32, num_quantizers=4, max_iters=10), num_partitions=8,
            strategy=JLimitGroups(3), coarse_max_iters=6)
        jx.topk_impl = "exact"
    else:
        jx = jbuild_exact(keys[:2500], x[:2500])
    js = jpar.shard_index(jx, jm)
    ts = tpar.shard_index(interop.from_reference(jx, device="cpu"), tm)
    js2 = js.add(keys[2500:], x[2500:]).remove(keys[:100])
    ts2 = ts.add(keys[2500:], x[2500:]).remove(keys[:100])
    assert type(ts2) is type(ts) and ts2.size == js2.size == 2900
    assert list(ts2.key_index.keys) == list(js2.key_index.keys)
    dj, ij = js2.query_arrays(8, q)
    dt, it = ts2.query_arrays(8, q)
    _same_topk(dt, it, dj, ij)


def test_sharded_k_exceeds_shard_rows(meshes):
    """k = 40 over 8 rows a shard: every shard pads with (inf, -1) and the
    merge still returns the 40 best."""
    jm, tm = meshes
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    keys = np.array([f"s{i:03d}" for i in range(64)], dtype=object)
    jx = jbuild_flat(keys, x, pq_config=JPQConfig(num_clusters=8, num_quantizers=2,
                                                  max_iters=5))
    ts = tpar.shard_index(interop.from_reference(jx, device="cpu"), tm)
    res = ts.batch_query(40, x[:2])
    assert len(res[0]) == 40 and np.all(np.diff(res[0].distances) >= -1e-6)
    dj, ij = jpar.shard_index(jx, jm).query_arrays(40, x[:2])
    dt, it = ts.query_arrays(40, x[:2])
    _same_topk(dt, it, dj, ij)


def test_sharded_encode_matches_jax(meshes, data):
    """Rows over every device, 700-row host chunks: the JAX codes."""
    jm, tm = meshes
    _, x, _ = data
    pq = jtrain(x, JPQConfig(num_clusters=32, num_quantizers=4, max_iters=10))
    ref = jops.sharded_encode(pq, x, jm, chunk=700)
    tpq = interop._pq_from_numpy(np.asarray(pq.codebooks), pq.bounds, 32, "cpu")
    for mesh in (tm, tpar.make_mesh(devices=["cpu"] * 8, sub_parallel=2)):
        got = tops.sharded_encode(tpq, x, mesh, chunk=700, precision="highest")
        np.testing.assert_array_equal(got, ref)
    got = tops.sharded_encode(tpq, _t(x), tm, chunk=1 << 20, precision="highest")
    np.testing.assert_array_equal(got, ref)


def _stacked(x):
    return np.stack([x[:, i * 4:(i + 1) * 4] for i in range(4)])


@pytest.mark.parametrize("sub_parallel", [1, 2, 4])
@pytest.mark.parametrize("init", ["sample", "kmeans++"])
def test_sharded_fit_kmeans_matches_jax(data, sub_parallel, init):
    """The JAX init injected: the JAX sharded trajectory (rows over
    ``rows``, subspaces over ``sub``)."""
    _, x, _ = data
    xs = _stacked(x)
    m, n, _ = xs.shape
    cfg = dict(k=16, max_iters=15, seed=3, init=init, precision="highest")
    ref = jpar.sharded_fit_kmeans(
        xs, jkm.KMeansConfig(**cfg), jpar.make_mesh(sub_parallel=sub_parallel)
    )
    if init == "sample":
        idx = np.asarray(jkm.init_indices(m, n, 16, 3))
    else:  # 3000 rows < the 65536-row seeding cap: no subsample
        idx = np.asarray(jkm._pp_indices_stacked(jnp.asarray(xs), k=16, seed=3))
    got = tpar.sharded_fit_kmeans(
        xs, tkm.KMeansConfig(**cfg),
        tpar.make_mesh(devices=["cpu"] * 8, sub_parallel=sub_parallel), init_indices=idx,
    )
    assert got.assignments.shape == (m, n)
    assert np.mean(got.assignments.numpy() == np.asarray(ref.assignments)) >= 0.999
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(ref.centroids),
                               atol=ATOL, rtol=0)
    assert got.iterations == int(ref.iterations)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))


def test_sharded_fit_kmeans_unstacked_pads_rows(data):
    """[n, d] input over a mesh whose shard count does not divide n: the
    padding rows count for nothing, and the run equals ``fit_kmeans``."""
    _, x, _ = data
    cfg = tkm.KMeansConfig(k=8, max_iters=10, seed=1, precision="highest")
    got = tpar.sharded_fit_kmeans(x[:2999], cfg, tpar.make_mesh(devices=["cpu"] * 7))
    ref = tkm.fit_kmeans(x[:2999], cfg, device="cpu")
    assert got.centroids.shape == (8, 16) and got.assignments.shape == (2999,)
    np.testing.assert_allclose(got.centroids.numpy(), ref.centroids.numpy(), atol=1e-5)
    assert torch.equal(got.assignments, ref.assignments)
    assert got.iterations == ref.iterations


def test_sharded_kmeanspp_subsample_and_objective(data):
    """k-means++ over a mesh: deterministic, no worse than the uniform
    init (the JAX test's bound); past the 65,536-row seeding cap the seed
    rows come from the JAX package's numpy subsample of the input."""
    _, x, _ = data
    xs = _stacked(x)
    mesh = tpar.make_mesh(devices=["cpu"] * 8)
    pp = tkm.KMeansConfig(k=12, max_iters=10, seed=3, init="kmeans++")
    a = tpar.sharded_fit_kmeans(xs, pp, mesh)
    b = tpar.sharded_fit_kmeans(xs, pp, mesh)
    assert torch.equal(a.centroids, b.centroids)
    u = tpar.sharded_fit_kmeans(xs, tkm.KMeansConfig(k=12, max_iters=10, seed=3), mesh)
    for s in range(4):
        o_pp = float(tkm.kmeans_objective(_t(xs[s]), a.centroids[s], a.assignments[s]))
        o_u = float(tkm.kmeans_objective(_t(xs[s]), u.centroids[s], u.assignments[s]))
        assert o_pp <= o_u * 1.25
    many = np.random.default_rng(0).normal(size=(70000, 2)).astype(np.float32)
    cfg = tkm.KMeansConfig(k=8, max_iters=2, seed=5, init="kmeans++")
    rows = np.sort(np.random.default_rng(5).choice(70000, 65536, replace=False))
    idx = rows[tkm.kmeans_pp_indices(_t(many[rows])[None], 8, 5).numpy()]
    got = tpar.sharded_fit_kmeans(many, cfg, mesh)
    ref = tpar.sharded_fit_kmeans(many, cfg, mesh, init_indices=idx)
    assert torch.equal(got.centroids, ref.centroids)


def test_mesh_build_ivf_end_to_end(meshes, data):
    """``build_ivf_index(mesh=...)``: sharded coarse k-means, sharded PQ
    training and sharded encode, then served sharded; probing every
    partition, the results are the exact scan's nearest neighbours up to
    PQ error, and they equal the JAX mesh build's recall class."""
    _, tm = meshes
    keys, x, q = data
    index = build_ivf_index(
        keys, x, pq_config=PQConfig(num_clusters=16, num_quantizers=4, max_iters=6),
        num_partitions=8, strategy=LimitGroups(8), coarse_max_iters=6,
        mesh=tm, device="cpu",
    )
    served = tpar.shard_index(index, tm)
    d1, i1 = index.query_arrays(5, q)
    d8, i8 = served.query_arrays(5, q)
    _same_topk(d8, i8, d1, i1)
    ref = jbuild_ivf(keys, x, pq_config=JPQConfig(num_clusters=16, num_quantizers=4,
                                                  max_iters=6),
                     num_partitions=8, strategy=JLimitGroups(8), coarse_max_iters=6,
                     mesh=jpar.make_mesh())
    exact = ((q[:, None, :] - x[None]) ** 2).sum(-1).argsort(1)[:, :5]
    own = np.mean([len(set(a) & set(b)) for a, b in zip(i1.numpy(), exact)])
    jax_own = np.mean([len(set(a) & set(b)) for a, b in zip(
        np.asarray(ref.query_arrays(5, q)[1]), exact)])
    assert own >= 0.9 * jax_own
