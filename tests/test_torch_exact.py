"""Port parity: the exact brute-force index (``gulon_tpu_torch.models.exact``),
mirroring ``tests/test_exact.py``.

The same seeded numpy corpus goes through the JAX ``ExactIndex`` (its
kernel route in Pallas interpret mode) and the port's (the kernels' plain
twins on the CPU). Ids equal (>= 99 % where near-ties may reorder),
distances within rtol/atol 1e-4; npz files cross-load between the
packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from generators import planted_clusters, random_keys
from gulon_tpu.models import exact as jexact
from gulon_tpu.models.metric import Metric as JaxMetric
from gulon_tpu.ops.pallas import dense as jdense
from gulon_tpu_torch.models.metric import Metric
from gulon_tpu_torch import interop
from gulon_tpu_torch.models.exact import ExactIndex, build_exact_index

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(77)
    x, _, _ = planted_clusters(rng, 1200, 16, 6, scale=0.3)
    return random_keys(rng, 1200), x


@pytest.fixture(scope="module")
def big():
    """Kernel-route corpus: clustered rows, n >= 256 * k for k = 10."""
    rng = np.random.default_rng(5)
    n, d = 20480, 48
    centers = rng.normal(size=(256, d)).astype(np.float32)
    x = (centers[rng.integers(0, 256, n)]
         + 0.4 * rng.normal(size=(n, d)).astype(np.float32))
    keys = np.array([f"w{i:06d}" for i in range(n)], dtype=object)
    q = x[rng.choice(n, 16, replace=False)] + 0.05 * rng.normal(size=(16, d)).astype(np.float32)
    return keys, x, q


def test_exact_matches_numpy_bruteforce(data):
    keys, x = data
    index = build_exact_index(keys, x, device="cpu")
    index.precision = "highest"
    index.topk_impl = "exact"
    q = x[:5] + 0.01
    results = index.batch_query(8, q)
    keys_sorted = index.key_index.keys
    xs = index.vectors.numpy()
    for qi, res in enumerate(results):
        d = ((xs - q[qi][None]) ** 2).sum(1)
        np.testing.assert_allclose(res.distances, np.sort(d)[:8], rtol=1e-4, atol=1e-4)
        assert res.keys[0] == keys_sorted[int(np.argmin(d))]


def test_exact_cosine_and_lookup(data):
    keys, x = data
    index = build_exact_index(keys, x, metric=Metric.COSINE, device="cpu")
    ref = jexact.build_exact_index(keys, x, metric=JaxMetric.COSINE)
    w = keys[3]
    vec = index.lookup(w)
    np.testing.assert_allclose(np.linalg.norm(vec), 1.0, rtol=1e-5)
    np.testing.assert_allclose(vec, ref.lookup(w), rtol=1e-6)
    assert index.query_by_word(3, w).keys[0] == w
    assert index.lookup("zzz-missing") is None
    res, res_j = index.query(5, x[9] * 3.0), ref.query(5, x[9] * 3.0)
    assert list(res.keys) == list(res_j.keys)
    np.testing.assert_allclose(res.distances, res_j.distances, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_npz_round_trip_and_cross_load(data, tmp_path, writer):
    """A file saved by either package loads and serves in both."""
    keys, x = data
    port = build_exact_index(keys, x, metric=Metric.COSINE, device="cpu")
    ref = jexact.build_exact_index(keys, x, metric=JaxMetric.COSINE)
    path = tmp_path / "exact.npz"
    (ref if writer == "jax" else port).save(path)
    loaded_t = ExactIndex.load(path, device="cpu")
    loaded_j = jexact.ExactIndex.load(path)
    assert loaded_t.metric is Metric.COSINE and loaded_t.vectors.dtype == torch.float32
    q = x[:4]
    for res in (loaded_t.batch_query(5, q), loaded_j.batch_query(5, q)):
        for ra, rb in zip(port.batch_query(5, q), res):
            assert list(ra.keys) == list(rb.keys)
            np.testing.assert_allclose(ra.distances, rb.distances, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("operand", ["bf16", "int8"])
@pytest.mark.parametrize("exact_rescore", [True, False])
def test_kernel_route_matches_jax(big, operand, exact_rescore):
    """The pallas strategy of both packages: the rescore from f32 rows and
    from the kernel operand. The int8 operand is the JAX package's own,
    handed over through ``prepared_i8``."""
    keys, x, q = big
    ref = dataclasses.replace(
        jexact.build_exact_index(keys, x), scan_strategy="pallas",
        operand=operand, exact_rescore=exact_rescore,
    )
    prepared = None
    if operand == "int8":
        d8, meta, _ = jdense.prepare_data_i8(ref.vectors)
        prepared = (np.asarray(d8), meta)
    port = interop.from_reference(ref, prepared_i8=prepared, device="cpu")
    assert (port.operand, port.exact_rescore, port.scan_strategy) == (
        operand, exact_rescore, "pallas")
    assert port.resolved_operand == operand
    dj, ij = ref.query_arrays(10, jnp.asarray(q))
    dt, it = port.query_arrays(10, q)
    np.testing.assert_array_equal(it.numpy()[:, 0], np.asarray(ij)[:, 0])
    assert np.mean(it.numpy() == np.asarray(ij)) >= 0.99
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)


def test_int8_operand_matches_bf16_under_exact_rescore(big):
    """The port's own int8 operand finds the bf16 operand's neighbours,
    and both rescore from the same f32 rows (``test_exact.py:102``)."""
    keys, x, q = big
    idx = build_exact_index(keys, x, device="cpu")
    d_bf, i_bf = dataclasses.replace(idx, scan_strategy="pallas").query_arrays(10, q)
    i8 = dataclasses.replace(idx, scan_strategy="pallas", operand="int8")
    d_i8, i_i8 = i8.query_arrays(10, q)
    assert i8.resolved_operand == "int8"
    d_bf, i_bf, d_i8, i_i8 = (a.numpy() for a in (d_bf, i_bf, d_i8, i_i8))
    agree = np.mean([len(set(i_i8[j]) & set(i_bf[j])) / 10 for j in range(len(q))])
    assert agree >= 0.9, agree
    for j in range(len(q)):
        m_bf = dict(zip(i_bf[j], d_bf[j]))
        for i_, v in zip(i_i8[j], d_i8[j]):
            if i_ in m_bf:
                np.testing.assert_allclose(m_bf[i_], v, rtol=1e-4, atol=1e-4)


def test_wild_norm_corpus_serves_int8_request_from_bf16():
    """The reference's rule: a corpus the int8 encoding refuses is served
    from the bf16 operand, and ``resolved_operand`` says so."""
    x = np.zeros((4096, 256), np.float32)
    x[:, 0] = np.linspace(0.0, 1e-3, 4096)
    x[0] = 1.0
    keys = np.array([f"w{i:06d}" for i in range(4096)], dtype=object)
    idx = build_exact_index(keys, x, device="cpu")
    i8 = dataclasses.replace(idx, scan_strategy="pallas", operand="int8")
    assert i8.resolved_operand == "bf16"
    d8, ids8 = i8.query_arrays(5, x[100:104])
    db, idsb = dataclasses.replace(idx, scan_strategy="pallas").query_arrays(5, x[100:104])
    np.testing.assert_array_equal(ids8.numpy(), idsb.numpy())
    np.testing.assert_array_equal(d8.numpy(), db.numpy())


def test_exact_rescore_requires_rescore_factor():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4096, 16)).astype(np.float32)
    keys = np.array([f"w{i:06d}" for i in range(4096)], dtype=object)
    bad = dataclasses.replace(
        build_exact_index(keys, x, device="cpu"), scan_strategy="pallas", rescore_factor=0,
        exact_rescore=True,
    )
    with pytest.raises(ValueError, match="rescore_factor"):
        bad.query_arrays(5, x[:2])
    with pytest.raises(ValueError, match="strategy"):
        dataclasses.replace(bad, scan_strategy="bogus").query_arrays(5, x[:2])


def test_auto_policy(big):
    keys, x, _ = big
    idx = build_exact_index(keys, x, device="cpu")
    assert idx.resolve_strategy(10) == "xla"  # vectors on the CPU
    idx.scan_strategy = "pallas"
    assert idx.resolve_strategy(10) == "pallas"


def test_add_remove_match_jax(data):
    keys, x = data
    port = build_exact_index(keys[:1000], x[:1000], metric=Metric.COSINE, device="cpu")
    ref = jexact.build_exact_index(keys[:1000], x[:1000], metric=JaxMetric.COSINE)
    new_keys, new_x = keys[1000:1010], x[1000:1010] * 2.0
    port2, ref2 = port.add(new_keys, new_x), ref.add(new_keys, new_x)
    assert port2.size == 1010 and list(port2.key_index.keys) == list(ref2.key_index.keys)
    np.testing.assert_allclose(port2.vectors.numpy(), np.asarray(ref2.vectors), rtol=1e-6)
    assert port2.query_by_word(1, new_keys[3]).keys[0] == new_keys[3]
    drop = [keys[0], new_keys[1]]
    port3, ref3 = port2.remove(drop), ref2.remove(drop)
    assert list(port3.key_index.keys) == list(ref3.key_index.keys)
    np.testing.assert_allclose(port3.vectors.numpy(), np.asarray(ref3.vectors), rtol=1e-6)
    assert port3.lookup(keys[0]) is None
    with pytest.raises(KeyError):
        port3.remove(["not-a-key"])
    with pytest.raises(ValueError):
        port3.add(["a"], x[:1, :5])


def test_from_reference_same_ids(data):
    keys, x = data
    ref = jexact.build_exact_index(keys, x)
    ref.precision, ref.tile_rows = "highest", 512
    port = interop.from_reference(ref, device="cpu")
    assert isinstance(port, ExactIndex)
    assert (port.precision, port.tile_rows, port.rescore_factor) == ("highest", 512, 4)
    q = x[:12] + 0.02
    dj, ij = ref.query_arrays(7, jnp.asarray(q))
    dt, it = port.query_arrays(7, q)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        interop.exact_index_from_numpy(keys[:3], x[:4], device="cpu")


@pytest.mark.parametrize("k", [0, 3])
def test_xla_route_nan_row_zero_queries_and_k0_match_jax(data, k):
    """The ``xla`` route: a NaN query row gives NaN distances and the JAX
    package's ids, zero queries give ``[0, k]``, and k = 0 raises as
    ``lax.approx_min_k`` does."""
    keys, x = data
    jx = dataclasses.replace(jexact.build_exact_index(keys, x), scan_strategy="xla")
    port = interop.from_reference(jx, device="cpu")
    q = x[:3].copy()
    q[0, 2] = np.nan
    if k == 0:
        with pytest.raises(ValueError, match="k must be positive"):
            jx.query_arrays(0, q)
        with pytest.raises(ValueError, match="k must be positive"):
            port.query_arrays(0, q)
        return
    dj, ij = jx.query_arrays(k, q)
    dt, it = port.query_arrays(k, q)
    assert np.isnan(np.asarray(dj)[0]).all() and np.isnan(dt.numpy()[0]).all()
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)
    q0 = np.zeros((0, x.shape[1]), np.float32)
    dj, ij = jx.query_arrays(k, q0)
    dt, it = port.query_arrays(k, q0)
    assert dt.shape == np.asarray(dj).shape == (0, k) and it.shape == (0, k)
