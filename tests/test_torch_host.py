"""The port's own copies of the host-side numpy modules agree with the JAX
package's on the same seeded inputs: ``Index._make_results``, the key
indices, ``WordVectors.grouped`` / ``GroupedWordVectors``, ``Metric``, the
update helpers and ``SummaryStats``."""

import numpy as np
import pytest

from gulon_tpu.models import index as jindex
from gulon_tpu.models import keyindex as jkeyindex
from gulon_tpu.models import metric as jmetric
from gulon_tpu.models import update as jupdate
from gulon_tpu.ops import stats as jstats
from gulon_tpu.utils import word2vec as jw2v
from gulon_tpu_torch.models import index as tindex
from gulon_tpu_torch.models import keyindex as tkeyindex
from gulon_tpu_torch.models import metric as tmetric
from gulon_tpu_torch.models import update as tupdate
from gulon_tpu_torch.ops import stats as tstats
from gulon_tpu_torch.utils import word2vec as tw2v


def _keys(rng, n, pool):
    """Seeded string keys drawn from ``pool`` distinct words (so some
    repeat when ``pool < n``)."""
    return np.array([f"w{i:04d}" for i in rng.integers(0, pool, n)], dtype=object)


def _grouped(w2v, seed, n=300, d=6, groups=9):
    rng = np.random.default_rng(seed)
    keys = _keys(rng, n, 200)
    x = rng.normal(size=(n, d)).astype(np.float32)
    cents = rng.normal(size=(groups, d)).astype(np.float32)
    assign = rng.integers(0, groups, n)
    assign[assign == 4] = 5  # an empty cluster is dropped and renumbered
    return w2v.WordVectors(keys, x).grouped(cents, assign)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_word_vectors_match_jax(seed):
    t, j = _grouped(tw2v, seed), _grouped(jw2v, seed)
    assert type(t) is tw2v.GroupedWordVectors
    assert list(t.keys) == list(j.keys)
    np.testing.assert_array_equal(t.vectors, j.vectors)
    np.testing.assert_array_equal(t.centroids, j.centroids)
    np.testing.assert_array_equal(t.group_ids, j.group_ids)
    np.testing.assert_array_equal(t.group_offsets, j.group_offsets)
    np.testing.assert_array_equal(t.residuals(), j.residuals())
    assert t.num_groups == j.num_groups == 8
    assert [t.cluster_of(r) for r in range(0, 300, 37)] == [
        j.cluster_of(r) for r in range(0, 300, 37)
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_word_vectors_sorted_and_normalized_match_jax(seed):
    rng = np.random.default_rng(seed)
    keys = _keys(rng, 50, 40)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    x[3] = 0.0  # a zero row stays zero
    t, j = tw2v.WordVectors(keys, x), jw2v.WordVectors(keys, x)
    assert list(t.sorted().keys) == list(j.sorted().keys)
    np.testing.assert_array_equal(t.sorted().vectors, j.sorted().vectors)
    np.testing.assert_array_equal(t.normalized().vectors, j.normalized().vectors)
    with pytest.raises(ValueError):
        tw2v.WordVectors(keys[:3], x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_key_indices_match_jax(seed):
    g_t, g_j = _grouped(tw2v, seed), _grouped(jw2v, seed)
    kt = tkeyindex.GroupedKeyIndex(g_t.keys, g_t.group_offsets)
    kj = jkeyindex.GroupedKeyIndex(g_j.keys, g_j.group_offsets)
    assert kt.num_groups == kj.num_groups and len(kt) == len(kj)
    assert [kt.group_bounds(g) for g in range(kt.num_groups)] == [
        kj.group_bounds(g) for g in range(kj.num_groups)
    ]
    assert [kt.group_of(r) for r in range(len(kt))] == [
        kj.group_of(r) for r in range(len(kj))
    ]
    probes = list(dict.fromkeys(g_t.keys[:60])) + ["w9999", "", "zzz"]
    # duplicated keys resolve to the earliest group's row in both
    assert [kt.lookup(k) for k in probes] == [kj.lookup(k) for k in probes]
    st = tkeyindex.SortedKeyIndex(np.sort(g_t.keys))
    sj = jkeyindex.SortedKeyIndex(np.sort(g_j.keys))
    assert [st.lookup(k) for k in probes[:40]] + [st[5]] == [
        sj.lookup(k) for k in probes[:40]
    ] + [sj[5]]
    assert st.lookup("zzz") is None and st.lookup("w9999") is None


def _toy_index(mod_index, mod_keyindex, keys):
    class Toy(mod_index.Index):
        dimension = 3
        size = len(keys)
        key_index = mod_keyindex.SortedKeyIndex(keys)

        def batch_query(self, k, vectors):
            raise NotImplementedError

        def lookup(self, word):
            return None

    return Toy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_results_match_jax(seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(_keys(rng, 40, 1000))
    dists = np.sort(rng.random((6, 5)).astype(np.float32), axis=1)
    ids = rng.integers(0, 40, (6, 5)).astype(np.int32)
    ids[1, 3:] = -1  # padding slots
    dists[2, 4] = np.inf  # an unprobed slot
    rt = _toy_index(tindex, tkeyindex, keys)._make_results(dists, ids)
    rj = _toy_index(jindex, jkeyindex, keys)._make_results(dists, ids)
    assert [type(r) for r in rt] == [tindex.Result] * 6
    assert [list(r.keys) for r in rt] == [list(r.keys) for r in rj]
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.distances, b.distances)
        assert len(a) == len(b) and list(a) == list(b) and a[0] == b[0]
    assert len(rt[1]) == 3 and len(rt[2]) == 4


@pytest.mark.parametrize("name", ["l2", "cosine", " Cosine ", "L2"])
def test_metric_matches_jax(name):
    t, j = tmetric.Metric.parse(name), jmetric.Metric.parse(name)
    assert (t.name, t.value, t.normalized, t.proto_value) == (
        j.name, j.value, j.normalized, j.proto_value
    )
    assert tmetric.Metric.from_proto(j.proto_value) is t
    with pytest.raises(ValueError):
        tmetric.Metric.parse("hamming")


def test_update_helpers_match_jax():
    rng = np.random.default_rng(3)
    old = np.sort(_keys(rng, 30, 25))
    new = _keys(rng, 7, 25)
    mt, ot = tupdate.merge_sorted_order(old, new)
    mj, oj = jupdate.merge_sorted_order(old, new)
    assert list(mt) == list(mj) and list(ot) == list(oj)
    drop = list(old[[0, 5, 5, 9]])
    np.testing.assert_array_equal(
        tupdate.removal_mask(old, drop), jupdate.removal_mask(old, drop)
    )
    np.testing.assert_array_equal(
        tupdate.removal_mask(old, old[2]), jupdate.removal_mask(old, old[2])
    )
    with pytest.raises(KeyError):
        tupdate.removal_mask(old, ["absent"])
    with pytest.raises(ValueError):
        tupdate.removal_mask(old, list(old))
    kt, xt = tupdate.validate_add("a", np.ones(4), 4)
    kj, xj = jupdate.validate_add("a", np.ones(4), 4)
    assert list(kt) == list(kj) and xt.dtype == xj.dtype and xt.shape == xj.shape
    with pytest.raises(ValueError):
        tupdate.validate_add(["a", "b"], np.ones((2, 3)), 4)


def test_summary_stats_match_jax():
    rng = np.random.default_rng(5)
    a, b = rng.random(17), rng.random(9)
    st = tstats.SummaryStats.of(a) + tstats.SummaryStats.of(b)
    sj = jstats.SummaryStats.of(a) + jstats.SummaryStats.of(b)
    assert st.count == sj.count
    np.testing.assert_allclose([st.mean, st.variance, st.stddev],
                               [sj.mean, sj.variance, sj.stddev], rtol=1e-12)
    w = tstats.SummaryStats()
    for v in a:
        w = w.update(v)
    np.testing.assert_allclose([w.mean, w.variance],
                               [tstats.SummaryStats.of(a).mean,
                                tstats.SummaryStats.of(a).variance], rtol=1e-10)
    assert tstats.SummaryStats.zero() + st == st
