"""Port parity: ahead-of-time serving plans (``gulon_tpu_torch/utils/aot.py``).

Export -> save -> load -> serve: every plan returns exactly the live
path's ids and distances (the same route, resolved once), for the flat
index (``auto``, ``decode``, ``lut``, ``pallas`` on K1's plain version,
with and without rerank), the IVF index (``masked``, ``gathered``,
``pallas``, ``auto`` resolved per exported batch) and the exact index
(``xla``, the bf16 and int8 kernel operands on their plain versions).
A smaller k truncates an exported k' >= k; shapes with no plan take the
live path. The JAX package's rules carry over: ``bucketed`` is refused,
``gathered`` needs ``LimitGroups``, ``LimitVectors`` under ``auto`` is
planned as ``masked``, a dimension mismatch raises; a sidecar the JAX
package wrote loads and serves through the live path.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from generators import planted_clusters, random_keys
from gulon_tpu.models.build import build_flat_index as jax_build_flat
from gulon_tpu.ops.pq import PQConfig as JaxPQConfig
from gulon_tpu.utils import aot as jaot
from gulon_tpu_torch.models.build import build_flat_index, build_ivf_index
from gulon_tpu_torch.models.exact import build_exact_index
from gulon_tpu_torch.models.ivf import LimitGroups, LimitVectors
from gulon_tpu_torch.models.metric import Metric
from gulon_tpu_torch.ops.pq import PQConfig
from gulon_tpu_torch.utils import aot

torch.set_num_threads(2)

PQ = PQConfig(num_clusters=16, num_quantizers=4, max_iters=8)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(9)
    x, _, _ = planted_clusters(rng, 2500, 16, 8, scale=0.3)
    keys = random_keys(rng, 2500)
    q = (x[:40] + rng.normal(0, 0.01, (40, 16))).astype(np.float32)
    return keys, x, q


@pytest.fixture(scope="module")
def flat(data):
    keys, x, _ = data
    return build_flat_index(keys, x, metric=Metric.COSINE, pq_config=PQ, device="cpu")


@pytest.fixture(scope="module")
def ivf(data):
    keys, x, _ = data
    return build_ivf_index(keys, x, pq_config=PQ, num_partitions=10,
                           strategy=LimitGroups(3), max_partition_size=400,
                           coarse_max_iters=8, device="cpu")


def _roundtrip(index, shapes, tmp_path, name="i.aot"):
    path = str(tmp_path / name)
    aot.save_serving(path, aot.export_serving(index, shapes=shapes))
    return aot.load_serving(path, index)


def _assert_same(serving, index, k, q):
    """The served answer equals the live path's on the route the live
    policy takes at the exported batch whose plan serves these queries
    (the JAX package pads to that batch; the port serves the queries
    unpadded on that route)."""
    d_aot, i_aot = serving.query_arrays(k, q)
    key = serving._pick(k, len(q))
    live = index
    if key is not None:
        plan = serving._plans[key]
        if hasattr(index, "strategy"):  # IVF: auto as the export resolved it
            assert plan["scan_strategy"] == aot._plan_for(index, *key[::-1])["scan_strategy"]
        else:
            assert plan["scan_strategy"] == (
                index.resolve_strategy(key[1]) if plan["kind"] == "exact"
                else index.resolve_strategy(*key)
            )
        live = dataclasses.replace(index, scan_strategy=plan["scan_strategy"])
    d_ref, i_ref = live.query_arrays(k, q)
    assert torch.equal(i_aot, i_ref) and torch.equal(d_aot, d_ref)


@pytest.mark.parametrize("strategy,rerank", [
    ("auto", 0), ("decode", 0), ("lut", 0), ("pallas", 0), ("pallas", 4),
])
def test_flat_plans_equal_the_live_path(data, flat, tmp_path, strategy, rerank):
    _, _, q = data
    index = dataclasses.replace(flat, scan_strategy=strategy, rerank_factor=rerank)
    serving = _roundtrip(index, [(64, 5), (8, 5), (2, 5)], tmp_path)
    assert serving._pick(5, 40) == (64, 5) and serving._pick(5, 3) == (8, 5)
    for nq in (40, 3, 2, 1):
        _assert_same(serving, index, 5, q[:nq])
    _assert_same(serving, index, 7, q[:2])  # no plan for k=7: the live path
    res = serving.batch_query(5, q[:2])
    assert list(res[0].keys) == list(index.batch_query(5, q[:2])[0].keys)
    if strategy == "pallas":
        plan = serving._plans[(64, 5)]
        assert plan["scan_strategy"] == "pallas"
        assert plan["rerank_factor"] == index.resolved_rerank_factor()
        assert plan["pallas_winners"] == index.resolved_pallas_winners()
        # load_serving built K1's operands once, and the views share them
        assert index._k1_operands
        assert serving._views[(64, 5)]._k1_operands is index._k1_operands


@pytest.mark.parametrize("strategy", ["masked", "gathered", "pallas"])
def test_ivf_plans_equal_the_live_path(data, ivf, tmp_path, strategy):
    _, _, q = data
    index = dataclasses.replace(ivf, scan_strategy=strategy)
    serving = _roundtrip(index, [(64, 6), (1, 6)], tmp_path)
    for nq in (40, 1):
        _assert_same(serving, index, 6, q[:nq])
    if strategy == "pallas":
        assert index._pallas_layout is not None  # built at load


def test_ivf_auto_resolves_per_batch(data, ivf, tmp_path):
    """``auto`` is resolved for each exported batch as the live path
    resolves it: sublinear (``gathered``) for one query, ``masked`` for 64
    on the CPU; LimitVectors' sublinear choice is planned as ``masked``."""
    _, _, q = data
    index = dataclasses.replace(ivf)
    assert index._resolve_auto(1, 5) == "gathered"
    serving = _roundtrip(index, [(1, 5), (64, 5)], tmp_path)
    assert serving._plans[(1, 5)]["scan_strategy"] == "gathered"
    assert serving._plans[(64, 5)]["scan_strategy"] == index.resolve_strategy(64, 5)
    _assert_same(serving, index, 5, q[:1])
    _assert_same(serving, index, 5, q)
    lv = dataclasses.replace(ivf, strategy=LimitVectors(600))
    assert aot._plan_for(lv, 5, 1)["scan_strategy"] == "masked"
    served = _roundtrip(lv, [(1, 5)], tmp_path, "lv.aot")
    d, i = served.query_arrays(5, q[:1])
    dm, im = dataclasses.replace(lv, scan_strategy="masked").query_arrays(5, q[:1])
    assert torch.equal(i, im) and torch.equal(d, dm)


def test_bucketed_and_limit_vectors_gathered_refused(ivf):
    lv = dataclasses.replace(ivf, strategy=LimitVectors(600), scan_strategy="gathered")
    with pytest.raises(ValueError, match="LimitGroups"):
        aot.export_serving(lv, shapes=[(8, 5)])
    with pytest.raises(ValueError, match="bucketed"):
        aot.export_serving(dataclasses.replace(ivf, scan_strategy="bucketed"),
                           shapes=[(8, 5)])


@pytest.mark.parametrize("strategy,operand", [
    ("xla", "bf16"), ("pallas", "bf16"), ("pallas", "int8"),
])
def test_exact_plans_equal_the_live_path(data, tmp_path, strategy, operand):
    keys, x, q = data
    index = build_exact_index(keys, x, device="cpu")
    index.scan_strategy, index.operand = strategy, operand
    serving = _roundtrip(index, [(64, 5)], tmp_path)
    plan = serving._plans[(64, 5)]
    assert plan["scan_strategy"] == strategy
    if strategy == "pallas":
        assert plan["operand"] == index.resolved_operand == operand
        assert (index._data_i8 if operand == "int8" else index._data_t) is not None
    _assert_same(serving, index, 5, q)


def test_cached_plan_shares_the_cache(data, flat, tmp_path):
    """A cached index's plans read the index's cache, not a copy of it."""
    _, _, q = data
    index = dataclasses.replace(flat, scan_strategy="auto")
    index.enable_cache()
    serving = _roundtrip(index, [(64, 5), (8, 5)], tmp_path)
    assert serving._plans[(64, 5)]["scan_strategy"] == "cached"
    for view in serving._views.values():
        assert view.decoded_cache is index.decoded_cache
    for nq in (40, 8):
        _assert_same(serving, index, 5, q[:nq])


def test_adopted_kernel_cache_replaces_the_decoded_cache(flat):
    """The dense-kernel operand a view builds over the cache (on a card)
    passes to the index, which then drops its decoded cache, as its own
    query path does; operands the index already holds stay."""
    index = dataclasses.replace(flat)
    index.enable_cache()
    view = dataclasses.replace(index, scan_strategy="cached")
    view._cache_aug, view.decoded_cache = torch.zeros(3), None
    view._k1_operands = {"view": torch.zeros(2)}
    index._k1_operands = held = {"index": torch.ones(2)}
    index._adopt_operands(view)
    assert index._cache_aug is view._cache_aug and index.decoded_cache is None
    assert index._k1_operands is held
    assert dataclasses.replace(index)._cache_aug is view._cache_aug


def test_plans_of_another_index_refused(data, flat, tmp_path):
    """A sidecar exported for other knobs (or another index of the same
    width) resolves other routes than the loaded index: refused."""
    _, _, q = data
    path = str(tmp_path / "other.aot")
    aot.save_serving(path, aot.export_serving(
        dataclasses.replace(flat, scan_strategy="pallas", rerank_factor=4), shapes=[(64, 5)]))
    for other in (dataclasses.replace(flat, scan_strategy="decode"),
                  dataclasses.replace(flat, scan_strategy="pallas", rerank_factor=2)):
        with pytest.raises(ValueError, match="another index"):
            aot.load_serving(path, other)


def test_smaller_k_truncates(data, flat, tmp_path):
    _, _, q = data
    serving = _roundtrip(flat, [(64, 10)], tmp_path)
    d, i = serving.query_arrays(3, q)
    dr, ir = flat.query_arrays(3, q)
    assert d.shape == (40, 3) and torch.equal(i, ir) and torch.equal(d, dr)
    assert serving.query_arrays(20, q)[0].shape == (40, 20)  # above every k'


def test_dimension_and_kind_mismatch_raise(data, flat, ivf, tmp_path):
    keys, x, _ = data
    path = str(tmp_path / "dim.aot")
    aot.save_serving(path, aot.export_serving(flat, shapes=[(8, 3)]))
    other = build_flat_index(keys, np.pad(x, ((0, 0), (0, 4))), pq_config=PQ, device="cpu")
    with pytest.raises(ValueError, match="dimension"):
        aot.load_serving(path, other)
    with pytest.raises(ValueError, match="flat index"):
        aot.load_serving(path, ivf)


def test_sidecar_layout(flat, tmp_path):
    path = str(tmp_path / "s.aot")
    aot.save_serving(path, aot.export_serving(flat, shapes=[(1024, 10), (1, 10)]))
    with np.load(path) as z:
        meta = json.loads(z["meta"].tobytes().decode())
        plan = json.loads(z["a_1024_10"].tobytes())
        assert sorted(z.files) == ["a_1024_10", "a_1_10", "meta"]
    assert meta == {"version": 1, "platform": "cpu", "dimension": 16,
                    "shapes": [[1, 10], [1024, 10]], "format": "gulon_tpu_torch.plan"}
    assert plan["kind"] == "flat" and plan["scan_strategy"] == "decode"


def test_jax_sidecar_loads_and_serves_live(data, flat, tmp_path):
    """A JAX-written sidecar (StableHLO, no port marker) passes the
    version and dimension checks and every call takes the live path; a
    port sidecar on another device type does the same."""
    keys, x, q = data
    ref = jax_build_flat(keys, x, pq_config=JaxPQConfig(num_clusters=16, num_quantizers=4,
                                                        max_iters=8))
    path = str(tmp_path / "jax.aot")
    jaot.save_serving(path, jaot.export_serving(ref, shapes=[(64, 5)]))
    serving = aot.load_serving(path, flat)
    assert serving._views == {} and serving._pick(5, 40) is None
    _assert_same(serving, flat, 5, q)

    bundle = aot.export_serving(flat, shapes=[(64, 5)], warm_cache=False)
    other = dataclasses.replace(bundle, platform="cuda")
    aot.save_serving(str(tmp_path / "cuda.aot"), other)
    serving = aot.load_serving(str(tmp_path / "cuda.aot"), flat)
    assert serving._views == {} and serving._pick(5, 40) is None
    _assert_same(serving, flat, 5, q)


def test_index_api_passthrough(data, flat, tmp_path):
    keys, _, q = data
    serving = _roundtrip(flat, [(8, 5)], tmp_path)
    assert serving.dimension == flat.dimension and serving.size == flat.size
    assert serving.metric == flat.metric and serving.key_index is flat.key_index
    assert serving.device == flat.device
    word = flat.key_index.keys[7]
    np.testing.assert_array_equal(serving.lookup(word), flat.lookup(word))
    assert serving.lookup("definitely-not-a-key") is None
    assert serving.query_by_word(5, "definitely-not-a-key") is None
    assert list(serving.query_by_word(5, word).keys) == list(flat.query_by_word(5, word).keys)
    assert list(serving.query(3, q[0]).keys) == list(flat.query(3, q[0]).keys)
    serving.warmup(5, batch_sizes=(1, 8))
