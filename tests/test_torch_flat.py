"""Port parity: the flat main path whole (build -> query -> recall).

``from_reference`` serves a JAX-built index's exact arrays from the port;
each strategy then gives >= 99 % equal top-10 ids and recall@10 within
0.01 of the JAX index. A port-built index reaches >= 0.99x the recall@10
of a JAX-built one (the k-means init draws differ, so the builds are held
by recall, not id for id).

The corpus is Gaussian, so nearly every row has its own code tuple: on a
code-collapsed corpus whole cohorts of rows tie at one ADC distance and
both packages break those ties by matmul rounding, which no id-for-id
comparison can hold.
"""

import dataclasses

import numpy as np
import pytest
import torch

from generators import random_keys
import jax.numpy as jnp

from gulon_tpu.models import flat as jflat
from gulon_tpu.models.build import build_flat_index as jax_build
from gulon_tpu.models.metric import Metric as JaxMetric
from gulon_tpu.ops.pq import PQConfig as JaxPQConfig
from gulon_tpu.utils import eval as jeval
from gulon_tpu.ops import scan as jscan
from gulon_tpu.ops.pallas import dense as jdense
from gulon_tpu_torch.models.metric import Metric
from gulon_tpu_torch import interop
from gulon_tpu_torch.models import flat as tflat
from gulon_tpu_torch.models.build import build_flat_index
from gulon_tpu_torch.models.flat import FlatIndex
from gulon_tpu_torch.ops import scan as tscan
from gulon_tpu_torch.ops.cuda import dense as tdense
from gulon_tpu_torch.ops.pq import PQConfig
from gulon_tpu_torch.utils import eval as teval
from gulon_tpu_torch.utils import tracing

torch.set_num_threads(2)

PQ = dict(num_clusters=32, num_quantizers=6, max_iters=10)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(6000, 24)).astype(np.float32)
    keys = random_keys(rng, 6000)
    truth = jeval.sample_ground_truth(keys, x, num_samples=64, ks=(1, 10))
    return x, keys, truth


@pytest.fixture(scope="module")
def jax_index(data):
    x, keys, _ = data
    return jax_build(keys, x, pq_config=JaxPQConfig(**PQ))


def _recall10(index, data):
    x, keys, truth = data
    return teval.recall_of(index, truth, x, keys)[10].mean


@pytest.mark.parametrize(
    "strategy,rerank",
    [("decode", 0), ("lut", 0), ("pallas", 0), ("pallas", 4)],
)
def test_from_reference_matches_jax_per_strategy(data, jax_index, strategy, rerank):
    """rerank 4: the fused scan over-fetches and ``rescore_exact`` ranks."""
    x, keys, truth = data
    jx = dataclasses.replace(
        jax_index, scan_strategy=strategy, rerank_factor=rerank
    )
    port = interop.from_reference(jx, device="cpu")
    assert isinstance(port, FlatIndex) and port.size == jax_index.size
    assert port.scan_strategy == strategy and port.rerank_factor == rerank
    q = truth.queries[:16]
    dj, ij = jx.query_arrays(10, q)
    dt, it = port.query_arrays(10, q)
    assert np.mean(it.numpy() == np.asarray(ij)) >= 0.99
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=2e-2, atol=1e-2)
    assert abs(_recall10(port, data) - _recall10(jx, data)) <= 0.01


def test_port_build_recall_ratio(data):
    """Finer codes (12 x 64) and 500 queries keep the init-to-init spread
    of recall@10 well under the 1 % the ratio allows."""
    x, keys, _ = data
    cfg = dict(num_clusters=64, num_quantizers=12, max_iters=15)
    port = build_flat_index(keys, x, pq_config=PQConfig(**cfg), device="cpu")
    assert port.codes.shape == (6000, 12) and port.codes.dtype == torch.uint8
    assert list(port.key_index.keys) == sorted(keys)
    jx = jax_build(keys, x, pq_config=JaxPQConfig(**cfg))
    truth = jeval.sample_ground_truth(keys, x, num_samples=500, ks=(10,))
    port.scan_strategy = jx.scan_strategy = "decode"
    r_port = teval.recall_of(port, truth, x, keys)[10].mean
    r_jax = teval.recall_of(jx, truth, x, keys)[10].mean
    assert r_port >= 0.99 * r_jax, (r_port, r_jax)


def test_query_lookup_and_batch_results(data, jax_index):
    x, keys, _ = data
    port = interop.from_reference(jax_index, device="cpu")
    res = port.query(5, x[11])
    ref = jax_index.query(5, x[11])
    assert list(res.keys) == list(ref.keys)
    np.testing.assert_allclose(res.distances, ref.distances, rtol=2e-2, atol=1e-2)
    word = jax_index.key_index.keys[123]
    np.testing.assert_allclose(
        port.lookup(word), jax_index.lookup(word), rtol=1e-6
    )
    assert port.lookup("no-such-word") is None
    assert port.query_by_word(3, word).keys[0] == word
    batch = port.batch_query(4, x[:3])
    assert len(batch) == 3 and all(len(r) == 4 for r in batch)
    with pytest.raises(ValueError):
        port.query_arrays(5, x[:2, :10])  # wrong dimension


def test_cosine_metric(data):
    x, keys, _ = data
    jx = jax_build(keys[:3000], x[:3000], metric=JaxMetric.COSINE,
                   pq_config=JaxPQConfig(**PQ))
    port = interop.from_reference(jx, device="cpu")
    assert port.metric is Metric.COSINE
    q = x[:8] * 3.0  # scale must not matter
    for strategy in ("decode", "pallas"):
        port.scan_strategy = strategy
        jq = dataclasses.replace(jx, scan_strategy=strategy)
        _, it = port.query_arrays(10, q)
        _, ij = jq.query_arrays(10, q)
        assert np.mean(it.numpy() == np.asarray(ij)) >= 0.99


def test_auto_policy_and_kernel_fallback(data, jax_index):
    x, _, _ = data
    port = interop.from_reference(jax_index, device="cpu")
    port.scan_strategy = "auto"
    assert port.resolve_strategy(3, 10) == "lut"
    assert port.resolve_strategy(64, 10) == "decode"  # codes on the CPU
    # outside the kernel's bounds the pallas strategy falls back to decode
    port.scan_strategy = "pallas"
    assert not port._kernel_bounds_ok(200)
    dp, ip = port.query_arrays(200, x[:6])
    dd, idd = dataclasses.replace(port, scan_strategy="decode").query_arrays(200, x[:6])
    np.testing.assert_array_equal(ip.numpy(), idd.numpy())
    np.testing.assert_array_equal(dp.numpy(), dd.numpy())
    small = interop.flat_index_from_numpy(
        port.key_index.keys[:100], port.pq.codebooks.numpy(), port.pq.bounds,
        32, port.codes[:100].numpy(), port.recon_norms[:100].numpy(), device="cpu",
    )
    small.scan_strategy = "pallas"
    _, ids = small.query_arrays(5, x[:4])  # n < 256*k: decode instead
    assert ids.shape == (4, 5)


def test_auto_knobs_match_jax(data, jax_index):
    port = interop.from_reference(jax_index, device="cpu")
    assert port._code_duplication() == pytest.approx(jax_index._code_duplication())
    assert port.resolved_rerank_factor() == jax_index.resolved_rerank_factor()
    assert port.resolved_pallas_winners() == jax_index.resolved_pallas_winners()


def test_deferred_paths_raise(data, jax_index):
    x, keys, _ = data
    port = interop.from_reference(jax_index, device="cpu")
    # add/remove, OPQ, packing and mesh builds are ported
    # (tests/test_torch_update.py, test_torch_opq.py, test_torch_packed.py,
    # test_torch_parallel.py); a mesh that is not a parallel.Mesh raises
    for call in (
        lambda: build_flat_index(
            keys[:500], x[:500], pq_config=PQConfig(**PQ), mesh=object(), device="cpu"
        ),
    ):
        with pytest.raises(TypeError, match="parallel.Mesh"):
            call()
    with pytest.raises(ValueError):
        dataclasses.replace(port, scan_strategy="bogus").query_arrays(5, x[:8])


@pytest.mark.parametrize("opq_iters", [0, 1])
def test_mesh_build_equals_single_process(data, opq_iters):
    """``mesh=`` (four logical CPU shards) trains and encodes over the
    mesh and builds the single-process index: codebooks within 1e-6,
    equal codes and norms."""
    from gulon_tpu_torch.parallel import make_mesh

    x, keys, _ = data
    args = dict(pq_config=PQConfig(**PQ), opq_iters=opq_iters, device="cpu")
    one = build_flat_index(keys[:3000], x[:3000], **args)
    mesh = build_flat_index(keys[:3000], x[:3000], mesh=make_mesh(devices=["cpu"] * 4), **args)
    np.testing.assert_allclose(mesh.pq.codebooks.numpy(), one.pq.codebooks.numpy(), atol=1e-6)
    assert torch.equal(mesh.codes, one.codes)
    np.testing.assert_allclose(mesh.recon_norms.numpy(), one.recon_norms.numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_scan_matches_jax(data, jax_index, dtype):
    """The same decoded cache and padded queries through both packages'
    ``cached_scan``: ids equal, distances within 1e-4 (f32 sums)."""
    x, _, truth = data
    jx = dataclasses.replace(jax_index)
    jx.enable_cache(dtype=getattr(jnp, dtype))
    q_pad = jx._q_pad(jnp.asarray(truth.queries[:16]))
    dj, ij = jscan.cached_scan(
        q_pad, jx.decoded_cache, jx.recon_norms, k=10, tile_rows=2048,
        topk_impl="exact",
    )
    cache = torch.from_numpy(np.array(jx.decoded_cache, np.float32)).to(getattr(torch, dtype))
    dt, it = tscan.cached_scan(
        torch.from_numpy(np.array(q_pad)), cache,
        torch.from_numpy(np.array(jx.recon_norms)), k=10, tile_rows=2048,
    )
    assert np.mean(it.numpy() == np.asarray(ij)) >= 0.99
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)


def test_cached_strategy_policy_and_from_reference(data, jax_index):
    """A JAX index with a cache comes across with one: ``auto`` resolves
    to ``cached`` in both packages (lut still wins at <= 4 queries), and
    the answers match, over-fetch + exact rescore included."""
    x, _, truth = data
    jx = dataclasses.replace(jax_index, rerank_factor=4)
    jx.enable_cache()  # f32 on the CPU
    port = interop.from_reference(jx, device="cpu")
    assert port.decoded_cache is not None and port.decoded_cache.dtype == torch.float32
    np.testing.assert_array_equal(port.decoded_cache.numpy(), np.asarray(jx.decoded_cache))
    assert port.resolve_strategy(64, 10) == "cached"
    assert port.resolve_strategy(3, 10) == "lut"
    q = truth.queries[:32]
    dj, ij = jx.query_arrays(10, q)
    dt, it = port.query_arrays(10, q)
    assert np.mean(it.numpy() == np.asarray(ij)) >= 0.99
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)
    plain = interop.from_reference(jax_index, device="cpu")
    assert plain.decoded_cache is None and plain.resolve_strategy(64, 10) == "decode"
    plain.enable_cache()
    assert plain.resolve_strategy(64, 10) == "cached"
    torch.testing.assert_close(plain.decoded_cache, port.decoded_cache)


def test_cached_kernel_route_matches_jax():
    """The cached strategy's kernel route (``_augment_cache`` + the dense
    scan over the decoded cache) against the JAX package's
    (``test_pallas.py:311``), on a bf16 cache."""
    rng = np.random.default_rng(23)
    n, d = 40960, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    keys = np.array([f"w{i:06d}" for i in range(n)], dtype=object)
    jx = jax_build(keys, x, pq_config=JaxPQConfig(num_clusters=64, num_quantizers=4, max_iters=6))
    jx.enable_cache(dtype=jnp.bfloat16)
    port = interop.from_reference(jx, device="cpu")
    assert port.decoded_cache.dtype == torch.bfloat16
    q_pad = jx._q_pad(jnp.asarray(x[:16] + 0.01))
    aug_j = jflat._augment_cache(jx.decoded_cache, jx.recon_norms)
    aug_t = tflat._augment_cache(port.decoded_cache, port.recon_norms)
    np.testing.assert_array_equal(
        aug_t.view(torch.int16).numpy(), np.asarray(aug_j).view(np.int16)
    )
    dj, ij = jdense.dense_scan_pallas(
        q_pad, aug_j, jx.recon_norms, k=5, interpret=True, rescore=4
    )
    dt, it = tdense.dense_scan_fused(
        torch.from_numpy(np.array(q_pad)), aug_t, port.recon_norms, k=5, rescore=4
    )
    np.testing.assert_array_equal(it.numpy()[:, 0], np.asarray(ij)[:, 0])
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cached kernel route runs K2 on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cached_strategy_runs_k2_on_the_card(cuda_device, data, jax_index):
    x, keys, truth = data
    port = interop.from_reference(jax_index, device=cuda_device)
    port.enable_cache()
    assert port.decoded_cache.dtype == torch.bfloat16
    before = tracing.counter("k2.launches")
    _, ids = port.query_arrays(10, truth.queries[:64])
    assert tracing.counter("k2.launches") == before + 1
    assert port.decoded_cache is None and port._cache_aug is not None
    decode = dataclasses.replace(port, scan_strategy="decode")
    assert _recall10(port, data) >= 0.97 * _recall10(decode, data)


def _outcome(fn):
    """``(dists, ids)`` as numpy arrays, or the exception type raised."""
    try:
        d, i = fn()
    except Exception as e:  # noqa: BLE001 - the type is the outcome
        return type(e)
    return np.asarray(d), np.asarray(i)


def _served_pair(jax_index, strategy):
    """The JAX index with ``strategy`` (and its cache for ``cached``) and
    the port serving the same arrays."""
    jx = dataclasses.replace(jax_index, scan_strategy=strategy)
    if strategy == "cached":
        jx.enable_cache()  # f32 on the CPU
    return jx, interop.from_reference(jx, device="cpu")


def _assert_same_outcome(ref, got, raises):
    """Both raise (a ValueError on the JAX side is a ValueError here too;
    the JAX package's ZeroDivisionError may be any error), or both give
    equal shapes, ids and distances (NaN where the JAX package has NaN)."""
    if raises:
        assert isinstance(ref, type) and issubclass(ref, raises), ref
        assert isinstance(got, type) and issubclass(
            got, ValueError if raises is ValueError else Exception
        ), got
        return
    assert not isinstance(ref, type) and not isinstance(got, type), (ref, got)
    (dj, ij), (dt, it) = ref, got
    assert dt.shape == dj.shape and it.shape == ij.shape
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "strategy,raises",
    [("decode", None), ("lut", None), ("cached", None), ("pallas", ZeroDivisionError)],
)
def test_zero_queries_match_jax(data, jax_index, strategy, raises):
    """A batch of zero queries: ``[0, 10]`` arrays where the JAX package
    gives them (and an empty ``batch_query``), a refusal where it raises
    (the fused scan's planner divides by Q)."""
    x = data[0]
    jx, port = _served_pair(jax_index, strategy)
    q0 = np.zeros((0, x.shape[1]), np.float32)
    _assert_same_outcome(
        _outcome(lambda: jx.query_arrays(10, q0)),
        _outcome(lambda: port.query_arrays(10, q0)), raises,
    )
    if raises is None:
        assert port.batch_query(10, q0) == jx.batch_query(10, q0) == []


@pytest.mark.parametrize(
    "strategy,raises",
    [("decode", ValueError), ("lut", ValueError), ("cached", ValueError), ("pallas", None)],
)
def test_k0_matches_jax(data, jax_index, strategy, raises):
    """k = 0: the streaming scans refuse it as ``lax.approx_min_k`` does
    ("k must be positive"); the fused scan gives ``[Q, 0]``."""
    x = data[0]
    jx, port = _served_pair(jax_index, strategy)
    q = x[:3]
    _assert_same_outcome(
        _outcome(lambda: jx.query_arrays(0, q)), _outcome(lambda: port.query_arrays(0, q)),
        raises,
    )
    if raises:
        with pytest.raises(ValueError, match="k must be positive"):
            port.query_arrays(0, q)


@pytest.mark.parametrize("strategy", ["decode", "lut", "cached"])
def test_nan_query_row_ranks_as_jax(data, jax_index, strategy):
    """A query row with a NaN lane scores NaN against every row: the JAX
    package returns NaN distances and the ids its CPU sort leaves
    (``incomparable_order``), not ``(inf, -1)``; the other rows are
    untouched."""
    x = data[0]
    jx, port = _served_pair(jax_index, strategy)
    q = x[:3].copy()
    q[1, 5] = np.nan
    dj, ij = jx.query_arrays(3, q)
    dt, it = port.query_arrays(3, q)
    assert np.isnan(np.asarray(dj)[1]).all() and np.isnan(dt.numpy()[1]).all()
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("strategy", ["cached", "pallas"])
def test_nan_query_row_with_rerank_matches_jax(data, jax_index, strategy):
    """rerank 4: a NaN-lane row's over-fetched candidates, rescored by
    ``rescore_exact``, give the JAX package's NaN distances and ids."""
    x = data[0]
    jx = dataclasses.replace(jax_index, scan_strategy=strategy, rerank_factor=4)
    if strategy == "cached":
        jx.enable_cache()
    port = interop.from_reference(jx, device="cpu")
    assert port.size < port.tile_rows
    q = x[:3].copy()
    q[1, 5] = np.nan
    dj, ij = map(np.asarray, jx.query_arrays(3, q))
    dt, it = port.query_arrays(3, q)
    np.testing.assert_array_equal(np.isnan(dt.numpy()), np.isnan(dj))
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-4, atol=1e-4)


def _rescore_past_the_last_row(jax_index, device):
    """``rescore_exact`` of candidates past the last row (a NaN row's
    positions in a padded last tile can be): both packages gather them
    clamped to the last row and keep their ids; -1 stays an empty slot
    (``test_torch_kernel_edges.py`` holds the card to the CPU here)."""
    n = jax_index.size
    q = np.random.default_rng(5).normal(size=(2, 24)).astype(np.float32)
    q[1, 3] = np.nan
    cand = np.array([[0, 7, n - 1, n, n + 9, 2 * n], [-1, 3, n + 1, n - 1, 5, 9]], np.int32)
    args = (jax_index.pq.codebooks, jax_index.codes, jax_index.recon_norms)
    dj, ij = map(np.asarray, jscan.rescore_exact(
        jnp.asarray(q), *args, jnp.asarray(cand), bounds=jax_index.pq.bounds, k=4))
    dt, it = tscan.rescore_exact(
        torch.from_numpy(q).to(device),
        *(torch.from_numpy(np.array(a)).to(device) for a in args),
        torch.from_numpy(cand).to(device), bounds=jax_index.pq.bounds, k=4)
    np.testing.assert_array_equal(it.cpu().numpy(), ij)
    np.testing.assert_allclose(dt.cpu().numpy(), dj, rtol=1e-4, atol=1e-4)
    assert (ij[0] >= n).any()


def test_rescore_exact_clamps_ids_past_the_last_row(jax_index):
    _rescore_past_the_last_row(jax_index, "cpu")


@pytest.mark.parametrize("topk_impl", ["approx", "exact"])
def test_tiled_scan_with_a_nan_row_matches_jax(data, jax_index, topk_impl):
    """The decode scan over 1024-row tiles (the last one short, which the
    JAX package pads): ids and distances equal, a NaN-lane query's row
    included (NaN and the JAX package's ids on the stacked route, the
    ``(inf, -1)`` slots on the exact one)."""
    x = data[0]
    q = x[:4].copy()
    q[2, 1] = np.nan
    args = (jax_index.pq.codebooks, jax_index.codes, jax_index.recon_norms)
    dj, ij = map(np.asarray, jscan.adc_scan_decode(
        jnp.asarray(q), *args, bounds=jax_index.pq.bounds, k=5, tile_rows=1024,
        precision="highest", topk_impl=topk_impl))
    dt, it = tscan.adc_scan_decode(
        torch.from_numpy(q), *(torch.from_numpy(np.array(a)) for a in args),
        bounds=jax_index.pq.bounds, k=5, tile_rows=1024, precision="highest",
        topk_impl=topk_impl)
    assert np.isnan(dj[2]).all() == (topk_impl == "approx")
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-4, atol=1e-4)
