"""Port parity: distance, top-k, PQ geometry and the PQ table ops.

The same numpy inputs (fixed seeds) go through ``gulon_tpu`` and
``gulon_tpu_torch``; float outputs agree within rtol = atol = 1e-5 (f32,
summation order differs), integer outputs exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gulon_tpu.ops import distance as jdist
from gulon_tpu.ops import pq as jpq
from gulon_tpu.ops import scan as jscan
from gulon_tpu.ops import topk as jtopk
from gulon_tpu_torch.ops import distance as tdist
from gulon_tpu_torch.ops import pq as tpq
from gulon_tpu_torch.ops import scan as tscan
from gulon_tpu_torch.ops import topk as ttopk

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pq_pair(seed, d=20, m=6, k=16, n=300):
    """A JAX and a port ProductQuantizer over the same random codebooks
    (padding columns zero), plus codes and queries."""
    rng = np.random.default_rng(seed)
    bounds = jpq.subspace_bounds(d, m)
    dsub = max(w for _, w in bounds)
    cb = rng.normal(size=(m, k, dsub)).astype(np.float32)
    for s, (_, w) in enumerate(bounds):
        cb[s, :, w:] = 0.0
    codes = rng.integers(0, k, size=(n, m)).astype(np.uint8)
    q = rng.normal(size=(9, d)).astype(np.float32)
    jq = jpq.ProductQuantizer(jnp.asarray(cb), bounds, k)
    tq = tpq.ProductQuantizer(_t(cb), bounds, k)
    return jq, tq, codes, q


def test_sq_norms_and_normalize_rows():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 7)).astype(np.float32)
    x[3] = 0.0  # zero rows stay zero, no NaN
    np.testing.assert_allclose(
        tdist.sq_norms(_t(x)).numpy(), np.asarray(jdist.sq_norms(x)), **TOL
    )
    out = tdist.normalize_rows(_t(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jdist.normalize_rows(x)), **TOL)
    assert np.all(out[3] == 0.0)


def test_assign_scores_pairwise_nearest():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 9)).astype(np.float32)
    c = rng.normal(size=(17, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tdist.assign_scores(_t(x), _t(c)).numpy(),
        np.asarray(jdist.assign_scores(x, c)), **TOL,
    )
    np.testing.assert_allclose(
        tdist.pairwise_sqdist(_t(x), _t(c)).numpy(),
        np.asarray(jdist.pairwise_sqdist(x, c)), **TOL,
    )
    near = tdist.nearest(_t(x), _t(c))
    assert near.dtype == torch.int32
    np.testing.assert_array_equal(near.numpy(), np.asarray(jdist.nearest(x, c)))


def test_nearest_ties_go_to_lowest_index():
    x = np.zeros((4, 3), np.float32)
    c = np.ones((5, 3), np.float32)  # all centroids equidistant
    assert tdist.nearest(_t(x), _t(c)).tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("k", [1, 3, 10, 40])
def test_smallest_k_keeps_lax_top_k_tie_order(k):
    """Among equal values the lowest index comes first, as lax.top_k."""
    rng = np.random.default_rng(k)
    d = rng.integers(0, 5, size=(6, 40)).astype(np.float32)  # many ties
    vj, ij = jtopk.smallest_k(jnp.asarray(d), k)
    vt, it = ttopk.smallest_k(_t(d), k)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_smallest_k_ranks_on_the_total_order():
    """NaN of either sign, infinities and signed zeros rank as lax.top_k of
    the negated values ranks them: -NaN first, +NaN after +inf."""
    nan = np.float32(np.nan)
    d = np.array([[1.0, nan, np.inf, -0.0, 0.0, -nan, -np.inf, 0.0, -0.0, 2.0]], np.float32)
    vj, ij = jtopk.smallest_k(jnp.asarray(d), d.shape[1])
    vt, it = ttopk.smallest_k(_t(d), d.shape[1])
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy().view(np.int32), np.asarray(vj).view(np.int32))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_smallest_k_nan_last_ranks_kernel_winners_as_jax(dtype):
    """The kernels' epilogues rank lane-stripped block winners (f32 for
    K1 / K2, int32 for K3) with the plain stable sort: on such rows (ties,
    +inf and _BIG padding, an all-NaN row of one NaN) it gives lax.top_k's
    order, as ``smallest_k`` does; a NaN of either sign goes last."""
    rng = np.random.default_rng(3)
    d = rng.integers(-50, 50, size=(4, 300)).astype(dtype)  # many ties
    if dtype == np.float32:
        d[1, ::7] = np.inf
        d[2, ::5] = np.float32(3.0e38)
        d[3] = np.float32(np.nan)
    vj, ij = jtopk.smallest_k(jnp.asarray(d), 40)
    for fn in (ttopk.smallest_k_nan_last, ttopk.smallest_k):
        vt, it = fn(_t(d), 40)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    nan = np.float32(np.nan)
    _, it = ttopk.smallest_k_nan_last(_t(np.array([[nan, 1.0, -nan, np.inf]], np.float32)), 4)
    np.testing.assert_array_equal(it.numpy(), [[1, 3, 0, 2]])


@pytest.mark.parametrize("n", [5, 16, 17, 100, 1000, 6000, 16384])
def test_approx_smallest_k_orders_a_nan_row_as_the_cpu_sort(n):
    """A row of NaN (either sign): ``lax.approx_min_k`` on the CPU leaves
    libstdc++'s introsort order of incomparable elements, which
    ``incomparable_order`` computes from the length alone; a row with a
    finite value keeps ``smallest_k``'s order; k < 1 raises."""
    rng = np.random.default_rng(n)
    k = min(n, 7)
    d = np.full((3, n), np.nan, np.float32)
    d[1] = np.where(rng.random(n) < 0.5, d[1], -d[1])
    d[2] = rng.normal(size=n).astype(np.float32)
    _, ij = jax.lax.approx_min_k(jnp.asarray(d[:2]), k)
    vt, it = ttopk.approx_smallest_k(_t(d), k)
    np.testing.assert_array_equal(it.numpy()[:2], np.asarray(ij))
    assert np.isnan(vt.numpy()[:2]).all()
    np.testing.assert_array_equal(it.numpy()[2], np.argsort(d[2], kind="stable")[:k])
    with pytest.raises(ValueError, match="k must be positive"):
        ttopk.approx_smallest_k(_t(d), 0)


def test_merge_topk():
    rng = np.random.default_rng(2)
    da = np.sort(rng.integers(0, 6, size=(5, 8)).astype(np.float32), axis=1)
    db = np.sort(rng.integers(0, 6, size=(5, 8)).astype(np.float32), axis=1)
    ia = rng.permutation(40)[:8].astype(np.int32)[None].repeat(5, 0)
    ib = (100 + rng.permutation(40)[:8]).astype(np.int32)[None].repeat(5, 0)
    vj, idj = jtopk.merge_topk(da, ia, db, ib, 6)
    vt, idt = ttopk.merge_topk(_t(da), _t(ia), _t(db), _t(ib), 6)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(idt.numpy(), np.asarray(idj))


@pytest.mark.parametrize("d", [1, 2, 7, 13, 25, 64, 100, 300])
def test_subspace_bounds_match_over_many_shapes(d):
    for m in range(1, min(d, 40) + 1):
        assert tpq.subspace_bounds(d, m) == jpq.subspace_bounds(d, m)
    for bad in (0, d + 1):
        with pytest.raises(ValueError):
            tpq.subspace_bounds(d, bad)


def test_code_dtype_and_width():
    assert tpq.code_dtype(256) == torch.uint8
    assert tpq.code_dtype(257) == torch.int32  # every 16-bit code fits
    with pytest.raises(ValueError):
        tpq.code_dtype(65537)
    for k in (1, 2, 3, 16, 255, 256, 257, 4096, 65536):
        assert tpq.code_width(k) == jpq.code_width(k)


def test_split_subspaces():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(30, 23)).astype(np.float32)
    bounds = jpq.subspace_bounds(23, 5)
    out = tpq.split_subspaces(_t(x), bounds, 5).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(jpq.split_subspaces(jnp.asarray(x), bounds, 5))
    )


def test_decode_and_reconstruction_norms():
    jq, tq, codes, _ = _pq_pair(4)
    np.testing.assert_allclose(
        tq.decode(_t(codes)).numpy(), np.asarray(jq.decode(jnp.asarray(codes))),
        **TOL,
    )
    np.testing.assert_allclose(
        tq.reconstruction_norms(_t(codes)).numpy(),
        np.asarray(jq.reconstruction_norms(jnp.asarray(codes))), **TOL,
    )
    np.testing.assert_allclose(
        tq.cnorms().numpy(), np.asarray(jq.cnorms()), **TOL
    )


def test_lut_matches():
    jq, tq, _, q = _pq_pair(5)
    np.testing.assert_allclose(
        tq.lut(q).numpy(), np.asarray(jq.lut(jnp.asarray(q))), **TOL
    )
    qs = tq.split(q)
    np.testing.assert_allclose(
        tpq._lut(qs, tq.codebooks).numpy(),
        np.asarray(jpq._lut(jnp.asarray(qs.numpy()), jq.codebooks)), **TOL,
    )


@pytest.mark.parametrize("impl", ["auto", "gather", "onehot"])
def test_decode_tile_matches_every_jax_impl(impl):
    jq, tq, codes, _ = _pq_pair(6)
    ref = np.asarray(
        jscan.decode_tile(jq.codebooks, jnp.asarray(codes, jnp.int32), impl, "highest")
    )
    out = tscan.decode_tile(tq.codebooks, _t(codes.astype(np.int32)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        tscan.resolve_precision("float64")
