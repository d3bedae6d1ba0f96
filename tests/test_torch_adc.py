"""Port parity: the fused ADC scan (kernel K1 and everything around it).

On the CPU the port runs K1's plain PyTorch twin (``_block_scan_plain``)
and the JAX package runs its Pallas kernel in interpret mode, on the same
operands. Block winners: >= 99 % equal ids, values within
``2^-14 * max(|v|, 1)`` (both sum exact bf16 x bf16 products in f32 and
differ only in summation order, plus the center's last bits). Top-k:
>= 99 % equal ids, distances within rtol 1e-4. The kernel itself runs
only on a CUDA card: its test carries the ``cuda`` marker and skips here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gulon_tpu.ops.pallas import adc as jadc
from gulon_tpu.ops.pq import subspace_bounds
from gulon_tpu_torch.ops.cuda import adc as tadc
from gulon_tpu_torch.utils import tracing

torch.set_num_threads(2)

N, D, M, Q = 3000, 24, 6, 12


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(k_codes, seed=0, n=N):
    rng = np.random.default_rng(seed)
    bounds = subspace_bounds(D, M)
    dsub = max(w for _, w in bounds)
    cb = rng.normal(size=(M, k_codes, dsub)).astype(np.float32)
    for s, (_, w) in enumerate(bounds):
        cb[s, :, w:] = 0.0
    cb = cb.astype(jnp.bfloat16).astype(np.float32)  # snapped, as trained
    codes = rng.integers(0, k_codes, size=(n, M)).astype(
        np.uint8 if k_codes <= 256 else np.uint16
    )
    norms = (cb[np.arange(M)[None], codes] ** 2).sum((1, 2)).astype(np.float32)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    return bounds, cb, codes, norms, q


def _winners_close(vj, ij, vt, it, min_equal=0.99):
    tol = 2.0 ** -14 * np.maximum(np.abs(vj), 1.0)
    assert vj.shape == vt.shape
    assert np.mean(ij == it) >= min_equal
    assert np.all(np.abs(vj - vt) <= tol)


CASES = [
    (w, centered, k_codes)
    for w in (1, 2, 4)
    for centered in (False, True)
    for k_codes in (64, 512)
]


@pytest.mark.parametrize("winners,centered,k_codes", CASES)
def test_block_scan_plain_matches_pallas_interpret(winners, centered, k_codes):
    """int8 (K <= 256) and int16 (K = 512) pretransposed code operands;
    the int16 cases use 1024-row tiles, so the winner columns of several
    row tiles interleave rank-major."""
    bounds, cb, codes, norms, q = _problem(k_codes, seed=winners)
    tile = 1024 if k_codes > 256 else 0
    ct_j = jadc.pack_codes_t(codes, k_codes)
    ct_t = tadc.pack_codes_t(_t(codes.astype(np.int32)), k_codes)
    np.testing.assert_array_equal(ct_t.numpy(), np.asarray(ct_j))
    pj = jadc._block_scan(
        jnp.asarray(q), jnp.asarray(cb), ct_j, jnp.asarray(norms),
        bounds=bounds, tile_rows=tile, interpret=True, num_rows=N,
        winners=winners, center_scores=centered,
    )
    k1 = tadc.K1Operands(_t(cb), ct_t, _t(norms), bounds=bounds, num_rows=N,
                         center_scores=centered)
    pt = k1.scan(_t(q), winners=winners, tile_rows=tile)
    np.testing.assert_array_equal(pt[1].numpy(), np.asarray(pj[1]))
    assert k1.codes_t.dtype == ct_t.dtype
    vj, ij = map(np.asarray, jadc.unpack_block_winners(pj[0], pj[1]))
    vt, it = (a.numpy() for a in tadc.unpack_block_winners(pt[0], pt[1]))
    _winners_close(vj, ij, vt, it)


def test_block_scan_from_row_major_codes():
    """[N, m] codes (not pretransposed) take the int32 operand path."""
    bounds, cb, codes, norms, q = _problem(64, seed=9)
    pj = jadc._block_scan(
        jnp.asarray(q), jnp.asarray(cb), jnp.asarray(codes), jnp.asarray(norms),
        bounds=bounds, tile_rows=0, interpret=True, num_rows=0,
        center_scores=True,
    )
    k1 = tadc.K1Operands(_t(cb), _t(codes), _t(norms), bounds=bounds, center_scores=True)
    pt = k1.scan(_t(q))
    assert k1.codes_t.dtype == torch.int32
    vj, ij = map(np.asarray, jadc.unpack_block_winners(pj[0], pj[1]))
    vt, it = (a.numpy() for a in tadc.unpack_block_winners(pt[0], pt[1]))
    _winners_close(vj, ij, vt, it)


def test_block_scan_entry_points_match():
    bounds, cb, codes, norms, q = _problem(64, seed=3)
    vj, ij = jadc.adc_block_scan_pallas(
        jnp.asarray(q), jnp.asarray(cb), jnp.asarray(codes), jnp.asarray(norms),
        bounds=bounds, interpret=True, winners=2,
    )
    vt, it = tadc.adc_block_scan_fused(
        _t(q), _t(cb), _t(codes), _t(norms), bounds=bounds, winners=2
    )
    _winners_close(np.asarray(vj), np.asarray(ij), vt.numpy(), it.numpy())


@pytest.mark.parametrize("rescore", [False, True])
@pytest.mark.parametrize("centered", [False, True])
def test_adc_scan_fused_matches_pallas(rescore, centered):
    bounds, cb, codes, norms, q = _problem(64, seed=5)
    ct = jadc.pack_codes_t(codes, 64)
    dj, ij = jadc.adc_scan_pallas(
        jnp.asarray(q), jnp.asarray(cb), ct, jnp.asarray(norms),
        bounds=bounds, k=10, interpret=True, num_rows=N, rescore=rescore,
        center_scores=centered,
    )
    dt, it = tadc.adc_scan_fused(
        _t(q), _t(cb), tadc.pack_codes_t(_t(codes), 64), _t(norms),
        bounds=bounds, k=10, num_rows=N, rescore=rescore,
        center_scores=centered,
    )
    assert it.dtype == torch.int32 and dt.shape == (Q, 10)
    assert np.mean(it.numpy() == np.asarray(ij)) >= 0.99
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)


def test_adc_scan_fused_pads_small_k():
    """k wider than the row count pads with (inf, -1), as the JAX scan."""
    bounds, cb, codes, norms, q = _problem(64, seed=6, n=512)
    dt, it = tadc.adc_scan_fused(
        _t(q), _t(cb), _t(codes), _t(norms), bounds=bounds, k=2, rescore=True
    )
    dj, ij = jadc.adc_scan_pallas(
        jnp.asarray(q), jnp.asarray(cb), jnp.asarray(codes), jnp.asarray(norms),
        bounds=bounds, k=2, interpret=True, rescore=True,
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4)


REJECTS = {
    "K>1024": dict(k_codes=2048, k=10, n=N),
    "k>128": dict(k_codes=64, k=129, n=N),
    "N<256k": dict(k_codes=64, k=20, n=N),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
@pytest.mark.parametrize("package", ["jax", "torch"])
def test_kernel_limits_raise_value_error(case, package):
    c = REJECTS[case]
    rng = np.random.default_rng(0)
    bounds = subspace_bounds(D, M)
    cb = rng.normal(size=(M, c["k_codes"], 4)).astype(np.float32)
    codes = rng.integers(0, 64, size=(c["n"], M)).astype(np.int32)
    norms = np.ones(c["n"], np.float32)
    q = rng.normal(size=(3, D)).astype(np.float32)
    with pytest.raises(ValueError):
        if package == "jax":
            jadc.adc_scan_pallas(
                jnp.asarray(q), jnp.asarray(cb), jnp.asarray(codes),
                jnp.asarray(norms), bounds=bounds, k=c["k"], interpret=True,
            )
        else:
            tadc.adc_scan_fused(
                _t(q), _t(cb), _t(codes), _t(norms), bounds=bounds, k=c["k"]
            )


@pytest.mark.parametrize("k_codes", [16, 256, 257, 1000, 40000])
def test_pack_codes_t_matches(k_codes):
    rng = np.random.default_rng(k_codes)
    codes = rng.integers(0, k_codes, size=(50, 3)).astype(np.int32)
    ref = np.asarray(jadc.pack_codes_t(codes, k_codes))
    got = tadc.pack_codes_t(_t(codes), k_codes)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)
    assert str(got.dtype).endswith(str(ref.dtype))


def test_geometry_helpers_match():
    for m, dsub in ((8, 13), (16, 19), (4, 4), (128, 8)):
        assert tadc.padded_depth(m, dsub) == jadc.padded_depth(m, dsub)
    for num_q in (1, 16, 200, 1024, 5000):
        for k_codes in (16, 256, 1024):
            for mdp in (16, 112, 1024):
                for w in (1, 2):
                    assert tadc._pick_tiles(num_q, k_codes, mdp, w) == \
                        jadc._pick_tiles(num_q, k_codes, mdp, w)
                    for n, tr in ((700, 0), (400_000, 0), (10_000, 2048)):
                        assert tadc.block_layout(num_q, k_codes, mdp, n, tr, w) \
                            == jadc.block_layout(num_q, k_codes, mdp, n, tr, w)


def test_split_hi_lo_matches():
    rng = np.random.default_rng(1)
    norms = np.abs(rng.normal(50, 20, size=300)).astype(np.float32)
    norms[7] = np.inf  # padding clamps to _BIG, no NaN
    for center in (0.0, 49.5):
        hj = np.asarray(jadc._split_hi_lo(jnp.asarray(norms), center).astype(jnp.float32))
        ht = tadc._split_hi_lo(_t(norms), center).to(torch.float32).numpy()
        np.testing.assert_array_equal(ht, hj)
        assert np.all(np.isfinite(ht))


def test_cpu_operands_take_the_plain_version():
    bounds, cb, codes, norms, q = _problem(64, seed=2)
    k1 = tadc.K1Operands(_t(cb), _t(codes), _t(norms), bounds=bounds)
    args, nblk = k1.operands(_t(q))
    before = tracing.counter("k1.launches")
    out = tadc.fused_block_scan(*args, winners=1, nblk=nblk)
    assert tracing.counter("k1.launches") == before  # no kernel on the CPU
    torch.testing.assert_close(out, tadc._block_scan_plain(*args, winners=1, nblk=nblk))
    with pytest.raises(ValueError):  # f32 queries are not the operand
        tadc.fused_block_scan(
            args[0], args[1], args[2].to(torch.float32), args[3], winners=1, nblk=1
        )
    with pytest.raises(ValueError):
        tadc.fused_block_scan(*args, winners=5, nblk=nblk)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K1 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("winners,centered,k_codes", CASES)
def test_kernel_matches_plain_on_the_card(cuda_device, winners, centered, k_codes):
    bounds, cb, codes, norms, q = _problem(k_codes, seed=winners)
    dev = cuda_device
    k1 = tadc.K1Operands(
        _t(cb).to(dev), tadc.pack_codes_t(_t(codes.astype(np.int32)).to(dev), k_codes),
        _t(norms).to(dev), bounds=bounds, num_rows=N, center_scores=centered,
        _own_width=True,
    )
    args, nblk = k1.operands(_t(q).to(dev), winners=winners, tile_rows=1024)
    assert nblk == 8
    before = tracing.counter("k1.launches")
    got = tadc.fused_block_scan(*args, winners=winners, nblk=8)
    torch.cuda.synchronize()
    assert tracing.counter("k1.launches") == before + 1
    ref = tadc._block_scan_plain(*args, winners=winners, nblk=8)
    base = torch.zeros(got.shape[1], dtype=torch.int32, device=dev)
    vk, ik = (a.cpu().numpy() for a in tadc.unpack_block_winners(got, base))
    vp, ip = (a.cpu().numpy() for a in tadc.unpack_block_winners(ref, base))
    _winners_close(vp, ip, vk, ik, min_equal=0.995)


@pytest.mark.parametrize("winners", [1, 2])
def test_nan_block_winner_is_the_lowest_nan_row(winners):
    """An all-+inf query row scores NaN against every row. Both packages
    let the NaN win every block; which NaN's row bits survive is XLA's
    choice in the JAX kernel (its ``jnp.min``; interpret mode leaves
    another row than the first) and no rule of the reference. The port's
    twin states K1's rule: the packed NaN of the block's lowest NaN row,
    here row 0 of every block, for every winner."""
    bounds, cb, codes, norms, q = _problem(64, seed=3)
    q[1] = np.inf
    ct_j = jadc.pack_codes_t(codes, 64)
    ct_t = tadc.pack_codes_t(_t(codes.astype(np.int32)), 64)
    pj = jadc._block_scan(
        jnp.asarray(q), jnp.asarray(cb), ct_j, jnp.asarray(norms),
        bounds=bounds, tile_rows=0, interpret=True, num_rows=N, winners=winners,
    )
    pt = tadc.K1Operands(_t(cb), ct_t, _t(norms), bounds=bounds, num_rows=N).scan(
        _t(q), winners=winners
    )
    bj = np.asarray(pj[0]).view(np.int32)
    bt = pt[0].numpy().view(np.int32)
    vj = (bj & ~127).view(np.float32)
    vt = (bt & ~127).view(np.float32)
    np.testing.assert_array_equal(np.isnan(vt), np.isnan(vj))
    assert np.isnan(vt[1]).all()
    assert (bt[1] & 127 == 0).all()
    others = np.ones(Q, bool)
    others[1] = False
    _winners_close(vj[others], bj[others] & 127, vt[others], bt[others] & 127)
