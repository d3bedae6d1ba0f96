"""Port parity: the fused dense scans (kernels K2 and K3, and everything
around them).

On the CPU the port runs the kernels' plain PyTorch twins and the JAX
package runs its Pallas kernels in interpret mode, on the same operands.
K2's block winners: >= 99 % equal ids, values within
``2^-14 * max(|v|, 1)`` (both sum exact bf16 products in f32 and differ
only in summation order). K3's block winners are integers: equal bit for
bit. Top-k: ids equal, distances within rtol/atol 1e-4. The kernels
themselves run only on a CUDA card: their tests carry the ``cuda`` marker
and skip here.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gulon_tpu.ops.distance import sq_norms as jsq_norms
from gulon_tpu.ops.pallas import dense as jdense
from gulon_tpu_torch.ops.cuda import dense as tdense
from gulon_tpu_torch.utils import tracing

torch.set_num_threads(2)

Q = 24


def _t(a):
    return torch.from_numpy(np.array(a))


def _corpus(n, d, seed=0):
    """Clustered rows (distinct neighbours, norms of a realistic spread)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, d)).astype(np.float32)
    x = centers[rng.integers(0, 64, n)] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    q = x[rng.choice(n, Q, replace=False)] + 0.05 * rng.normal(size=(Q, d)).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32)


def _jax_packed(kernel, data, q_aug, t, out_dtype, pad_lanes):
    """Raw ``[Q, ceil(n/128)]`` packed winners of a JAX dense kernel in
    interpret mode, padded and launched as ``dense_scan_pallas*`` do."""
    n, dp = data.shape
    qt = -(-Q // 16) * 16
    dt = data
    if n % t:
        pad = jnp.zeros(((-n) % t, dp), data.dtype)
        for lane, value in pad_lanes:
            pad = pad.at[:, lane].set(value)
        dt = jnp.concatenate([dt, pad], axis=0)
    qT = jnp.pad(q_aug, ((0, qt - Q), (0, 0))).T
    nblk = t // 128
    out = pl.pallas_call(
        functools.partial(kernel, tile_rows=t),
        grid=(dt.shape[0] // t, 1),
        in_specs=[
            pl.BlockSpec((t, dp), lambda r, q: (r, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((dp, qt), lambda r, q: (0, q), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((nblk, qt), lambda r, q: (r, q), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((dt.shape[0] // t * nblk, qt), out_dtype),
        interpret=True,
    )(dt, qT)
    return np.asarray(out.T[:Q, : -(-n // 128)])


def _bf16_operands(n, d, seed=0):
    x, q = _corpus(n, d, seed)
    norms = jsq_norms(jnp.asarray(x))
    data_j = jdense.prepare_data(jnp.asarray(x), norms)
    dp = data_j.shape[1]
    q_aug = np.concatenate(
        [-2.0 * q, np.zeros((Q, dp - d - 2), np.float32), np.ones((Q, 2), np.float32)],
        axis=1,
    )
    return x, q, norms, data_j, q_aug


def _winners(packed_i32):
    """(values, ids-in-block-space) of packed f32 winners given as int32 bits."""
    vals = (packed_i32 & ~127).view(np.float32)
    ids = np.arange(packed_i32.shape[1])[None, :] * 128 + (packed_i32 & 127)
    return vals, ids


def _winners_close(pj, pt, min_equal=0.99):
    vj, ij = _winners(pj.view(np.int32))
    vt, it = _winners(pt.view(np.int32))
    assert vj.shape == vt.shape
    assert np.mean(ij == it) >= min_equal
    tol = 2.0 ** -14 * np.maximum(np.abs(vj), 1.0)
    assert np.all(np.abs(vj - vt) <= tol)
    # an id mismatch is a near-tie: the two winners' values agree within tol
    assert np.all(np.abs(vj - vt)[ij != it] <= tol[ij != it])


def test_padded_dims_match():
    for d in (1, 6, 8, 24, 100, 102, 300, 1024):
        assert tdense.padded_dim(d) == jdense.padded_dim(d)
        assert tdense.padded_dim_i8(d) == jdense.padded_dim_i8(d)


def test_prepare_data_matches():
    """Bit for bit with the same norms; +inf norms clamp (no NaN lanes).
    Norms the port computes itself may differ in the last bit (the f32
    sums run in another order), and each package's hi + lo recovers its
    norm to 2^-17 relative, so that case compares within 2^-15."""
    x, _ = _corpus(3000, 20, seed=1)
    norms = np.array(jsq_norms(jnp.asarray(x)))
    norms[5] = np.inf
    got = tdense.prepare_data(_t(x), _t(norms))
    ref = jdense.prepare_data(jnp.asarray(x), jnp.asarray(norms))
    assert got.dtype == torch.bfloat16 and got.shape == (3000, 24)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(), np.asarray(ref).view(np.int16)
    )
    assert np.all(np.isfinite(got.to(torch.float32).numpy()))
    own = tdense.prepare_data(_t(x)).to(torch.float32).numpy()
    ref_own = np.asarray(jdense.prepare_data(jnp.asarray(x)).astype(jnp.float32))
    np.testing.assert_array_equal(own[:, :20], ref_own[:, :20])
    hl = lambda a: a[:, -2].astype(np.float64) + a[:, -1]  # noqa: E731
    np.testing.assert_allclose(hl(own), hl(ref_own), rtol=2.0 ** -15)


def test_prepare_data_i8_matches():
    """Data lanes, scale and gain equal; nmean within 1e-6 relative (the
    f32 mean reduces in another order); digit pairs within one unit on at
    most 0.1 % of rows."""
    x, _ = _corpus(20000, 40, seed=2)
    norms = jsq_norms(jnp.asarray(x))
    dj, mj, nj = jdense.prepare_data_i8(jnp.asarray(x), norms)
    dt, mt, nt = tdense.prepare_data_i8(_t(x), _t(norms))
    dj = np.asarray(dj)
    dt = dt.numpy()
    assert dt.dtype == np.int8 and dt.shape == dj.shape == (20000, 64)
    np.testing.assert_array_equal(dt[:, :40], dj[:, :40])
    np.testing.assert_array_equal(dt[:, 40:-2], 0)
    assert (mt.scale, mt.gain, mt.d, mt.dp) == (mj.scale, mj.gain, mj.d, mj.dp)
    assert mt.nmean == pytest.approx(mj.nmean, rel=1e-6)
    digits = lambda a: a[:, -2].astype(np.int32) * 127 + a[:, -1]  # noqa: E731
    diff = np.abs(digits(dt) - digits(dj))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3
    assert np.all((dt[:, -1] >= 0) & (dt[:, -1] <= 126))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    with pytest.raises(dataclasses.FrozenInstanceError):
        mt.scale = 1.0


def test_prepare_data_i8_wild_norms_raise():
    """One row at full scale over an all-zero corpus: its norm deviation
    needs gain 127 > 64, and both packages refuse the int8 operand."""
    x = np.zeros((4096, 256), np.float32)
    x[0] = 1.0
    for prep, arr in ((jdense.prepare_data_i8, jnp.asarray), (tdense.prepare_data_i8, _t)):
        with pytest.raises(ValueError, match="gain"):
            prep(arr(x))


@pytest.mark.parametrize("n,tile", [(8192, 1024), (9000, 0), (12345, 2048)])
def test_dense_block_scan_plain_matches_pallas(n, tile):
    """n not a multiple of 128 or 1024: the tail rows score as the JAX
    padding rows, and the port's output is the JAX output's first
    ceil(n/128) columns."""
    _, _, _, data_j, q_aug = _bf16_operands(n, 30, seed=n)
    t = tile or -(-n // 1024) * 1024
    pj = _jax_packed(
        jdense._dense_kernel, data_j, jnp.asarray(q_aug).astype(jnp.bfloat16), t,
        jnp.float32, [(data_j.shape[1] - 2, jnp.asarray(jdense._BIG, jnp.bfloat16))],
    )
    data_t = _t(np.asarray(data_j).view(np.int16)).view(torch.bfloat16)
    pt = tdense._dense_block_scan_plain(data_t, _t(q_aug).to(torch.bfloat16))
    assert pt.shape == (Q, -(-n // 128)) and pt.dtype == torch.float32
    _winners_close(pj, pt.numpy())


@pytest.mark.parametrize("n,tile", [(8192, 1024), (9000, 0), (12345, 2048)])
def test_dense_block_scan_plain_i8_matches_pallas(n, tile):
    """Integer scores: equal bit for bit, tail block included."""
    x, q = _corpus(n, 40, seed=n)
    data8, meta, _ = jdense.prepare_data_i8(jnp.asarray(x))
    qi = np.clip(np.round(-q / np.float32(meta.scale * meta.gain)), -127, 127)
    q_aug = np.concatenate(
        [qi, np.zeros((Q, meta.dp - meta.d - 2)), np.full((Q, 1), 127.0), np.ones((Q, 1))],
        axis=1,
    ).astype(np.int8)
    t = tile or -(-n // 1024) * 1024
    dp = meta.dp
    pj = _jax_packed(
        jdense._dense_kernel_i8, data8, jnp.asarray(q_aug), t, jnp.int32,
        [(dp - 2, jnp.int8(127)), (dp - 1, jnp.int8(126))],
    )
    pt = tdense._dense_block_scan_plain_i8(_t(data8), _t(q_aug))
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), pj)


def _wild_tail_operands(n=1000, d=62):
    """int8 rows uniform in [-127, 127] except the last, partly filled
    block, whose real rows are all 127; queries of positive lanes. Every
    real row of that block scores above the padding rows' 16255."""
    rng = np.random.default_rng(5)
    dp = tdense.padded_dim_i8(d)
    data8 = rng.integers(-127, 128, (n, dp)).astype(np.int8)
    data8[(n - 1) // 128 * 128 :] = 127
    qi = rng.integers(1, 128, (Q, d)).astype(np.float32)
    meta = dict(scale=1.0, nmean=0.0, d=d, dp=dp, gain=1)  # query lanes round(-q) = qi
    return data8, -qi, meta


@pytest.mark.parametrize("rescore", [0, 4])
def test_mixed_tail_block_matches_pallas_i8(rescore):
    """The int8 padding rule on a wild last block: a padding row (16255)
    wins it in both packages' block winners, bit for bit, and its winner
    is dropped (id >= n) by both epilogues, which then agree."""
    n = 1000
    data8, q, meta = _wild_tail_operands(n)
    dp = meta["dp"]
    q_aug = np.concatenate(
        [-q, np.zeros((Q, dp - meta["d"] - 2)), np.full((Q, 1), 127.0), np.ones((Q, 1))], axis=1
    ).astype(np.int8)
    pj = _jax_packed(
        jdense._dense_kernel_i8, jnp.asarray(data8), jnp.asarray(q_aug), 1024, jnp.int32,
        [(dp - 2, jnp.int8(127)), (dp - 1, jnp.int8(126))],
    )
    pt = tdense._dense_block_scan_plain_i8(_t(data8), _t(q_aug))
    np.testing.assert_array_equal(pt.numpy(), pj)
    assert np.all((pj[:, -1] & 127) >= n % 128)  # a padding row won
    norms = np.zeros(n, np.float32)
    dj, ij = jdense.dense_scan_pallas_i8(
        jnp.asarray(q), jnp.asarray(data8), jdense.DenseI8Meta(**meta), jnp.asarray(norms),
        k=2, interpret=True, rescore=rescore,
    )
    dt, it = tdense.dense_scan_fused_i8(
        _t(q), _t(data8), tdense.DenseI8Meta(**meta), _t(norms), k=2, rescore=rescore,
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)
    assert np.all(it.numpy() < (n - 1) // 128 * 128)  # nothing from the wild block


RESCORE = {"raw": dict(rescore=0), "operand": dict(rescore=4), "rows": dict(rescore=4, rows=True)}


@pytest.mark.parametrize("mode", sorted(RESCORE))
@pytest.mark.parametrize("n", [16384, 20000])
def test_dense_scan_fused_matches_pallas(mode, n):
    x, q, norms, data_j, _ = _bf16_operands(n, 32, seed=7)
    opt = RESCORE[mode]
    dj, ij = jdense.dense_scan_pallas(
        jnp.asarray(q), data_j, norms, k=10, interpret=True, rescore=opt["rescore"],
        rescore_rows=jnp.asarray(x) if opt.get("rows") else None,
    )
    data_t = _t(np.asarray(data_j).view(np.int16)).view(torch.bfloat16)
    dt, it = tdense.dense_scan_fused(
        _t(q), data_t, _t(norms), k=10, rescore=opt["rescore"],
        rescore_rows=_t(x) if opt.get("rows") else None,
    )
    assert it.dtype == torch.int32 and dt.shape == (Q, 10)
    np.testing.assert_array_equal(it.numpy()[:, 0], np.asarray(ij)[:, 0])
    assert np.mean(it.numpy() == np.asarray(ij)) >= 0.99
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", sorted(RESCORE))
@pytest.mark.parametrize("n", [16384, 20000])
def test_dense_scan_fused_i8_matches_pallas(mode, n):
    """The same JAX-prepared int8 operand serves both packages."""
    x, q = _corpus(n, 48, seed=8)
    norms = jsq_norms(jnp.asarray(x))
    data8, meta_j, _ = jdense.prepare_data_i8(jnp.asarray(x), norms)
    meta_t = tdense.DenseI8Meta(meta_j.scale, meta_j.nmean, meta_j.d, meta_j.dp, meta_j.gain)
    opt = RESCORE[mode]
    dj, ij = jdense.dense_scan_pallas_i8(
        jnp.asarray(q), data8, meta_j, norms, k=10, interpret=True,
        rescore=opt["rescore"], rescore_rows=jnp.asarray(x) if opt.get("rows") else None,
    )
    dt, it = tdense.dense_scan_fused_i8(
        _t(q), _t(data8), meta_t, _t(norms), k=10, rescore=opt["rescore"],
        rescore_rows=_t(x) if opt.get("rows") else None,
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)


def test_small_corpus_pads_k_with_inf():
    """k wider than the row count pads with (inf, -1), as the JAX scan."""
    x, q, norms, data_j, _ = _bf16_operands(512, 16, seed=4)
    data_t = _t(np.asarray(data_j).view(np.int16)).view(torch.bfloat16)
    dj, ij = jdense.dense_scan_pallas(
        jnp.asarray(q), data_j, norms, k=2, interpret=True, rescore=4
    )
    dt, it = tdense.dense_scan_fused(_t(q), data_t, _t(norms), k=2, rescore=4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)


REJECTS = {
    "k>128": dict(k=129),
    "n<256k": dict(k=40),
    "tile_rows": dict(k=5, tile_rows=1000),
    "width": dict(k=5, width=-8),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("operand", ["bf16", "int8"])
def test_kernel_limits_raise_value_error(case, package, operand):
    c = REJECTS[case]
    x, q = _corpus(8192, 16, seed=5)
    if operand == "bf16":
        data = np.asarray(jdense.prepare_data(jnp.asarray(x)).astype(jnp.float32))
        if "width" in c:
            data = data[:, : c["width"]]
    else:
        data8, meta, _ = jdense.prepare_data_i8(jnp.asarray(x))
        data = np.asarray(data8)
        if "width" in c:
            meta = jdense.DenseI8Meta(meta.scale, meta.nmean, meta.d, meta.dp + 32, meta.gain)
    norms = np.ones(8192, np.float32)
    kw = dict(k=c["k"], tile_rows=c.get("tile_rows", 0))
    with pytest.raises(ValueError):
        if package == "jax" and operand == "bf16":
            jdense.dense_scan_pallas(
                jnp.asarray(q), jnp.asarray(data).astype(jnp.bfloat16),
                jnp.asarray(norms), interpret=True, **kw,
            )
        elif package == "jax":
            jdense.dense_scan_pallas_i8(
                jnp.asarray(q), jnp.asarray(data), meta, jnp.asarray(norms),
                interpret=True, **kw,
            )
        elif operand == "bf16":
            tdense.dense_scan_fused(
                _t(q), _t(data).to(torch.bfloat16), _t(norms), **kw
            )
        else:
            meta_t = tdense.DenseI8Meta(meta.scale, meta.nmean, meta.d, meta.dp, meta.gain)
            tdense.dense_scan_fused_i8(_t(q), _t(data), meta_t, _t(norms), **kw)


def test_cpu_operands_take_the_plain_versions():
    x, q = _corpus(4096, 24, seed=6)
    data = tdense.prepare_data(_t(x))
    q_op = torch.ones((3, data.shape[1]), dtype=torch.bfloat16)
    data8, _, _ = tdense.prepare_data_i8(_t(x))
    q8 = torch.ones((3, data8.shape[1]), dtype=torch.int8)
    before = (tracing.counter("k2.launches"), tracing.counter("k3.launches"))
    torch.testing.assert_close(
        tdense.dense_block_scan(data, q_op), tdense._dense_block_scan_plain(data, q_op)
    )
    torch.testing.assert_close(
        tdense.dense_block_scan_i8(data8, q8), tdense._dense_block_scan_plain_i8(data8, q8)
    )
    after = (tracing.counter("k2.launches"), tracing.counter("k3.launches"))
    assert after == before  # no kernel on the CPU
    with pytest.raises(ValueError):  # f32 queries are not the operand
        tdense.dense_block_scan(data, q_op.to(torch.float32))
    with pytest.raises(ValueError):  # int8 width must be 32-aligned
        tdense.dense_block_scan_i8(data8[:, :24].contiguous(), q8[:, :24].contiguous())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels K2 and K3 run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,num_q", [(8192, 30, 24), (9000, 102, 200), (40001, 300, 130)])
def test_kernels_match_plain_on_the_card(cuda_device, n, d, num_q):
    """K2 within the plain twin's tolerance, K3 bit for bit, ragged tails
    and partial query tiles included."""
    rng = np.random.default_rng(n)
    x = _t(rng.normal(size=(n, d)).astype(np.float32)).to(cuda_device)
    q = _t(rng.normal(size=(num_q, d)).astype(np.float32)).to(cuda_device)
    data = tdense.prepare_data(x)
    q_op = torch.cat(
        [-2.0 * q, torch.zeros((num_q, data.shape[1] - d - 2), device=cuda_device),
         torch.ones((num_q, 2), device=cuda_device)], dim=1,
    ).to(torch.bfloat16)
    before = tracing.counter("k2.launches")
    got = tdense.dense_block_scan(data, q_op)
    torch.cuda.synchronize()
    assert tracing.counter("k2.launches") == before + 1
    ref = tdense._dense_block_scan_plain(data, q_op)
    _winners_close(ref.cpu().numpy(), got.cpu().numpy(), min_equal=0.995)

    data8, meta, _ = tdense.prepare_data_i8(x)
    q8 = torch.randint(-127, 128, (num_q, meta.dp), device=cuda_device).to(torch.int8)
    before = tracing.counter("k3.launches")
    got8 = tdense.dense_block_scan_i8(data8, q8)
    torch.cuda.synchronize()
    assert tracing.counter("k3.launches") == before + 1
    torch.testing.assert_close(got8, tdense._dense_block_scan_plain_i8(data8, q8), rtol=0, atol=0)
