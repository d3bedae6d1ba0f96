"""Kernels K1 (fused ADC block scan), K2 (bf16 dense block scan) and K3
(int8 dense block scan) at their edge shapes: 1, 7, 129 and 1000
queries, ragged row counts, depth 100 (not a multiple of 16), 1-4
winners centered and uncentered, K = 512 and K = 1024 int16 codes, NaN
rows, an all-+inf query (each block's winner the packed NaN of its
lowest row), IVF padding rows, K1 at depths from 304 to 1000, held decoded and
streamed, and K3 at Dp 32 to 1600 (every ragged last chunk, a 128-query
tile, streamed query chunks), all-+-127 lanes and a last block won by a
padding row (the cases of ``chip_smoke.py``).

On a CUDA card each kernel is held against its plain PyTorch version on
the same seeded operands (tests marked ``cuda``; they skip without a
card). On the CPU the same operands go through the wrappers, which take
the plain versions, and the shape helpers, comparisons and bounds that
``chip_smoke.py`` reports are checked."""

import pytest
import torch

import chip_smoke as cs
from gulon_tpu_torch.ops.cuda import adc, dense
from gulon_tpu_torch.utils import tracing


def _k1_id(case):
    n, d, m, k_codes, q_n, w, centered, extra = case
    return f"n{n}-d{d}-m{m}-K{k_codes}-q{q_n}-w{w}-{'c' if centered else 'u'}-{extra}"


def _k2_id(case):
    n, d, q_n, nan = case
    return f"n{n}-d{d}-q{q_n}{'-nan' if nan else ''}"


def _k3_id(case):
    n, dp, q_n, lanes = case
    return f"n{n}-dp{dp}-q{q_n}-{lanes or 'uniform'}"


def _k1(case, dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    return cs.k1_operands(gen, *case, dev=dev)


def _k2(case, dev):
    gen = torch.Generator(device=dev).manual_seed(11)
    return cs.k2_operands(gen, *case, dev=dev)


def _k3(case, dev):
    gen = torch.Generator(device=dev).manual_seed(13)
    return cs.k3_operands(gen, *case, dev=dev)


@pytest.mark.parametrize("case", cs.K1_EDGE_CASES, ids=_k1_id)
def test_k1_edge_plain_on_cpu(case):
    """The wrapper takes the plain version on CPU tensors; its winners have
    the kernel's output shape, NaN rows win their blocks, padding rows
    never win, and the comparison catches a value off by 2^-10."""
    n, d, m, k_codes, q_n, winners, centered, extra = case
    operands, nblk, real = _k1(case, "cpu")
    assert operands[0].dtype == (torch.int8 if k_codes <= 256 else torch.int16)
    codes_t, _, q_op, cb = operands
    assert q_op.shape[1] % 8 == 0 and q_op.shape[1] >= codes_t.shape[0] * cb.shape[2] + 4
    before = tracing.counter("k1.launches")
    got = adc.fused_block_scan(*operands, winners=winners, nblk=nblk)
    assert tracing.counter("k1.launches") == before
    assert got.shape == (q_n, operands[0].shape[1] // 128 * winners)
    assert cs.compare_packed(got, got)["ok"]
    vals = (got.view(torch.int32) & ~127).view(torch.float32)
    if extra == "nan":
        assert int(torch.isnan(vals).sum()) > 0
    if extra == "infq":  # every block's winner is its lowest NaN row
        assert bool(torch.isnan(vals[0]).all()) and bool((got[0].view(torch.int32) & 127 == 0).all())
        assert not bool(torch.isnan(vals[1:]).any())
    if extra == "sentinel":
        assert int(real.min()) == 0 and int(real.max()) == 128
        assert cs.winners_valid(got, real, winners, nblk)
        assert not cs.winners_valid(got, torch.clamp(real - 1, min=0), winners, nblk)
    off = got.clone()
    r, c = (int(i) for i in torch.nonzero(vals.abs() < 1e30)[0])
    off[r, c] = vals[r, c] + 2.0 ** -10 * max(abs(float(vals[r, c])), 1.0)
    assert not cs.compare_packed(off, got)["values_ok"]


@pytest.mark.parametrize("case", cs.K2_EDGE_CASES, ids=_k2_id)
def test_k2_edge_plain_on_cpu(case):
    """The wrapper takes the plain version on CPU tensors; rows past the
    ragged end never win, NaN rows win their blocks."""
    n, d, q_n, nan = case
    data, q_op = _k2(case, "cpu")
    assert data.shape[1] % 8 == 0 and q_op.shape == (q_n, data.shape[1])
    before = tracing.counter("k2.launches")
    got = dense.dense_block_scan(data, q_op)
    assert tracing.counter("k2.launches") == before
    assert got.shape == (q_n, -(-n // 128))
    ids = got.view(torch.int32) & 127
    vals = (got.view(torch.int32) & ~127).view(torch.float32)
    if n % 128:  # (a NaN winner's row bits are torch.amin's on the CPU)
        assert bool((ids[:, -1] < n % 128)[~torch.isnan(vals[:, -1])].all())
    assert bool(torch.isnan(vals).any()) == nan
    scale = cs.dense_scale(data, q_op, got)
    assert scale.shape == got.shape
    assert cs.compare_packed(got, got, scale)["ok"]


def _block_winners_int64(data, q_op, start):
    """Packed winners of the 128-row block at ``start`` from an int64
    product, rows past the end scoring 16255 (the JAX padding rule)."""
    s = data[start : start + 128].long() @ q_op.long().T  # [r, Q]
    s = torch.cat([s, torch.full((128 - s.shape[0], s.shape[1]), 127 * 127 + 126)])
    return ((s & ~127) | torch.arange(128)[:, None]).amin(0).int()


@pytest.mark.parametrize("case", cs.K3_EDGE_CASES, ids=_k3_id)
def test_k3_edge_plain_on_cpu(case):
    """The wrapper takes the plain version on CPU tensors: ``[Q,
    ceil(n/128)]`` int32 winners; the first and the last block equal an
    int64 product under the tail rule, so the +-127 extremes are exact; in
    the wild case a padding row wins the last block."""
    n, dp, q_n, lanes = case
    data, q_op = _k3(case, "cpu")
    assert data.dtype == q_op.dtype == torch.int8 and q_op.shape == (q_n, dp)
    before = tracing.counter("k3.launches")
    got = dense.dense_block_scan_i8(data, q_op)
    assert tracing.counter("k3.launches") == before
    assert got.shape == (q_n, -(-n // 128)) and got.dtype == torch.int32
    last = (n - 1) // 128 * 128
    assert torch.equal(got[:, 0], _block_winners_int64(data, q_op, 0))
    assert torch.equal(got[:, -1], _block_winners_int64(data, q_op, last))
    if lanes == "pm127":  # query r meets its negation in row r
        floor = (-127 * 127 * dp) & ~127
        rows = torch.arange(min(n, q_n))
        assert bool((got[rows, rows // 128] == floor | rows % 128).all())
        assert int(got.min()) >= floor
    winner_rows = got[:, -1] & 127
    if lanes == "wild":  # every real row of the last block scores >= 127 Dp
        assert bool((winner_rows >= n - last).all())
        assert bool((got[:, -1] & ~127 == (127 * 127 + 126) & ~127).all())
    elif n % 128:
        assert bool((winner_rows < n - last).all())


def test_winner_columns_invert_the_kernel_layout():
    nblk, winners, n_tiles = 4, 3, 2
    n_cols = n_tiles * nblk * winners
    block, rank = adc._winner_blocks(n_cols, winners, nblk, "cpu")
    blocks = torch.arange(n_tiles * nblk)
    for w in range(winners):
        cols = adc._winner_columns(blocks, w, winners, nblk)
        assert torch.equal(block[cols], blocks)
        assert bool((rank[cols] == w).all())


def test_bounds_from_shapes():
    """The bounds at the path shapes (1024 queries), from meta tensors."""
    meta = dict(device="meta")
    k2 = cs.dense_bound(
        torch.empty((2_000_000, 304), dtype=torch.bfloat16, **meta),
        torch.empty((1024, 304), dtype=torch.bfloat16, **meta),
    )
    assert k2["bound_by"] == "operations" and k2["bound_resource"] == "tensor cores (bf16)"
    assert k2["bound_ms"] == pytest.approx(1.259, rel=1e-3)
    k3 = cs.dense_bound(
        torch.empty((2_000_000, 320), dtype=torch.int8, **meta),
        torch.empty((1024, 320), dtype=torch.int8, **meta),
    )
    assert k3["bound_resource"] == "tensor cores (int8)"
    assert k3["bound_ms"] == pytest.approx(0.662, rel=1e-3)

    def k1(n, m, dsub, winners):
        return cs.k1_bound((
            torch.empty((m, n), dtype=torch.int8, **meta),
            torch.empty((2, n), dtype=torch.bfloat16, **meta),
            torch.empty((1024, adc.padded_depth(m, dsub)), dtype=torch.bfloat16, **meta),
            torch.empty((m, 256, dsub), dtype=torch.bfloat16, **meta),
        ), winners)

    glove = k1(400_000, 8, 13, 1)
    assert glove["bound_resource"] == "tensor cores (bf16)"
    assert glove["bound_ms"] == pytest.approx(0.0895, rel=1e-2)
    ivf = k1(1_057_152, 12, 8, 4)
    assert ivf["bound_ms"] == pytest.approx(0.219, rel=1e-2)
    # 11 selection operations a pair at 4 winners: below the tensor cores
    assert ivf["bound_parts_ms"]["CUDA cores (selection)"] == pytest.approx(
        1_057_152 * 1024 * 11 / 67e12 * 1e3
    )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels K1, K2 and K3 run only on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("case", cs.K1_EDGE_CASES, ids=_k1_id)
def test_k1_edge_on_the_card(cuda_device, case):
    winners = case[5]
    operands, nblk, real = _k1(case, cuda_device)
    before = tracing.counter("k1.launches")
    got = adc.fused_block_scan(*operands, winners=winners, nblk=nblk)
    torch.cuda.synchronize()
    assert tracing.counter("k1.launches") == before + 1
    ref = adc._block_scan_plain(*operands, winners=winners, nblk=nblk)
    result = cs.compare_packed(got, ref)
    assert result["ok"], result
    if real is not None:
        assert cs.winners_valid(got, real, winners, nblk)
        assert cs.winners_valid(ref, real, winners, nblk)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cs.K3_EDGE_CASES, ids=_k3_id)
def test_k3_edge_on_the_card(cuda_device, case):
    data, q_op = _k3(case, cuda_device)
    before = tracing.counter("k3.launches")
    got = dense.dense_block_scan_i8(data, q_op)
    torch.cuda.synchronize()
    assert tracing.counter("k3.launches") == before + 1
    assert torch.equal(got, dense._dense_block_scan_plain_i8(data, q_op))


@pytest.mark.cuda
@pytest.mark.parametrize("case", cs.K2_EDGE_CASES, ids=_k2_id)
def test_k2_edge_on_the_card(cuda_device, case):
    data, q_op = _k2(case, cuda_device)
    before = tracing.counter("k2.launches")
    got = dense.dense_block_scan(data, q_op)
    torch.cuda.synchronize()
    assert tracing.counter("k2.launches") == before + 1
    ref = dense._dense_block_scan_plain(data, q_op)
    result = cs.compare_packed(got, ref, cs.dense_scale(data, q_op, ref))
    assert result["ok"], result


@pytest.mark.cuda
def test_rescore_exact_past_the_last_row_on_the_card(cuda_device):
    """``rescore_exact`` of candidates past the last row, which a NaN query
    row's positions in a padded last tile can be: gathered clamped on the
    card as on the CPU (whose result ``test_torch_flat.py`` holds to the
    JAX package), where an unclamped gather would end the CUDA context."""
    from gulon_tpu_torch.ops import scan

    gen = torch.Generator().manual_seed(5)
    n, m, k_codes, dsub = 300, 4, 16, 6
    cb = torch.randn(m, k_codes, dsub, generator=gen)
    codes = torch.randint(0, k_codes, (n, m), generator=gen, dtype=torch.int32).to(torch.uint8)
    norms = torch.rand(n, generator=gen)
    q = torch.randn(2, m * dsub, generator=gen)
    q[1, 3] = float("nan")
    cand = torch.tensor([[0, 7, n - 1, n, n + 9, 2 * n], [-1, 3, n + 1, n - 1, 5, 9]],
                        dtype=torch.int32)
    bounds = [(s * dsub, dsub) for s in range(m)]
    args = (q, cb, codes, norms, cand)
    d_cpu, i_cpu = scan.rescore_exact(*args, bounds=bounds, k=4)
    d_gpu, i_gpu = scan.rescore_exact(*(a.to(cuda_device) for a in args), bounds=bounds, k=4)
    torch.cuda.synchronize()
    assert torch.equal(i_gpu.cpu(), i_cpu) and bool((i_cpu[0] >= n).any())
    torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=1e-4, atol=1e-4, equal_nan=True)
