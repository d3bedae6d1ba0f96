"""The probe kernels P1-P4 on the card, each against its plain version at
edge shapes: ragged row counts (padding rows past n), 1 to 1000 queries,
K = 16, 256 and 1024, depths from 24 to 768 (held decoded and streamed),
NaN rows and padding-only blocks.

P1 and P2 hold K1's rule (``chip_smoke.compare_packed``: ids >= 99.5 %
equal, values within ``2^-14 * max(|v|, 1)``, NaN winners on the same rows),
held decoded and streamed, 1-4 winners, on a grid of fewer blocks than
the card has SMs, and their decoded rows equal the plain gather bit for
bit but for the sign of a zero (``probe_decode_rows`` at K 16 to 1024,
dsub 8 to 86, code bytes 1, 2 and 4, a -0.0 codeword, invalid codes; the
one-hot also bit for bit against its register-map emulation); P3 holds its
variant's plain version (``chip_smoke._p3_check``: zeros exactly, values
within ``2^-14 * max(|v|, 1)``, ids >= 99.5 % equal, every mismatch a
near-tie); P4 writes zeros; K1 cut by stage (``k1_stages``) holds its
plain version (``chip_smoke._k1_stage_check``: zeros exactly, NaN in the
same places, values within ``2^-14 * max(|v|, 1)``). ``probes.median_ms``
times a kernel on the card and refuses a function that synchronizes.
Marked ``cuda``: they skip without a card.
Run on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_probes_cuda.py`` (this file imports no jax).
"""

import pytest
import torch

import chip_smoke as cs
from gulon_tpu_torch.ops.cuda import adc
from gulon_tpu_torch.probes import adc_probes as ap
from gulon_tpu_torch.probes import floor_probe as fp
from gulon_tpu_torch.probes import k1_stages as ks
from gulon_tpu_torch.probes import kernel_probe as kp
from gulon_tpu_torch.utils import tracing

# (n, D, m, K, queries, winners, centered, extra) as chip_smoke.K1_EDGE_CASES
P1_CASES = (
    (8192, 24, 4, 16, 1, 1, True, None),
    (9000, 24, 4, 16, 7, 2, False, None),
    (16384, 100, 8, 256, 1000, 1, True, None),
    (16384, 100, 8, 256, 129, 4, False, "nan"),
    (9216, 60, 6, 256, 200, 3, True, "sentinel"),
    (16384, 300, 19, 256, 129, 2, True, None),
    (16384, 96, 12, 1024, 100, 2, True, None),
    (8192, 768, 96, 256, 33, 1, False, None),
    (8192, 768, 96, 256, 200, 3, True, None),
    (16384, 96, 12, 256, 40, 2, True, "infq"),
    (2560, 100, 8, 256, 300, 2, True, None),  # 20 blocks: fewer than the card's SMs
)


def _p1_id(case):
    n, d, m, k_codes, q_n, w, centered, extra = case
    return f"n{n}-d{d}-K{k_codes}-q{q_n}-w{w}-{'c' if centered else 'u'}-{extra}"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe kernels run only on the card")
    return "cuda"


def _modes(k_codes, piped):
    modes = [m for m in ap.DECODE_MODES if k_codes <= 256 or m == "base"]
    return [(m, False) for m in modes] + ([] if piped else [(m, True) for m in modes])


@pytest.mark.cuda
@pytest.mark.parametrize("pipe", [False, True], ids=["P1", "P2"])
@pytest.mark.parametrize("case", P1_CASES, ids=_p1_id)
def test_adc_probe_on_the_card(cuda_device, case, pipe):
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    operands, nblk, real = cs.k1_operands(gen, *case, dev=cuda_device)
    winners = case[5]
    ref = adc._block_scan_plain(*operands, winners=winners, nblk=nblk)
    for mode, natural in _modes(case[3], pipe):
        counter = "probe.p2.launches" if pipe else "probe.p1.launches"
        before = tracing.counter(counter)
        got = ap.probe_block_scan(*operands, winners=winners, nblk=nblk, decode_mode=mode,
                                  natural=natural, pipe=pipe)
        torch.cuda.synchronize()
        assert tracing.counter(counter) == before + 1
        check = cs.compare_packed(got, ref)
        assert check["ok"], (mode, natural, check)
        if real is not None:
            assert cs.winners_valid(got, real, winners, nblk), (mode, natural)
        if not pipe:
            rows = ap.probe_decode_rows(operands[0], operands[1], operands[3],
                                        width=operands[2].shape[1], decode_mode=mode)
            plain = ap._decode_rows_plain(operands[0], operands[1], operands[3],
                                          operands[2].shape[1])
            assert cs.rows_equal_but_zero_sign(rows, plain), mode


# (n, D, m, K, code bytes): dsub 13, 8, 33 (two pieces) and 86 (three); K
# 16 to 1024; int8, int16 and int32 codes
DECODE_CASES = (
    (1024, 52, 4, 16, 1), (2048, 64, 8, 64, 1), (4096, 104, 8, 256, 1),
    (2048, 96, 12, 256, 2), (1024, 66, 2, 1024, 2), (1024, 172, 2, 64, 4),
    (2048, 768, 96, 256, 1),
)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"n{c[0]}-d{c[1]}-K{c[3]}-b{c[4]}")
def test_decoded_rows_exact_on_the_card(cuda_device, case):
    """Every decode mode writes the plain gather's rows, bit for bit but for
    the sign of a zero, with a -0.0 codeword, codes outside [0, K) and
    padding rows (+0); the one-hot equals its register-map emulation."""
    n, d, m, k_codes, code_bytes = case
    gen = torch.Generator(device=cuda_device).manual_seed(n + k_codes)
    dsub = d // m
    cb = torch.randn((m, k_codes, dsub), generator=gen, device=cuda_device).to(torch.bfloat16)
    cb[0, 5, 2] = -0.0
    codes = torch.randint(0, k_codes, (m, n), generator=gen, device=cuda_device)
    codes[0, :7] = 5
    if code_bytes == 1:
        codes_t = (codes - 128).to(torch.int8)
        if k_codes < 256:
            codes_t[1, 7:11] = 127  # code 255: no code at this K
    else:
        codes_t = codes.to(torch.int16 if code_bytes == 2 else torch.int32)
        codes_t[1, 7:11] = -1
        codes_t[0, 11] = k_codes
    norms = torch.randn((2, n), generator=gen, device=cuda_device).to(torch.bfloat16)
    width = -(-(m * dsub + 4) // 8) * 8
    plain = ap._decode_rows_plain(codes_t, norms, cb, width)
    for mode in ap.DECODE_MODES:
        if mode == "bf16cmp" and k_codes > 256:
            continue
        before = tracing.counter("probe.decode.launches")
        rows = ap.probe_decode_rows(codes_t, norms, cb, width=width, decode_mode=mode)
        torch.cuda.synchronize()
        assert tracing.counter("probe.decode.launches") == before + 1
        assert cs.rows_equal_but_zero_sign(rows, plain), mode
        if mode != "take" and n <= 2048 and m <= 12:
            emu = ap.onehot_decode_rows_plain(codes_t.cpu(), norms.cpu(), cb.cpu(), width=width,
                                              decode_mode=mode)
            assert torch.equal(rows.cpu().view(torch.int16), emu.view(torch.int16)), mode


@pytest.mark.cuda
def test_adc_scan_probe_entry_point_on_the_card(cuda_device):
    """The entry point on its default device: the card; top-k as K1's."""
    from gulon_tpu_torch.ops.cuda.adc import adc_scan_fused

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    raw = cs.k1_inputs(gen, 20000, 100, 8, 256, 64, dev=cuda_device)
    d_k, i_k = adc_scan_fused(**raw, k=10)
    for mode, natural, pipe in (("take", False, False), ("base", False, True)):
        resolved = {}
        d_p, i_p = ap.adc_scan_probe(**raw, k=10, center_scores=True, decode_mode=mode,
                                     natural=natural, pipe=pipe, resolved=resolved)
        assert d_p.device.type == "cuda" and resolved["decode_mode"] == mode
        assert float((i_p == i_k).float().mean()) >= 0.99
        torch.testing.assert_close(d_p, d_k, rtol=1e-4, atol=1e-4)


# (n, m, K, dsub, mdp, queries, t): ragged n, 1 to 1000 queries, K 16 to
# 1024, one and two one-hot pieces of 16 lanes (dsub 8 to 32), an odd count
# of 128-row blocks (the last pair of blocks one short), fewer pairs of
# blocks than the card has SMs
P3_SHAPES = (
    (5000, 8, 256, 13, 128, 1000, 2048),
    (3000, 4, 16, 8, 32, 1, 1024),
    (20000, 12, 64, 8, 104, 129, 4096),
    (3000, 8, 256, 13, 104, 129, 1152),  # 27 blocks
    (2560, 8, 256, 13, 128, 300, 1280),  # 20 blocks: 10 pairs
    (6000, 4, 256, 24, 96, 200, 2048),  # two pieces
    (4096, 3, 64, 32, 96, 64, 1024),  # two pieces
    (4096, 4, 1024, 13, 56, 100, 1024),  # K 1024: the int and nib recipes
)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", P3_SHAPES,
                         ids=lambda s: f"n{s[0]}-K{s[2]}-d{s[3]}-q{s[5]}-t{s[6]}")
def test_kernel_probe_on_the_card(cuda_device, shape):
    ops = kp.probe_operands(*shape, device=cuda_device)
    t = shape[-1]
    dec = kp.decoded_rows(ops[0], ops[3], shape[4])
    for variant in kp.VARIANTS:
        if shape[2] > 256 and kp.spec(variant)[1] in ("cmp8", "i8"):
            continue  # those recipes take K <= 256
        before = tracing.counter("probe.p3.launches")
        got = kp.kernel_probe(variant, *ops, tile_rows=t, query_tile=512)
        torch.cuda.synchronize()
        assert tracing.counter("probe.p3.launches") == before + 1
        ref = kp.plain(variant, *ops, tile_rows=t, query_tile=512)
        i8 = kp.quantize_codebooks(ops[3]) if variant == "tdec_i8" else None
        vdec = dec if i8 is None else kp.decoded_rows(ops[0], ops[3], shape[4], i8)
        check = cs._p3_check(variant, got, ref, vdec, ops[1], ops[2])
        assert check["ok"], (variant, check)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 401_408])
def test_floor_probe_on_the_card(cuda_device, n):
    codes, q = fp.floor_operands(n=n, device=cuda_device)
    for variant in fp.VARIANTS:
        got = fp.floor_probe(variant, codes, q)
        torch.cuda.synchronize()
        ref = fp.plain(variant, codes, q)
        assert len(got) == len(ref)
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), variant


@pytest.mark.cuda
@pytest.mark.parametrize("case", P1_CASES, ids=_p1_id)
def test_k1_stages_on_the_card(cuda_device, case):
    """Each cut of K1 at P1's edge shapes (held decoded and streamed,
    K = 16 to 1024, NaN rows, padding rows), one winner a block."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    operands, nblk, _ = cs.k1_operands(gen, *case, dev=cuda_device)
    for stage in ks.STAGES:
        before = tracing.counter("probe.k1_stages.launches")
        got = ks.k1_stage_scan(*operands, stage=stage, nblk=nblk)
        torch.cuda.synchronize()
        assert tracing.counter("probe.k1_stages.launches") == before + 1
        check = cs._k1_stage_check(stage, got, ks.plain(*operands, stage=stage, nblk=nblk))
        assert check["ok"], (stage, check)


@pytest.mark.cuda
def test_median_ms_times_the_card(cuda_device):
    """Queued readings of a kernel are positive and below one call's host
    round trip; a function that synchronizes is refused."""
    from gulon_tpu_torch.probes import median_ms

    x = torch.ones((1024, 1024), device=cuda_device)
    ms = median_ms(lambda: x.add_(1.0))
    assert 0.0 < ms < 0.05
    with pytest.raises(RuntimeError, match="synchronizes"):
        median_ms(lambda: x.sum().item(), warmup=1, reps=1)
