"""K1's subspace width: the ``width`` of K1's launch plan
(``ops/cuda/adc.py::k1_plan``, ``make_plan`` in ``csrc/adc_scan.cu``).

Where K1 streams a row block (decodes it a chunk at a time for each query
tile, gathering its codewords as it goes) and a subspace is not a whole
number of 16-byte gathers, ``K1Operands`` lays the codebook and query
operands out at the subspace width rounded up to 8 lanes, if that
adds no 64-lane chunk to the depth: gist-960's 39-lane subspaces at 40.
The extra lanes are zeros facing zeros, so K1 computes the same scores
but for the order of its f32 sums, and the launch geometry (``t``, the
winner columns, ``base_cols``) follows the own width.

The rule is the built kernel's, so it is read on the card (tests marked
``cuda``; here and in ``tests/test_torch_gist960.py``). On the CPU there
is no plan to read and the operands keep their width; these tests give
the operands the width the card's plan gives and hold them to the
unpadded ones through K1's plain twin, at gist's bounds and at other
shapes."""

import contextlib

import pytest
import torch

import chip_smoke as cs
from gulon_tpu_torch.ops.cuda import adc
from gulon_tpu_torch.ops.distance import sq_norms
from gulon_tpu_torch.ops.pq import subspace_bounds
from gulon_tpu_torch.utils import tracing

D, M, K, ROWS, NQ = 960, 25, 256, 8192, 64
BOUNDS = [(39 * s, 39) for s in range(10)] + [(390 + 38 * s, 38) for s in range(15)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rule is K1's plan, read from the built kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k_codes,dsub,width", [
    (25, 256, 39, 40),  # gist-960, streamed: depth 979 -> 1,004, 16 chunks at both
    (20, 256, 39, 40),  # streamed: 784 -> 804 lanes, 13 chunks at both
    (20, 256, 37, 37),  # streamed: 744 -> 804 lanes, 12 chunks to 13
    (2, 256, 375, 376),  # streamed: 754 -> 756 lanes, 12 chunks at both
    (25, 256, 4, 4),  # glove100, held decoded: a column table, no gathers to widen
    (25, 256, 6, 6),  # sift128's residual subspaces (3 of 6, 22 of 5), held
    (96, 256, 8, 8),  # deep768, streamed: 8 lanes a gather already
    (25, 256, 12, 12),  # crawl2m-like, held
    (250, 16, 4, 4),  # streamed, 4 lanes a gather: 1,004 -> 2,004 lanes
    (720, 16, 1, 1),  # streamed, 1 lane a gather: 724 -> 5,764 lanes
    (90, 64, 10, 10),  # streamed, 2 lanes a gather: 904 -> 1,444 lanes
], ids=lambda v: str(v))
def test_the_width_rule(card, m, k_codes, dsub, width):
    """The plan's ``width`` at an index's own shape, and at that width the
    plan gathers 8 lanes wherever it widened."""
    plan = adc.k1_plan(m, k_codes, dsub)
    assert plan["width"] == width
    if width != dsub:
        wide = adc.k1_plan(m, k_codes, width)
        assert (plan["streamed"], wide["streamed"], wide["lanes"], wide["width"]) == (
            1, 1, 8, width)


def test_the_rule_reads_the_plan_on_the_card_only(monkeypatch):
    """On a CUDA device the width is the ``width`` of K1's plan at the
    index's own shape; elsewhere the plain twin, which gathers nothing,
    keeps the own width."""
    cb = torch.zeros((M, K, 39))
    plans = {40: dict(streamed=1, cb_smem=0, stages=5, lanes=1, smem=214_096, width=40,
                      qtile=256),
             39: dict(streamed=0, cb_smem=1, stages=6, lanes=1, smem=200_000, width=39,
                      qtile=128)}
    for width, plan in plans.items():
        monkeypatch.setattr(adc, "k1_plan", lambda m, k, d, p=plan: p)
        assert adc._k1_lane_width(cb, "cuda") == width
        assert adc._k1_lane_width(cb, "cpu") == 39


@pytest.fixture(scope="module")
def raw():
    assert [tuple(b) for b in subspace_bounds(D, M)] == BOUNDS
    return cs.k1_inputs(torch.Generator().manual_seed(960), ROWS, D, M, K, NQ, dev="cpu")


@contextlib.contextmanager
def _width_rule(streamed: bool, width: int = 40):
    """``width``, the width the card's plan gives gist's shape, in place
    of the CPU's own (``streamed``), or the CPU's as it is."""
    with pytest.MonkeyPatch.context() as mp:
        if streamed:
            mp.setattr(adc, "_k1_lane_width", lambda cb, dev: width)
        yield


def _k1(raw, streamed: bool, centered: bool, width: int = 40):
    """K1's operands over an index's rows, at ``width`` (``streamed``) or
    the CPU's own."""
    with _width_rule(streamed, width):
        return adc.K1Operands(
            raw["codebooks"], adc.pack_codes_t(raw["codes"], raw["codebooks"].shape[1]),
            raw["recon_norms"], bounds=raw["bounds"], num_rows=raw["codes"].shape[0],
            center_scores=centered,
        )


def _entry(raw, streamed: bool, winners: int, centered: bool, width: int = 40):
    """The operands and the launch geometry ``(k1, t, base_cols)`` of a
    batch of ``raw``'s queries."""
    k1 = _k1(raw, streamed, centered, width)
    return (k1, *k1.geometry(raw["queries"].shape[0], winners=winners))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


CASES = [(1, True), (4, False)]
IDS = ["w1-centered", "w4-uncentered"]


@pytest.mark.parametrize("winners,centered", CASES, ids=IDS)
def test_the_geometry_follows_the_own_width(raw, winners, centered):
    own, t_own, base_own = _entry(raw, False, winners, centered)
    wide, t_wide, base_wide = _entry(raw, True, winners, centered)
    assert (own.lane_padded, wide.lane_padded) == (False, True)
    assert (tuple(own.cb.shape), tuple(wide.cb.shape)) == ((M, K, 39), (M, K, 40))
    assert t_own == t_wide  # and so nblk
    assert torch.equal(base_own, base_wide)
    for name in ("codes_t", "norms_hl", "center"):
        assert torch.equal(getattr(own, name), getattr(wide, name)), name


@pytest.mark.parametrize("winners,centered", CASES, ids=IDS)
def test_the_padded_lanes_are_zeros_facing_zeros(raw, winners, centered):
    """The codebooks' 40th lane is +0.0 and faces a query lane of zero in
    every subspace (and the 39th in the 38-lane ones, zero in both
    operands already); every other lane equals the unpadded operands', bit
    for bit."""
    own = _k1(raw, False, centered)
    wide = _k1(raw, True, centered)
    q = raw["queries"]
    q_own, q_wide = own.query_operand(q), wide.query_operand(q)
    assert q_wide.shape[1] == adc.padded_depth(M, 40) == 1008
    assert torch.equal(_bits(wide.cb[:, :, :39]), _bits(own.cb))
    assert torch.equal(_bits(wide.cb[:, :, 39]), torch.zeros((M, K), dtype=torch.int16))
    lanes_own = q_own[:, : M * 39].reshape(NQ, M, 39)
    lanes_wide = q_wide[:, : M * 40].reshape(NQ, M, 40)
    assert torch.equal(_bits(lanes_wide[:, :, :39]), _bits(lanes_own))
    assert bool((lanes_wide[:, :, 39] == 0).all())
    for s, (_, w) in enumerate(BOUNDS):
        assert bool((wide.cb[s, :, w:] == 0).all()) and bool((lanes_wide[:, s, w:] == 0).all())
    # the norm, ones and center lanes, then the depth's zero padding
    assert torch.equal(_bits(q_wide[:, M * 40:M * 40 + 4]), _bits(q_own[:, M * 39:M * 39 + 4]))
    assert bool((q_wide[:, M * 40 + 4:] == 0).all())


@pytest.mark.parametrize("winners,centered", CASES, ids=IDS)
def test_k1_twin_gives_the_same_winners_at_both_widths(raw, winners, centered):
    """K1's plain twin on the operands at 40 lanes against 39: the same
    winner rows but at near-ties within ``2^-14 max(|v|, S)``, ``S`` the
    size of the terms a score sums (``||q||^2`` and the mean norm), and
    every value within the same bound."""
    results = []
    for streamed in (False, True):
        operands, nblk = _k1(raw, streamed, centered).operands(raw["queries"], winners=winners)
        results.append(adc._block_scan_plain(*operands, winners=winners, nblk=nblk))
    ref, got = results
    scale = sq_norms(raw["queries"]) + adc._center(raw["recon_norms"], True)
    result = cs.compare_packed(got, ref, scale[:, None].expand_as(got))
    assert result["ok"], result


@pytest.mark.parametrize("winners,centered", CASES, ids=IDS)
def test_the_scan_answers_alike_at_both_widths(raw, winners, centered):
    """``scan_top_k`` over an index's held operands, top-10 by the
    epilogue: the same ids but at near-ties, distances within the bound."""
    results = []
    for streamed in (False, True):
        k1 = _k1(raw, streamed, centered)
        results.append(adc.scan_top_k(k1, raw["queries"], k=10, winners=winners))
        assert k1.lane_padded is streamed
    (d_own, i_own), (d_wide, i_wide) = results
    scale = sq_norms(raw["queries"])[:, None] + adc._center(raw["recon_norms"], True)
    tol = 2.0 ** -14 * torch.maximum(d_own.abs(), scale)
    assert bool(((d_wide - d_own).abs() <= tol).all())  # an id that differs is a near-tie
    assert float((i_wide == i_own).float().mean()) >= 0.99


# (D, m, K, width, winners, centered): other shapes at a width their plan
# may give (dsub rounded up to 8) or at one wider still, and one at its own
WIDER = [
    (100, 25, 256, 8, 1, True),  # dsub 4
    (128, 25, 256, 8, 4, False),  # sift128's 6 and 5
    (24, 4, 16, 8, 1, True),  # 6
    (300, 25, 256, 16, 1, True),  # 12 (and 11)
    (60, 6, 64, 16, 3, False),  # 10
    (900, 90, 64, 16, 3, True),  # 10, two lanes a gather at its own width
    (780, 20, 256, 40, 4, False),  # 39, streamed at 40
    (750, 2, 256, 376, 2, False),  # 375
    (720, 720, 16, 8, 1, True),  # 1
    (1000, 250, 16, 8, 2, False),  # 4
    (768, 96, 256, 8, 1, True),  # 8: its own width, nothing padded
]


@pytest.mark.parametrize("d,m,k_codes,width,winners,centered", WIDER,
                         ids=lambda v: str(v))
def test_operands_at_a_wider_width_score_alike(d, m, k_codes, width, winners, centered):
    """At any width past the own one, the padded lanes are zeros facing
    zeros in both operands, the launch geometry is the own width's, and
    K1's plain twin gives the same winners but at near-ties within
    ``2^-14 max(|v|, S)`` and every value within it."""
    raw = cs.k1_inputs(torch.Generator().manual_seed(d + m), 2048, d, m, k_codes, 33,
                       dev="cpu")
    own, t_own, base_own = _entry(raw, False, winners, centered)
    wide, t_wide, base_wide = _entry(raw, True, winners, centered, width)
    dsub = own.cb.shape[2]
    assert wide.lane_padded is (width > dsub) and not own.lane_padded
    assert tuple(wide.cb.shape) == (m, k_codes, width)
    assert t_own == t_wide and torch.equal(base_own, base_wide)
    assert torch.equal(_bits(wide.cb[:, :, :dsub]), _bits(own.cb))
    assert bool((wide.cb[:, :, dsub:] == 0).all())
    q_wide = wide.query_operand(raw["queries"])
    assert q_wide.shape[1] == adc.padded_depth(m, width)
    lanes = q_wide[:, : m * width].reshape(-1, m, width)
    for s, (_, w) in enumerate(raw["bounds"]):
        assert bool((wide.cb[s, :, w:] == 0).all()) and bool((lanes[:, s, w:] == 0).all())
    results = []
    for k1 in (own, wide):
        operands, nblk = k1.operands(raw["queries"], winners=winners)
        results.append(adc._block_scan_plain(*operands, winners=winners, nblk=nblk))
    ref, got = results
    scale = sq_norms(raw["queries"]) + adc._center(raw["recon_norms"], True)
    result = cs.compare_packed(got, ref, scale[:, None].expand_as(got))
    assert result["ok"], result


K1_LANE_COUNTERS = ("k1.launches", "k1.launches.lane_padded", "k1.gather_lanes")


@pytest.mark.parametrize("plan,streamed,expect", [
    (dict(streamed=1, cb_smem=0, lanes=8, qtile=256), True, (1, 1, 8)),  # gist-960 at 40 lanes
    (dict(streamed=1, cb_smem=0, lanes=1, qtile=256), False, (1, 0, 1)),  # an odd width as it is
    (dict(streamed=0, cb_smem=1, lanes=1, qtile=128), False, (1, 0, 1)),  # held decoded
], ids=["streamed-padded", "streamed-own-width", "held"])
def test_a_k1_launch_counts_its_padded_lanes(raw, monkeypatch, plan, streamed, expect):
    """The owner counts each launch on the card in
    ``k1.launches.lane_padded``, 1 where its operands are wider than the
    subspaces, beside the launch's own counts (the card's launch stood in
    for by one counted by ``plan`` that returns the plain twin's winners);
    its plain twin counts nothing."""
    k1 = _k1(raw, streamed, True)
    k1.geometry(NQ)

    def launch(*operands, winners, nblk):
        adc.count_launch(plan, operands[0].shape[1], operands[2].shape[0])
        return adc._block_scan_plain(*operands, winners=winners, nblk=nblk)

    before = {c: tracing.counter(c) for c in K1_LANE_COUNTERS}
    k1.scan(raw["queries"])  # the plain twin on the CPU
    assert all(tracing.counter(c) == before[c] for c in K1_LANE_COUNTERS)
    monkeypatch.setattr(adc, "fused_block_scan", launch)
    k1.device = torch.device("cuda")  # the operands stay on the CPU: no launch reads them
    k1.scan(raw["queries"])
    assert tuple(tracing.counter(c) - before[c] for c in K1_LANE_COUNTERS) == expect
    assert "k1.launches.lane_padded" in tracing.snapshot()["counters"]
