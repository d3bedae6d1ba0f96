"""The yardstick: roofline arithmetic, cutoff recall, the check's numbers."""

import numpy as np
import pytest
import torch

import h100bench_tiny  # noqa: F401 - puts the repository on the path
from h100bench import check, roofline
from h100bench.reference import exact
from h100bench.reference import pq as rpq
from h100bench.reference.recall import cutoff_hits

H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def test_roofline_bound_on_the_perf_glove100_shape():
    # PERF.md's K1 table: 1024 queries, 401,408 rows. By hand:
    # 2 * 1024 * 401408 * 104 = 85,496,692,736 FLOP / 989e12 = 0.086448 ms;
    # at 108 lanes (PERF's 0.0898): 88,785,027,072 / 989e12 = 0.089773 ms
    for lanes, ms in ((104, 0.0864476), (108, 0.0897725)):
        flop, nbytes = roofline.adc_scan_work(
            1024, 401408, lanes, distinct_rows=401408, code_bytes_per_row=8, k=10)
        least, which = roofline.least_seconds(flop, nbytes, H100)
        assert which == "bf16 tensor cores"
        assert least * 1e3 == pytest.approx(ms, rel=1e-6)
    # the bytes: 401,408 x 8 codes + 1024 x 104 x 2 queries + 1024 x 10 x 8 winners
    assert nbytes == 401408 * 8 + 1024 * 108 * 2 + 1024 * 80


def test_roofline_of_the_ivf_cell_counts_probed_rows_only():
    flop, nbytes = roofline.adc_scan_work(
        1024, 50 * 1000, 128, distinct_rows=1_000_000, code_bytes_per_row=25, k=10)
    assert flop == 2 * 1024 * 50_000 * 128
    least, which = roofline.least_seconds(flop, nbytes, H100)
    assert which == "bf16 tensor cores" and least == pytest.approx(flop / 989e12)


def test_cutoff_recall_by_hand():
    # true 2nd-nearest distances 1.0 and 4.0; k = 2
    kth = torch.tensor([1.0, 4.0])
    returned = torch.tensor([[0.5, 1.0], [4.0, 4.5]])
    valid = torch.tensor([[True, True], [True, True]])
    assert cutoff_hits(returned, valid, kth, 0.0).tolist() == [2, 1]
    # slack: (sqrt(4) * 1.1)^2 = 4.84 takes 4.5 in
    assert cutoff_hits(returned, valid, kth, 0.1).tolist() == [2, 2]
    # a tie at the cutoff is a hit; a missing answer is not
    valid = torch.tensor([[True, False], [True, True]])
    assert cutoff_hits(returned, valid, kth, 0.0).tolist() == [1, 1]


def test_subspace_split_is_the_references():
    assert rpq.subspace_bounds(128, 25)[:4] == [(0, 6), (6, 6), (12, 6), (18, 5)]
    assert sum(w for _, w in rpq.subspace_bounds(128, 25)) == 128
    assert rpq.subspace_bounds(100, 25) == [(4 * i, 4) for i in range(25)]


def test_precision_grids():
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -9, 3.0])
    assert rpq.rounded(x, "tf32").tolist() == [1.0, 1.0 + 2.0 ** -9, 3.0]
    assert rpq.rounded(x, "bf16").tolist() == [1.0, 1.0, 3.0]
    assert rpq.rounded(torch.tensor([1.05, 1.07]), "fp8").tolist() == [1.0, 1.125]


def _flat_state(seed=0, n=512, d=8, m=4, k=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g, dtype=torch.float64)
    bounds = rpq.subspace_bounds(d, m)
    cb = rpq.kmeans(rpq.split(x, bounds, 2), k, 50, 0, precision="f64", storage="f32").double()
    codes = rpq.assign(rpq.split(x, bounds, 2), cb, "f64").T.contiguous()
    xr = rpq.decode(cb, codes, bounds)
    state = check.IndexState("flat", bounds, cb.float(), codes, norms=(xr * xr).sum(-1).float())
    return x, state, xr


def test_check_numbers_of_a_sound_index_and_its_exact_answers():
    x, state, xr = _flat_state()
    q = x[:16] + 0.01
    d, rows = exact.topk_smallest(q, xr, 10)
    ans = check.Answers(np.arange(16), d.numpy(), rows.numpy())
    nums = check.numbers(["dist_err", "adc_miss", "code_gap", "lloyd_gain", "norm_err"],
                         state, x, torch.cat([q, x[16:32]]), ans)
    assert nums["dist_err"] < 1e-12 and nums["adc_miss"] == 0.0
    assert nums["code_gap"] == 0.0 and nums["lloyd_gain"] < 1e-3 and nums["norm_err"] < 1e-6


def test_check_numbers_see_each_fault():
    x, state, xr = _flat_state()
    q = x[:16] + 0.01
    d, rows = exact.topk_smallest(q, xr, 10)
    base = ["dist_err", "adc_miss"]
    altered = rows.numpy().copy()
    altered[3, 0] = (altered[3, 0] + 7) % 512  # one answer altered
    nums = check.numbers(base, state, x, q, check.Answers(np.arange(16), d.numpy(), altered))
    assert nums["dist_err"] > 1e-3
    shifted = check.Answers(np.arange(16), d[:, :].numpy(), rows.numpy())
    shifted.query_rows = np.roll(shifted.query_rows, 1)  # answers of other queries
    assert check.numbers(base, state, x, q, shifted)["dist_err"] > 1e-3
    bad = dataclasses_replace(state, codes=torch.roll(state.codes, 1, dims=0))
    assert check.numbers(["code_gap"], bad, x)["code_gap"] > 1e-3
    init = dataclasses_replace(state, codebooks=rpq.split(x[:8], state.bounds, 2).float())
    assert check.numbers(["lloyd_gain"], init, x)["lloyd_gain"] > 0.05


def dataclasses_replace(state, **kw):
    import dataclasses

    return dataclasses.replace(state, **kw)


def test_idle_gaps_go_to_the_innermost_open_span():
    from h100bench.trace import idle_gaps, union_seconds

    busy, merged = union_seconds([(10, 20), (15, 30), (60, 70)])
    assert busy == 30e-9 and merged == [(10, 30), (60, 70)]
    # a long outer span with many short inner events before the gap
    cpu = [(0, 100, "outer")] + [(i, i + 1, "op") for i in range(30, 40)] + [(40, 55, "inner")]
    gaps = dict(idle_gaps(merged, cpu, 0, 100))
    # gaps: 0-10 (mid 5: outer), 30-60 (mid 45: inner), 70-100 (mid 85: outer)
    assert gaps == {"outer": 40e-9, "inner": 30e-9}
    assert dict(idle_gaps(merged, [], 0, 100)) == {"host outside any span": 70e-9}


def test_check_numbers_of_an_exact_index_read_the_data_not_the_stored_rows():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(512, 8, generator=g, dtype=torch.float64)
    q = x[:16] + 0.01
    d, rows = exact.topk_smallest(q, x, 10)
    ans = check.Answers(np.arange(16), d.numpy(), rows.numpy())
    names = ["dist_err", "adc_miss", "row_err"]
    sound = check.IndexState("exact", vectors=x.float())
    nums = check.numbers(names, sound, x, q, ans)
    assert nums["dist_err"] < 1e-12 and nums["adc_miss"] == 0.0 and nums["row_err"] < 1e-7
    # rows stored on the bf16 grid, answers consistent with them: the data sees it
    xb = rpq.rounded(x, "bf16")
    db, rb = exact.topk_smallest(q, xb.double(), 10)
    low = check.numbers(names, check.IndexState("exact", vectors=xb), x, q,
                        check.Answers(np.arange(16), db.numpy(), rb.numpy()))
    assert low["dist_err"] > 1e-4 and low["row_err"] > 1e-4
    for name in ("code_gap", "lloyd_gain", "norm_err"):
        with pytest.raises(ValueError, match="PQ codes"):
            check.numbers([name], sound, x)


def test_dense_roofline_reads_the_work_adc_scan_work_gives():
    from types import SimpleNamespace

    from h100bench.spec import Spec

    read = Spec(h100bench_tiny.REPO).metric_reader("dense_roofline")
    config = {"dataset": {"n": 1_000_000, "d": 960}}
    traffic = {"batch": 1024, "k": 10}
    # two batches: K2 3 ms each, beside K1 and a sort that do not count
    kernels = [("void dense_kernel<Bf16Op>(CUtensorMap, CUtensorMap)", 0, 3_000_000),
               ("void dense_kernel<Bf16Op>(CUtensorMap, CUtensorMap)", 4_000_000, 7_000_000),
               ("void adc_scan_kernel<false, 3, 128>", 7_000_000, 9_000_000),
               ("DeviceSegmentedRadixSortKernel", 9_000_000, 9_500_000)]

    def ctx(kernels, peaks=H100):
        return SimpleNamespace(view=SimpleNamespace(kernels=kernels, units=2), config=config,
                               traffic=traffic, peaks=peaks)

    flop, nbytes = roofline.adc_scan_work(
        1024, 1_000_000, 960, distinct_rows=1_000_000, code_bytes_per_row=1920, k=10)
    # by hand: 2 x 1024 x 10^6 x 960 = 1.96608e12 FLOP, 1.988 ms at 989 TFLOP/s;
    # 1.92e9 + 1,966,080 + 81,920 bytes, 0.574 ms at 3.35 TB/s
    assert flop == 1.96608e12 and nbytes == 1_920_000_000 + 1024 * 960 * 2 + 1024 * 80
    least, which = roofline.least_seconds(flop, nbytes, H100)
    assert which == "bf16 tensor cores"
    share = read(ctx(kernels))
    assert share == pytest.approx(100.0 * least / 3e-3) == pytest.approx(66.26, abs=0.01)
    assert read(ctx(kernels[2:])) is None  # no dense kernel ran
    assert read(ctx(kernels, peaks=None)) is None  # a card without published peaks
