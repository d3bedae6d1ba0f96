"""deep-image-96-angular's shape on the port's IVF path: 96 dimensions over
25 quantizers of 256 codes (21 subspaces of 4 lanes, then 4 of 3),
angular, partitions and probe at gulon's defaults, built by
``build_ivf_index`` and queried at 1,024 queries a batch.

The benchmark's configuration file states those defaults. On the CPU a
seeded 20,000-row index of 20 partitions, probe 1, answers 64 queries
through ``auto`` (the masked scan) and K1's plain twin
(``scan_strategy="pallas"``, 4 winners a 128-row block), each held to the
benchmark's own comparison (``h100bench/check.py::answer_numbers`` over
``h100bench/reference``: exact distances to the reconstruction of the
index's codes, the nearest among the probed partitions' rows). On a card
(tests marked ``cuda``) ``auto`` takes K1 at 1,024 queries, and the
selection counts the keys it may read: the batch's queries times the
winner columns of the probe's largest partitions.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import gulon_tpu_torch as gt
from gulon_tpu_torch.models.build import default_limit, default_num_partitions
from gulon_tpu_torch.utils import tracing
from h100bench import check
from h100bench.corpus import keys_for, low_rank
from h100bench.reference import exact
from h100bench.systems import PortSystem

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads(
    (REPO / "h100bench/configs/deep-image-96-angular.ivf-pq25.json").read_text())
D, M, K = 96, 25, 256


def test_the_configuration_is_gulons_defaults():
    data, index = CONFIG["dataset"], CONFIG["index"]
    assert (data["n"], data["d"], data["metric"]) == (9_990_000, D, "angular")
    assert index["partitions"] == default_num_partitions(data["n"]) == 9990
    assert index["probe"] == default_limit(index["partitions"]) == 499
    assert (index["pq"]["num_quantizers"], index["pq"]["num_clusters"]) == (M, K)
    assert CONFIG["reduced"] == []


def _corpus(rows: int, queries: int, device="cpu"):
    x = low_rank(96, rows + queries, D, intrinsic=32, clusters=1000, noise=0.05, device=device)
    x = x.cpu().numpy()
    return x[:rows], x[rows:]


def _spec(partitions: int, probe: int) -> dict:
    return {"index": dict(CONFIG["index"], partitions=partitions, probe=probe)}


@pytest.fixture(scope="module")
def cpu_case():
    torch.manual_seed(0)
    x, q = _corpus(20_000, 64)
    index = gt.build_ivf_index(
        keys_for(len(x)), x, gt.Metric.COSINE, gt.PQConfig(max_iters=8), num_partitions=20,
        strategy=gt.LimitGroups(1), coarse_max_iters=10, device="cpu")
    return index, x, q


def _numbers(index, x, q, dists, ids):
    """The check's ``dist_err`` and ``adc_miss`` of the answers, as the
    benchmark computes them (float64, normalised for angular)."""
    system = PortSystem(_spec(20, 1), "cpu")
    state = system.export(index)
    rows = system.corpus_rows(index)
    ids = ids.numpy()
    rows = np.where(ids >= 0, rows[np.maximum(ids, 0)], -1)
    xd = exact.normalized(torch.from_numpy(x).to(torch.float64))
    qd = exact.normalized(torch.from_numpy(q).to(torch.float64))
    return check.answer_numbers(state, check.reconstruction(state, xd), qd,
                                dists.to(torch.float64), torch.from_numpy(rows))


def test_the_index_is_deep96s_shape(cpu_case):
    index, _, _ = cpu_case
    assert [w for _, w in index.pq.bounds] == [4] * 21 + [3] * 4
    assert (index.num_partitions, index.pq.num_clusters, index.pq.pad_width) == (20, K, 4)
    assert index.size == 20_000


def test_auto_answers_as_the_reference_does(cpu_case):
    """``auto`` on the CPU (the masked scan, f32): no answer farther than
    the reference's 10th nearest reconstruction among the probed rows
    (``adc_miss`` 0, the exact comparison), and each distance within
    1e-5 of ``||q||^2 + ||x^||^2`` (2 here): f32 products and sums of
    unit-scale terms round by about 1e-7."""
    index, x, q = cpu_case
    assert index.resolve_strategy(len(q), 10) == "masked"
    dists, ids = index.query_arrays(10, q)
    nums = _numbers(index, x, q, dists, ids)
    assert nums["adc_miss"] == 0.0
    assert nums["dist_err"] < 1e-5


def test_k1_twin_answers_within_bf16_of_the_reference(cpu_case):
    """K1's plain twin at 4 winners a block over the partition-padded
    layout: each reported distance within 2^-9 of the scale (the bf16
    rounding of each ``-2 q`` lane, 2^-9 of it, against codewords on the
    bf16 grid, with ``sum |2 q_i x_i| <= 2`` over a scale of 2), and at
    most 3 % of answers past the reference's 10th (bf16 scores swap
    neighbours closer than that rounding; the benchmark's IVF cells hold
    2.8 %)."""
    index, x, q = cpu_case
    twin = dataclasses.replace(index, scan_strategy="pallas", _k1_operands=None,
                               _pallas_layout=None)
    dists, ids = twin.query_arrays(10, q)
    nums = _numbers(index, x, q, dists, ids)
    assert nums["dist_err"] <= 2.0 ** -9
    assert nums["adc_miss"] <= 0.03


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K1 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_auto_takes_k1_and_counts_the_keys_it_sorts(card):
    """200,000 rows in 200 partitions, probe 10, 1,024 queries: ``auto``
    resolves to K1 (``pallas``), one launch, one selection and one launch
    of the selection kernel a batch, which may read the batch's queries
    times the winner columns of the 10 largest partitions and of the
    padding blocks (4 a 128-row block of the padded layout), fewer than
    all of K1's; its answers pass the check's exact comparison up to the
    cell's bf16 limits."""
    x, q = _corpus(200_000, 1024, device=card)
    index = gt.build_ivf_index(
        keys_for(len(x)), x, gt.Metric.COSINE, gt.PQConfig(max_iters=8), num_partitions=200,
        strategy=gt.LimitGroups(10), coarse_max_iters=10, device=card)
    assert index.resolve_strategy(1024, 10) == "pallas"
    index.query_arrays(10, q)  # operands built
    names = ("k1.launches", "ivf.selects", "ivf.select_keys", "ivf.topk.launches")
    before = {c: tracing.counter(c) for c in names}
    dists, ids = index.query_arrays(10, q)
    torch.cuda.synchronize()
    n = {c: tracing.counter(c) - v for c, v in before.items()}
    blocks = -(-index.partition_sizes().astype(np.int64) // 128)
    padding = index._k1_operands.codes_t.shape[1] // 128 - int(blocks.sum())
    columns = index.pallas_winners * (int(np.sort(blocks)[::-1][:10].sum()) + padding)
    assert columns < index._k1_operands.codes_t.shape[1] // 128 * index.pallas_winners
    assert n == {"k1.launches": 1, "ivf.selects": 1, "ivf.select_keys": 1024 * columns,
                 "ivf.topk.launches": 1}
    system = PortSystem(_spec(200, 10), card)
    state = system.export(index)
    rows = system.corpus_rows(index)
    ids = ids.cpu().numpy()
    rows = np.where(ids >= 0, rows[np.maximum(ids, 0)], -1)
    xd = exact.normalized(torch.from_numpy(x).to(card, torch.float64))
    qd = exact.normalized(torch.from_numpy(q).to(card, torch.float64))
    nums = check.answer_numbers(state, check.reconstruction(state, xd), qd,
                                dists.to(torch.float64), torch.from_numpy(rows).to(card))
    assert nums["dist_err"] <= 2.0 ** -9 and nums["adc_miss"] <= 0.03
