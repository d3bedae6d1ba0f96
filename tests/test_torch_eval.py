"""Port parity: the recall harness (ground truth + distance-cutoff recall).

On the same index arrays (``from_reference``) and the same decode scan
at full f32, the port's ``sample_ground_truth`` and ``recall_of`` give the
JAX package's values: the same sampled queries and keys, k-th distances
within f32 rounding, recall means within 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

from generators import random_keys
from gulon_tpu.models.build import build_flat_index as jax_build
from gulon_tpu.ops.pq import PQConfig
from gulon_tpu.utils import eval as jeval
from gulon_tpu_torch import interop
from gulon_tpu_torch.utils import eval as teval

torch.set_num_threads(2)

KS = (1, 5, 10, 25)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(31)
    x = rng.normal(size=(3000, 16)).astype(np.float32)
    keys = random_keys(rng, 3000)
    jx = jax_build(
        keys, x,
        pq_config=PQConfig(num_clusters=32, num_quantizers=4, max_iters=8),
    )
    jx = dataclasses.replace(jx, scan_strategy="decode", precision="highest")
    return x, keys, jx, interop.from_reference(jx, device="cpu")


def test_sample_ground_truth_matches(setup):
    x, keys, _, _ = setup
    gj = jeval.sample_ground_truth(keys, x, num_samples=100, seed=4, ks=KS)
    gt = teval.sample_ground_truth(keys, x, num_samples=100, seed=4, ks=KS, device="cpu")
    np.testing.assert_array_equal(gt.queries, gj.queries)
    np.testing.assert_array_equal(gt.query_keys, gj.query_keys)
    assert gt.ks == gj.ks == KS
    for k in KS:
        np.testing.assert_allclose(
            gt.kth_distances[k], gj.kth_distances[k], rtol=1e-6, atol=1e-6
        )
    # self-queries: the nearest is the row itself, at exactly 0
    assert np.all(gt.kth_distances[1] == 0.0)


def test_recall_of_matches(setup):
    x, keys, jx, port = setup
    truth = jeval.sample_ground_truth(keys, x, num_samples=120, ks=KS)
    rj = jeval.recall_of(jx, truth, x, keys, batch_size=50)
    rt = teval.recall_of(port, truth, x, keys, batch_size=50)
    assert sorted(rt) == sorted(rj)
    for k in KS:
        assert rt[k].count == rj[k].count == 120
        assert rt[k].mean == pytest.approx(rj[k].mean, abs=1e-9)
    assert teval.format_recall(rt) == jeval.format_recall(rj)


def test_ground_truth_for_queries_cosine_and_epsilon(setup):
    x, keys, _, port = setup
    rng = np.random.default_rng(5)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    gj = jeval.ground_truth_for_queries(q, x, ks=(1, 10, 5000), normalize=True)
    gt = teval.ground_truth_for_queries(q, x, ks=(1, 10, 5000), normalize=True, device="cpu")
    assert gt.ks == gj.ks == (1, 10)  # k above the corpus size dropped
    for k in gt.ks:
        np.testing.assert_allclose(gt.kth_distances[k], gj.kth_distances[k], rtol=1e-5)
    truth = teval.ground_truth_for_queries(q, x, ks=(10,), device="cpu")
    progress = []
    r0 = teval.recall_of(port, truth, x, keys)[10].mean
    r1 = teval.recall_of(port, truth, x, keys, epsilon=0.5,
                         report_fn=progress.append)[10].mean
    assert r1 >= r0
    assert progress[-1].completed == progress[-1].total == 20
    with pytest.raises(ValueError):
        teval.ground_truth_for_queries(q, x[:3], ks=(10,), device="cpu")
    with pytest.raises(ValueError):  # index from another corpus
        teval.recall_of(port, truth, x, np.array(["a"] * len(x), dtype=object))


def test_default_ks_match():
    assert teval.DEFAULT_KS == jeval.DEFAULT_KS
