"""Port parity: probe-limit tuning (``gulon_tpu_torch/utils/tune.py``).

One IVF index, served by both packages through ``from_reference``, is
tuned by each package's ``tune_probe_limit``: the binary search visits
the same limits, measures the same recall at each (the ground truth
samples the same rows), and picks the same limit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from generators import random_keys

from gulon_tpu.models import ivf as jivf
from gulon_tpu.models.build import build_ivf_index as jax_build
from gulon_tpu.ops.pq import PQConfig as JaxPQConfig
from gulon_tpu.utils.tune import tune_probe_limit as jax_tune
from gulon_tpu_torch import interop
from gulon_tpu_torch.models.ivf import IVFIndex, LimitGroups, LimitVectors
from gulon_tpu_torch.utils.tune import TuneResult, tune_probe_limit

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus():
    # Gaussian rows: neighbours spread over partitions, so recall climbs
    # with the limit (0.46 at one partition, 0.70 at all ten)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4000, 16)).astype(np.float32)
    keys = random_keys(rng, 4000)
    jx = jax_build(
        keys, x, pq_config=JaxPQConfig(num_clusters=32, num_quantizers=8, max_iters=8),
        num_partitions=10, strategy=jivf.LimitGroups(3), coarse_max_iters=8,
    )
    return x, keys, jx


@pytest.mark.parametrize(
    "strategy,target",
    [(jivf.LimitGroups(3), 0.65), (jivf.LimitVectors(800), 0.65)],
    ids=["groups", "vectors"],
)
def test_tune_matches_jax(corpus, strategy, target):
    x, keys, jx = corpus
    jx = dataclasses.replace(jx, strategy=strategy, precision="highest")
    port = interop.from_reference(jx, device="cpu")
    trace_j, trace_t = [], []
    kw = dict(target_recall=target, k=10, num_samples=128, seed=1)
    rj = jax_tune(jx, x, keys, report_fn=lambda *a: trace_j.append(a), **kw)
    rt = tune_probe_limit(port, x, keys, report_fn=lambda *a: trace_t.append(a), **kw)
    assert isinstance(rt, TuneResult) and isinstance(rt.index, IVFIndex)
    assert [a[0] for a in trace_t] == [a[0] for a in trace_j]
    np.testing.assert_allclose([a[2] for a in trace_t], [a[2] for a in trace_j], atol=1e-9)
    assert (rt.limit, rt.evaluations, rt.met) == (rj.limit, rj.evaluations, rj.met)
    assert rt.achieved_recall == pytest.approx(rj.achieved_recall, abs=1e-9)
    kind = LimitGroups if isinstance(strategy, jivf.LimitGroups) else LimitVectors
    assert rt.index.strategy == kind(rt.limit)
    assert 1 < rt.limit and rt.met and rt.evaluations > 2


def test_tune_unmet_target_and_errors(corpus):
    x, keys, jx = corpus
    port = interop.from_reference(jx, device="cpu")
    res = tune_probe_limit(port, x, keys, target_recall=1.0, num_samples=32)
    ref = jax_tune(jx, x, keys, target_recall=1.0, num_samples=32)
    assert (res.met, res.limit, res.evaluations) == (ref.met, ref.limit, ref.evaluations)
    assert not res.met and res.limit == port.num_partitions
    with pytest.raises(ValueError):
        tune_probe_limit(port, x, keys, target_recall=0.0)
    with pytest.raises(ValueError):
        tune_probe_limit(object(), x, keys)
