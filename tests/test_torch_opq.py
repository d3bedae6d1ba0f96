"""Port parity: OPQ (``gulon_tpu_torch/ops/opq.py``) and the builders'
``opq_iters``.

``procrustes_rotation`` equals the JAX package's on the same inputs (1e-5).
``train_opq`` with the JAX package's init draws injected (one per round
and one for the final training) learns a rotation that is orthogonal to
1e-5 and quantizes no worse than plain PQ with the same final draw, and
its reconstruction error is the JAX run's within 2 %. Builds with
``opq_iters`` serve their own rows, and their files carry the rotation.
"""

import numpy as np
import pytest
import torch

from generators import random_keys
from gulon_tpu.ops import kmeans as jkm
from gulon_tpu.ops import opq as jopq
from gulon_tpu.ops.pq import PQConfig as JaxPQConfig
import gulon_tpu_torch as gt
from gulon_tpu_torch.ops import opq as topq
from gulon_tpu_torch.ops import pq as tpq
from gulon_tpu_torch.utils import serde

torch.set_num_threads(2)

N, D, M, K = 1500, 16, 4, 16


@pytest.fixture(scope="module")
def corpus():
    """Correlated dimensions: a random mixing of a low-variance tail, the
    case OPQ helps."""
    rng = np.random.default_rng(61)
    z = rng.normal(size=(N, D)) * np.linspace(3.0, 0.2, D)
    mix, _ = np.linalg.qr(rng.normal(size=(D, D)))
    return (z @ mix).astype(np.float32), random_keys(rng, N)


def test_procrustes_matches_jax(corpus):
    x, _ = corpus
    rng = np.random.default_rng(1)
    x_hat = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    got = topq.procrustes_rotation(torch.from_numpy(x), torch.from_numpy(x_hat)).numpy()
    ref = np.asarray(jopq.procrustes_rotation(x, x_hat))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got @ got.T, np.eye(D), atol=1e-5)


def _jax_draws(opq_iters, seed=0):
    """The JAX package's init rows of each round and of the final training."""
    seeds = [seed + 7919 * it for it in range(opq_iters)] + [seed]
    return [np.asarray(jkm.init_indices(M, N, K, s)) for s in seeds]


@pytest.mark.parametrize("opq_iters", [1, 3])
def test_train_opq_with_injected_inits(corpus, opq_iters):
    x, _ = corpus
    cfg = dict(num_clusters=K, num_quantizers=M, max_iters=10, precision="highest")
    draws = _jax_draws(opq_iters)
    rot, pq = topq.train_opq(
        x, tpq.PQConfig(**cfg), opq_iters=opq_iters, device="cpu", init_indices=draws
    )
    r = rot.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(D), atol=1e-5)
    plain = tpq.train_product_quantizer(
        x, tpq.PQConfig(**cfg), device="cpu", init_indices=draws[-1]
    )
    mse_opq = topq.reconstruction_mse(pq, x, rot)
    mse_plain = topq.reconstruction_mse(plain, x)
    assert mse_opq <= mse_plain
    jrot, jpq = jopq.train_opq(x, JaxPQConfig(**cfg), opq_iters=opq_iters)
    mse_jax = jopq.reconstruction_mse(jpq, x, jrot)
    assert mse_opq == pytest.approx(mse_jax, rel=0.02)


def test_train_opq_reports_and_checks(corpus):
    x, _ = corpus
    cfg = tpq.PQConfig(num_clusters=K, num_quantizers=M, max_iters=5)
    seen = []
    rot, _ = topq.train_opq(x, cfg, opq_iters=2, device="cpu", report_fn=lambda *a: seen.append(a))
    assert [s[0] for s in seen] == [0, 1] and all(s[1] > 0 for s in seen)
    ident, _ = topq.train_opq(x, cfg, opq_iters=0, device="cpu")
    assert torch.equal(ident, torch.eye(D))
    with pytest.raises(ValueError):
        topq.train_opq(x, cfg, opq_iters=2, device="cpu", init_indices=[None])


@pytest.mark.parametrize("partitioned", [False, True])
def test_opq_builds_serve_and_save(corpus, partitioned, tmp_path):
    x, keys = corpus
    pq = gt.PQConfig(num_clusters=K, num_quantizers=M, max_iters=8)
    if partitioned:
        index = gt.build_ivf_index(
            keys, x, pq_config=pq, num_partitions=6, strategy=gt.LimitGroups(3),
            coarse_max_iters=5, opq_iters=2, device="cpu",
        )
        plain = gt.build_ivf_index(
            keys, x, pq_config=pq, num_partitions=6, strategy=gt.LimitGroups(3),
            coarse_max_iters=5, device="cpu",
        )
    else:
        index = gt.build_flat_index(keys, x, pq_config=pq, opq_iters=2, device="cpu")
        plain = gt.build_flat_index(keys, x, pq_config=pq, device="cpu")
    assert index.rotation is not None and plain.rotation is None
    truth = gt.sample_ground_truth(keys, x, num_samples=100, ks=(1, 10), device="cpu")
    r_opq = gt.recall_of(index, truth, x, keys)[10].mean
    r_plain = gt.recall_of(plain, truth, x, keys)[10].mean
    assert r_opq >= r_plain - 0.02
    # lookup undoes the rotation: the reconstruction lies near the row
    row = int(np.flatnonzero(keys == index.key_index.keys[0])[0])
    assert np.linalg.norm(index.lookup(index.key_index.keys[0]) - x[row]) < np.linalg.norm(x[row])
    path = tmp_path / "opq.pb"
    serde.save_index(index, path)
    back = serde.load_index(path, device="cpu")
    assert torch.equal(back.rotation, index.rotation)
    np.testing.assert_array_equal(back.query_arrays(10, x[:16])[1].numpy(),
                                  index.query_arrays(10, x[:16])[1].numpy())
