"""Port parity: stacked Lloyd k-means.

``jax.random`` cannot be replayed in torch, so the port's ``fit_kmeans``
takes the JAX package's init draw through ``init_indices=``; with it and
``precision="highest"`` the two loops follow the same trajectory up to
f32 summation order: >= 99.9 % of assignments equal, centroids within
atol 1e-4, equal iteration counts and convergence flags.
"""

import numpy as np
import pytest
import torch

from generators import planted_clusters
from gulon_tpu.ops import kmeans as jkm
from gulon_tpu_torch.ops import kmeans as tkm

torch.set_num_threads(2)


def _stacked(seed, m=4, n=3000, d=6, k=12):
    rng = np.random.default_rng(seed)
    parts = [planted_clusters(rng, n, d, k, scale=0.15)[0] for _ in range(m)]
    return np.stack(parts).astype(np.float32)


@pytest.mark.parametrize("seed,k", [(0, 16), (1, 32)])
def test_fit_kmeans_matches_jax_with_injected_init(seed, k):
    x = _stacked(seed)
    m, n, _ = x.shape
    cfg_j = jkm.KMeansConfig(k=k, max_iters=10, seed=seed, precision="highest")
    cfg_t = tkm.KMeansConfig(k=k, max_iters=10, seed=seed, precision="highest")
    ref = jkm.fit_kmeans(x, cfg_j)
    init = np.asarray(jkm.init_indices(m, n, k, seed))
    got = tkm.fit_kmeans(x, cfg_t, device="cpu", init_indices=init)
    same = np.mean(got.assignments.numpy() == np.asarray(ref.assignments))
    assert same >= 0.999, same
    np.testing.assert_allclose(
        got.centroids.numpy(), np.asarray(ref.centroids), atol=1e-4, rtol=0
    )
    assert got.iterations == int(ref.iterations)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))


def test_fit_kmeans_unstacked_input():
    rng = np.random.default_rng(2)
    x, _, _ = planted_clusters(rng, 2000, 5, 8, scale=0.1)
    cfg = dict(k=8, max_iters=15, seed=3, precision="highest")
    ref = jkm.fit_kmeans(x, jkm.KMeansConfig(**cfg))
    init = np.asarray(jkm.init_indices(1, len(x), 8, 3))
    got = tkm.fit_kmeans(x, tkm.KMeansConfig(**cfg), device="cpu", init_indices=init)
    assert got.centroids.shape == (8, 5)
    assert np.mean(got.assignments.numpy() == np.asarray(ref.assignments)) >= 0.999
    np.testing.assert_allclose(
        got.centroids.numpy(), np.asarray(ref.centroids), atol=1e-4, rtol=0
    )


def test_empty_clusters_become_zero():
    """Duplicate init rows leave the later twin without members (argmin
    ties go to the lowest index): its centroid becomes the zero vector,
    in both packages."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(1, 400, 3)) + 5.0).astype(np.float32)
    init = np.array([[0, 0, 1, 2]])
    got = tkm.fit_kmeans(
        x, tkm.KMeansConfig(k=4, max_iters=1, precision="highest"),
        device="cpu", init_indices=init,
    )
    c = got.centroids.numpy()[0]
    assert np.all(c[1] == 0.0)
    assert np.all(np.abs(c[0]) > 0)
    # the JAX update on the same assignment agrees
    ref = np.asarray(
        jkm._update_blocked(x[0], np.asarray(got.assignments[0]), 4, 4096)
    )
    upd = tkm._update(torch.from_numpy(x), got.assignments, 4).numpy()[0]
    np.testing.assert_allclose(upd, ref, atol=1e-5)


def test_lloyd_step_and_objective():
    rng = np.random.default_rng(5)
    x, c, _ = planted_clusters(rng, 1500, 4, 6, scale=0.2)
    cj, aj = jkm.lloyd_step(x, c)
    ct, at = tkm.lloyd_step(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    np.testing.assert_allclose(
        float(tkm.kmeans_objective(torch.from_numpy(x), ct, at)),
        float(jkm.kmeans_objective(x, cj, aj)), rtol=1e-5,
    )


def test_seeded_init_is_per_subspace_and_deterministic():
    a = tkm.draw_init_indices(3, 1000, 16, seed=7)
    b = tkm.draw_init_indices(5, 1000, 16, seed=7)
    assert a.shape == (3, 16)
    np.testing.assert_array_equal(a.numpy(), b[:3].numpy())
    assert not np.array_equal(a.numpy(), tkm.draw_init_indices(3, 1000, 16, 8).numpy())
    x = _stacked(6, m=2, n=500)
    cfg = tkm.KMeansConfig(k=8, max_iters=5, seed=1)
    r1, r2 = (tkm.fit_kmeans(x, cfg, device="cpu") for _ in range(2))
    np.testing.assert_array_equal(r1.centroids.numpy(), r2.centroids.numpy())


def test_deferred_options_raise():
    x = _stacked(7, m=1, n=200)
    with pytest.raises(NotImplementedError):
        tkm.fit_kmeans(x, tkm.KMeansConfig(k=4, init="kmeans++"), device="cpu")
    with pytest.raises(NotImplementedError):
        tkm.fit_kmeans(x, tkm.KMeansConfig(k=4), report_fn=lambda *a: None, device="cpu")
    with pytest.raises(ValueError):
        tkm.fit_kmeans(x, tkm.KMeansConfig(k=4, init="bogus"), device="cpu")
    with pytest.raises(ValueError):
        tkm.fit_kmeans(
            x, tkm.KMeansConfig(k=4), device="cpu", init_indices=np.zeros((2, 4))
        )
