"""Port parity: stacked Lloyd k-means.

``jax.random`` cannot be replayed in torch, so the port's ``fit_kmeans``
takes the JAX package's init draw through ``init_indices=`` (the uniform
sample or the k-means++ draw); with it and ``precision="highest"`` the
two loops follow the same trajectory up to f32 summation order: >= 99.9 %
of assignments equal, centroids within atol 1e-4, equal iteration counts
and convergence flags. The centroid update equals the JAX package's blocked
one-hot sum and a plain one-hot update (within 1e-5 relative), the
assignment a plain argmin, ties included, two runs give the same bits,
and the progress reports carry its six values.
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
    """Every init and the progress callback are ported; what is left to
    raise is an unknown init and a malformed injected draw."""
    x = _stacked(7, m=1, n=200)
    with pytest.raises(ValueError):
        tkm.fit_kmeans(x, tkm.KMeansConfig(k=4, init="bogus"), device="cpu")
    with pytest.raises(ValueError):
        tkm.fit_kmeans(
            x, tkm.KMeansConfig(k=4), device="cpu", init_indices=np.zeros((2, 4))
        )


@pytest.mark.parametrize("m,n,k", [(1, 1999, 7), (4, 3000, 16), (3, 257, 64)])
def test_update_matches_blocked_one_hot(m, n, k):
    """The port's update against ``_update_blocked`` on the same
    assignments, 1e-5 relative; a few clusters are left empty."""
    rng = np.random.default_rng(m * 100 + k)
    x = rng.normal(size=(m, n, 5)).astype(np.float32) * 3.0 + 1.0
    a = rng.integers(0, k - 2, size=(m, n)).astype(np.int32)
    got = tkm._update(torch.from_numpy(x), torch.from_numpy(a), k).numpy()
    for i in range(m):
        ref = np.asarray(jkm._update_blocked(x[i], a[i], k, 512))
        np.testing.assert_allclose(got[i], ref, rtol=1e-5, atol=1e-6)
        assert np.all(got[i, k - 2:] == 0.0)


def _plain_update(x, a, k, valid=None):
    """The update written out plainly: a ``[m, n, k]`` one-hot of the
    assignments (rows left out by ``valid`` zeroed) times the rows, in
    float64; empty clusters zero."""
    onehot = torch.nn.functional.one_hot(a.long(), k).to(torch.float64)
    if valid is not None:
        onehot = onehot * valid[None, :, None]
    sums = onehot.transpose(1, 2) @ x.to(torch.float64)
    counts = onehot.sum(dim=1)[..., None]
    return torch.where(counts > 0, sums / counts.clamp(min=1), 0.0), counts


@pytest.mark.parametrize("m,n,d,k,piece", [
    (1, 20000, 6, 4096, 128),  # about 5 rows a cluster, many clusters empty
    (2, 6000, 96, 40, 128),  # runs of about 150 rows: two pieces each
    (3, 3000, 4, 256, 3),  # pieces of 3 rows: many a run, a ragged last
    (25, 800, 4, 256, 128),  # PQ's shape, small
], ids=["k4096", "d96-two-pieces", "pieces-of-3", "m25"])
@pytest.mark.parametrize("masked", [False, True], ids=["all-rows", "valid-mask"])
def test_update_matches_plain_one_hot(monkeypatch, m, n, d, k, piece, masked):
    """The sorted, fixed-order segment sum against the plain one-hot
    update in float64, at 1e-5 relative (atol 1e-6): f32 sums of at most
    a few hundred rows of magnitude about 4 round by under 1e-6 relative
    each step. The last three clusters get no rows, so they and every
    cluster a mask empties read zero; the counts are exact."""
    monkeypatch.setattr(tkm, "_PIECE_ROWS", piece)
    rng = np.random.default_rng(n + k + piece)
    x = torch.from_numpy(rng.normal(size=(m, n, d)).astype(np.float32) * 3.0 + 1.0)
    a = torch.from_numpy(rng.integers(0, k - 3, size=(m, n)).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.7) if masked else None
    sums, counts = tkm._segment_sums(x, a, k, valid)
    ref, ref_counts = _plain_update(x, a, k, valid)
    np.testing.assert_array_equal(counts.numpy(), ref_counts.numpy())
    got = tkm._means(sums, counts)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    assert np.all(got[:, k - 3:].numpy() == 0.0)
    assert np.all(got.numpy()[ref_counts.numpy()[..., 0] == 0] == 0.0)


def test_assignment_matches_plain_argmin_ties_to_the_lowest():
    """Rows and centroids on a grid of small integers, so every score is
    exact in f32 and many rows are equally near two or more centroids
    (three centroids are repeated): the port's argmin equals the plain
    ``argmin`` of ``||x - c||^2`` in float64, which takes the lowest
    centroid of a tie, for each subspace and across row blocks."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(-4, 5, size=(3, 2500, 5)).astype(np.float32))
    c = torch.from_numpy(rng.integers(-4, 5, size=(3, 70, 5)).astype(np.float32))
    c[:, 50:53] = c[:, 10:13]
    d2 = ((x[:, :, None, :].double() - c[:, None, :, :].double()) ** 2).sum(-1)
    ref = torch.argmin(d2, dim=-1)
    best = d2.min(dim=-1, keepdim=True).values
    assert int(((d2 == best).sum(-1) > 1).sum()) > 1000  # ties are common here
    for block in (2500, 777):
        for precision in ("default", "highest"):
            got = tkm._assign_blocked(x, c, block, precision)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_two_runs_give_the_same_bits():
    """The same input twice: equal centroids, assignments and iteration
    counts bit for bit, the update and the assignment each too; under a
    valid mask the update equals the update of the kept rows alone, bit
    for bit (the left-out rows sort into a run of their own)."""
    x = torch.from_numpy(_stacked(12, m=3, n=4000, k=24))
    cfg = tkm.KMeansConfig(k=24, max_iters=8, seed=2)
    r1, r2 = (tkm.fit_kmeans(x, cfg, device="cpu") for _ in range(2))
    assert torch.equal(r1.centroids, r2.centroids)
    assert torch.equal(r1.assignments, r2.assignments) and r1.iterations == r2.iterations
    a = r1.assignments
    s1, s2 = (tkm._segment_sums(x, a, 24) for _ in range(2))
    assert torch.equal(s1[0], s2[0]) and torch.equal(s1[1], s2[1])
    keep = torch.arange(4000) % 3 != 0
    masked = tkm._segment_sums(x, a, 24, keep)
    kept = tkm._segment_sums(x[:, keep], a[:, keep], 24)
    assert torch.equal(masked[0], kept[0]) and torch.equal(masked[1], kept[1])


def test_kmeans_pp_with_injected_jax_draw():
    """The JAX package's k-means++ rows through ``init_indices``: the same
    init, so the same trajectory and equal assignments."""
    x = _stacked(8, m=3, n=1500)
    cfg = dict(k=12, max_iters=10, seed=4, precision="highest", init="kmeans++")
    ref = jkm.fit_kmeans(x, jkm.KMeansConfig(**cfg))
    init = np.asarray(jkm._pp_indices_stacked(x, k=12, seed=4))
    got = tkm.fit_kmeans(x, tkm.KMeansConfig(**cfg), device="cpu", init_indices=init)
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(ref.assignments))
    np.testing.assert_allclose(
        got.centroids.numpy(), np.asarray(ref.centroids), atol=1e-4, rtol=0
    )
    assert got.iterations == int(ref.iterations)


def test_kmeans_pp_draw_is_seeded_and_spread():
    """The port's own D^2 draw: deterministic per (seed, subspace), free
    of repeats on distinct rows, every subspace independent of the
    stacking, and a lower starting objective than the uniform draw on a
    planted mixture."""
    x = torch.from_numpy(_stacked(9, m=3, n=2000, k=12))
    a = tkm.kmeans_pp_indices(x, 12, seed=5)
    b = tkm.kmeans_pp_indices(x[:2], 12, seed=5)
    assert a.shape == (3, 12)
    np.testing.assert_array_equal(a[:2].numpy(), b.numpy())
    assert all(len(set(row.tolist())) == 12 for row in a)
    assert not torch.equal(a, tkm.kmeans_pp_indices(x, 12, seed=6))
    uni = tkm.draw_init_indices(3, 2000, 12, 5)

    def start_objective(idx):
        c = torch.stack([x[i, idx[i]] for i in range(3)])
        return float(((x[:, :, None] - c[:, None]) ** 2).sum(-1).min(-1).values.mean())

    assert start_objective(a) < start_objective(uni)
    all_same = torch.ones((1, 50, 3))
    assert int(tkm.kmeans_pp_indices(all_same, 4, seed=0).max()) < 50


def test_report_fn_once_per_iteration():
    """Six values per Lloyd iteration: iteration, step mean, converged
    count, step std, min and max of the centroids' movement."""
    x = _stacked(10, m=2, n=800)
    seen = []
    res = tkm.fit_kmeans(
        x, tkm.KMeansConfig(k=8, max_iters=6, seed=1), report_fn=lambda *a: seen.append(a),
        device="cpu",
    )
    assert [r[0] for r in seen] == list(range(1, res.iterations + 1))
    for it, mean, done, std, lo, hi in seen:
        assert lo <= mean <= hi and std >= 0.0 and 0 <= done <= 2
    assert seen[-1][2] == int(res.converged.sum())
