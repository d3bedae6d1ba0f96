"""The sharded layer on a CUDA card (tests marked ``cuda``; they skip
without one). This file imports no JAX, so on a GPU host without JAX it
runs with ``python -m pytest --noconftest -m cuda
tests/test_torch_parallel_cuda.py``.

- a mesh of four logical shards of one card serves what the single-card
  index serves: the flat ``auto`` route launches K1 once per shard, the
  ``cached`` route and the exact index K2 once per shard, the IVF
  ``pallas`` route K1 once per shard; recall@10 against the exact top-10
  within 0.99x of the single-card route's (shard boundaries move the
  fused kernels' 128-row blocks, so ids are held by recall);
- two mesh builds on the card give the same bits (codebooks, codes, norms,
  IVF centroids and row constants).
"""

import numpy as np
import pytest
import torch

import gulon_tpu_torch as gt
from gulon_tpu_torch.parallel import make_mesh, shard_index
from gulon_tpu_torch.utils import tracing

N, D, Q, K = 65_536 + 300, 32, 256, 10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sharded kernel routes run on the card")
    return "cuda"


def _corpus():
    rng = np.random.default_rng(5)
    basis = rng.standard_normal((8, D), dtype=np.float32)
    centers = rng.standard_normal((300, 8), dtype=np.float32)
    z = centers[rng.integers(0, 300, N)] + 0.3 * rng.standard_normal((N, 8), dtype=np.float32)
    x = (z @ basis / np.float32(np.sqrt(8)) + 0.05 * rng.standard_normal(
        (N, D), dtype=np.float32)).astype(np.float32)
    keys = np.array([f"k{i:06d}" for i in range(N)], dtype=object)
    return keys, x, x[rng.choice(N, Q, replace=False)]


def _recall(ids, x, q):
    """recall@K of ``ids`` against the exact top-K by squared L2."""
    truth = torch.cdist(torch.from_numpy(q), torch.from_numpy(x)).topk(K, largest=False)[1]
    ids = ids.cpu()
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                          for a, b in zip(ids, truth)]))


def _launches(counter, fn):
    before = counter()
    out = fn()
    torch.cuda.synchronize()
    return out, counter() - before


@pytest.mark.cuda
def test_one_card_mesh_matches_single_card(cuda_device):
    keys, x, q = _corpus()
    mesh = make_mesh(devices=["cuda:0"] * 4)
    k1 = lambda: tracing.counter("k1.launches")  # noqa: E731
    k2 = lambda: tracing.counter("k2.launches")  # noqa: E731
    pq = gt.PQConfig(num_clusters=64, num_quantizers=8, max_iters=8)
    flat = gt.build_flat_index(keys, x, pq_config=pq)
    ivf = gt.build_ivf_index(keys, x, pq_config=pq, num_partitions=64,
                             strategy=gt.LimitGroups(16), coarse_max_iters=8)
    exact = gt.build_exact_index(keys, x)
    sharded = {name: shard_index(idx, mesh) for name, idx in
               (("flat", flat), ("ivf", ivf), ("exact", exact))}
    cases = [("flat", flat, k1), ("ivf", ivf, k1), ("exact", exact, k2)]
    assert flat.resolve_strategy(Q, K) == ivf.resolve_strategy(Q, K) == "pallas"
    assert exact.resolve_strategy(K) == "pallas"
    for name, single, counter in cases:
        (_, ids1), l1 = _launches(counter, lambda: single.query_arrays(K, q))
        (_, ids4), l4 = _launches(counter, lambda: sharded[name].query_arrays(K, q))
        assert (l1, l4) == (1, 4), (name, l1, l4)
        assert ids4.device.type == "cuda"
        assert _recall(ids4, x, q) >= 0.99 * _recall(ids1, x, q), name
    flat.enable_cache()
    flat.scan_strategy = "cached"
    cached = shard_index(flat, mesh)  # before the single route turns the cache into K2's operand
    (_, ids1), l1 = _launches(k2, lambda: flat.query_arrays(K, q))
    (_, ids4), l4 = _launches(k2, lambda: cached.query_arrays(K, q))
    assert (l1, l4) == (1, 4)
    assert _recall(ids4, x, q) >= 0.99 * _recall(ids1, x, q)


@pytest.mark.cuda
def test_two_mesh_builds_are_bit_equal(cuda_device):
    keys, x, _ = _corpus()
    mesh = make_mesh(devices=["cuda:0"] * 4)
    pq = gt.PQConfig(num_clusters=64, num_quantizers=8, max_iters=8, train_sample=20_000)
    a, b = (gt.build_flat_index(keys, x, pq_config=pq, mesh=mesh) for _ in range(2))
    assert a.codes.device.type == "cuda"
    assert torch.equal(a.pq.codebooks, b.pq.codebooks) and torch.equal(a.codes, b.codes)
    assert torch.equal(a.recon_norms, b.recon_norms)
    a, b = (gt.build_ivf_index(keys, x, pq_config=pq, num_partitions=64, coarse_max_iters=8,
                               mesh=mesh) for _ in range(2))
    assert torch.equal(a.centroids, b.centroids) and torch.equal(a.codes, b.codes)
    assert torch.equal(a.row_const, b.row_const)
