"""The CLI path on a CUDA card (tests marked ``cuda``; they skip without
one). This file imports no JAX, so on a GPU host without JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_cli_cuda.py``.

- k-means is bit-reproducible on the card: two ``fit_kmeans`` runs on the
  same host array with the same seed give equal centroids and
  assignments (the update adds in a fixed order), for both inits;
- an index file loads onto the card (``load_index``'s default device),
  serves the CPU load's ids through the kernels, and saves back to the
  same bytes;
- the command line builds, queries, adds and removes on the card.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import gulon_tpu_torch as gt
from gulon_tpu_torch import cli
from gulon_tpu_torch.ops.cuda import adc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CLI path serves from the card")
    return "cuda"


def _corpus(n=20_000, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), np.array(
        [f"k{i:06d}" for i in range(n)], dtype=object
    )


@pytest.mark.cuda
@pytest.mark.parametrize("init", ["sample", "kmeans++"])
def test_kmeans_is_bit_reproducible(cuda_device, init):
    x, _ = _corpus()
    cfg = gt.KMeansConfig(k=300, max_iters=8, seed=0, init=init)
    a = gt.fit_kmeans(x, cfg, device=cuda_device)
    b = gt.fit_kmeans(x, cfg, device=cuda_device)
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.assignments, b.assignments)
    stacked = x.reshape(20_000, 4, 8).transpose(1, 0, 2).copy()
    c = gt.fit_kmeans(stacked, cfg._replace(k=64), device=cuda_device)
    e = gt.fit_kmeans(stacked, cfg._replace(k=64), device=cuda_device)
    assert torch.equal(c.centroids, e.centroids)


@pytest.mark.cuda
@pytest.mark.parametrize("partitioned", [False, True])
def test_load_index_onto_the_card(cuda_device, tmp_path, partitioned):
    x, keys = _corpus()
    pq = gt.PQConfig(num_clusters=64, num_quantizers=8, max_iters=5)
    if partitioned:
        built = gt.build_ivf_index(keys, x, pq_config=pq, num_partitions=20,
                                   coarse_max_iters=5, device="cpu")
    else:
        built = gt.build_flat_index(keys, x, pq_config=pq, device="cpu")
    path = tmp_path / "i.pb"
    gt.save_index(built, path)
    card = gt.load_index(path)
    assert card.codes.is_cuda
    assert (card.row_const if partitioned else card.recon_norms).is_cuda
    q = x[:1024] + 0.01
    before = adc.adc_scan_kernel_launches
    d_card, i_card = card.query_arrays(10, q)
    assert adc.adc_scan_kernel_launches > before
    cpu = gt.load_index(path, device="cpu")
    cpu.scan_strategy = "pallas"
    d_cpu, i_cpu = cpu.query_arrays(10, q)
    assert float((i_card.cpu() == i_cpu).float().mean()) >= 0.99
    np.testing.assert_allclose(d_card.cpu().numpy(), d_cpu.numpy(), rtol=1e-3, atol=1e-3)
    gt.save_index(card, tmp_path / "back.pb")
    assert (tmp_path / "back.pb").read_bytes() == path.read_bytes()


@pytest.mark.cuda
def test_cli_on_the_card(cuda_device, tmp_path):
    x, keys = _corpus(n=8000)
    vecs, q, idx = tmp_path / "v.bin", tmp_path / "q.txt", tmp_path / "i.pb"
    gt.write_word2vec_bin(gt.WordVectors(keys, x), vecs)
    with open(q, "w") as f:
        gt.write_word2vec(gt.WordVectors(keys[:8], x[:8]), f)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["build-index", "--metric", "cosine", "-m", "8", "-k", "64",
                         "-n", "5", "-o", str(idx), str(vecs)]) == 0
        assert cli.main(["query", "-k", "3", "--index", str(idx), str(q)]) == 0
        assert cli.main(["add-vectors", "--index", str(idx), "-o", str(tmp_path / "a.pb"),
                         str(q)]) == 0
        assert cli.main(["remove-keys", "--index", str(tmp_path / "a.pb"), "-o",
                         str(tmp_path / "r.pb"), str(keys[0])]) == 0
    lines = out.getvalue().splitlines()
    assert [ln.split(": ")[0] for ln in lines] == list(keys[:8])
    # keys[0] was added a second time, and remove-keys drops every copy
    assert gt.load_index(tmp_path / "r.pb").size == 8000 + 8 - 2
