"""The CLI path on a CUDA card (tests marked ``cuda``; they skip without
one). This file imports no JAX, so on a GPU host without JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_cli_cuda.py``.

- k-means is bit-reproducible on the card: two ``fit_kmeans`` runs on the
  same host array with the same seed give equal centroids and
  assignments (the update adds in a fixed order), for both inits;
- an index file loads onto the card (``load_index``'s default device),
  serves the CPU load's ids through the kernels, and saves back to the
  same bytes;
- the command line builds, queries, adds and removes on the card;
- a streaming build of a word2vec text file equals the in-memory build of
  the same file on the card, bit for bit (flat and partitioned);
- a packed index serves the unpacked index's ids and distances on the card;
- ``load_serving`` serves the live path's ids on the card (K1 through the
  flat and IVF plans), and launches K1 while it loads; a cached flat
  index's plan builds K2's operand once at load, and every plan reads the
  index's copy.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import gulon_tpu_torch as gt
from gulon_tpu_torch import cli
from gulon_tpu_torch.utils import tracing


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
    before = tracing.counter("k1.launches")
    d_card, i_card = card.query_arrays(10, q)
    assert tracing.counter("k1.launches") > before
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


def _text_file(path, n, d, seed=0):
    x, keys = _corpus(n=n, d=d, seed=seed)
    with open(path, "w") as f:
        gt.write_word2vec(gt.WordVectors(keys, x), f)
    return gt.read_word2vec_path(path)


@pytest.mark.cuda
@pytest.mark.parametrize("partitioned", [False, True])
def test_streamed_build_equals_in_memory_on_the_card(cuda_device, tmp_path, partitioned):
    """150,000 rows in one streamed chunk: the codes of a row do not
    depend on which rows share its encode block."""
    path = tmp_path / "v.txt"
    wv = _text_file(path, 150_000, 40)
    if partitioned:
        cfg = gt.PQConfig(num_clusters=64, num_quantizers=8, max_iters=6)
        kw = dict(pq_config=cfg, num_partitions=150, coarse_max_iters=6)
        a = gt.build_ivf_index(wv.keys, wv.vectors, **kw)
        b = gt.build_ivf_index_streaming(str(path), **kw)
        names = ("centroids", "codes", "group_ids", "row_const")
    else:
        cfg = gt.PQConfig(num_clusters=64, num_quantizers=8, max_iters=6, train_sample=40_000)
        a = gt.build_flat_index(wv.keys, wv.vectors, pq_config=cfg)
        b = gt.build_flat_index_streaming(str(path), pq_config=cfg)
        names = ("codes", "recon_norms")
    assert b.codes.is_cuda and torch.equal(a.pq.codebooks, b.pq.codebooks)
    for name in names:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert list(a.key_index.keys) == list(b.key_index.keys)


@pytest.mark.cuda
def test_packed_ids_equal_unpacked_on_the_card(cuda_device):
    x, keys = _corpus()
    plain = gt.build_flat_index(keys, x, pq_config=gt.PQConfig(
        num_clusters=16, num_quantizers=8, max_iters=5))
    packed = dataclasses.replace(plain)
    packed.pack_memory()
    packed.scan_strategy = "auto"
    q = x[:1024] + 0.01
    assert packed.resolve_strategy(1024, 10) == "decode"
    before = tracing.counter("k1.launches")
    dp, ip = packed.query_arrays(10, q)
    assert tracing.counter("k1.launches") == before  # decode is plain torch
    dd, idd = dataclasses.replace(plain, scan_strategy="decode").query_arrays(10, q)
    assert torch.equal(ip, idd) and torch.equal(dp, dd)


@pytest.mark.cuda
@pytest.mark.parametrize("partitioned", [False, True])
def test_load_serving_equals_the_live_path_on_the_card(cuda_device, tmp_path, partitioned):
    x, keys = _corpus()
    pq = gt.PQConfig(num_clusters=64, num_quantizers=8, max_iters=5)
    if partitioned:
        index = gt.build_ivf_index(keys, x, pq_config=pq, num_partitions=20,
                                   coarse_max_iters=5)
    else:
        index = gt.build_flat_index(keys, x, pq_config=pq)
    path = str(tmp_path / "i.aot")
    gt.save_serving(path, gt.export_serving(index, shapes=[(1, 10), (1024, 10)]))
    before = tracing.counter("k1.launches")
    serving = gt.load_serving(path, index)
    assert tracing.counter("k1.launches") > before  # the warm-up ran K1
    assert serving._plans[(1024, 10)]["scan_strategy"] == "pallas"
    q = x[:1024] + 0.01
    for nq in (1024, 1):
        d_aot, i_aot = serving.query_arrays(10, q[:nq])
        d_live, i_live = index.query_arrays(10, q[:nq])
        assert torch.equal(i_aot, i_live) and torch.equal(d_aot, d_live)


@pytest.mark.cuda
def test_load_serving_shares_the_cached_operand_on_the_card(cuda_device, tmp_path):
    x, keys = _corpus()
    index = gt.build_flat_index(keys, x, pq_config=gt.PQConfig(
        num_clusters=64, num_quantizers=8, max_iters=5))
    index.enable_cache()
    path = str(tmp_path / "c.aot")
    gt.save_serving(path, gt.export_serving(index, shapes=[(8, 10), (1024, 10)],
                                            warm_cache=False))
    before = tracing.counter("k2.launches")
    serving = gt.load_serving(path, index)
    assert tracing.counter("k2.launches") > before  # the warm-up ran K2
    assert serving._plans[(1024, 10)]["scan_strategy"] == "cached"
    assert index._cache_aug is not None and index.decoded_cache is None
    for view in serving._views.values():
        assert view._cache_aug is index._cache_aug and view.decoded_cache is None
    q = x[:1024] + 0.01
    d_aot, i_aot = serving.query_arrays(10, q)
    d_live, i_live = index.query_arrays(10, q)
    assert torch.equal(i_aot, i_live) and torch.equal(d_aot, d_live)
