"""Port parity: streaming builds from a word2vec text file
(``gulon_tpu_torch/models/streaming.py``, ``utils/native.py``).

- ``Word2VecStream`` parses the same keys and the same float bits as the
  JAX package's, row ranges and gathers alike, across an unterminated
  last line, and raises where it raises;
- a streaming build equals the port's in-memory build of the file's
  vectors bit for bit (codebooks, codes, norms, keys; for IVF also
  centroids, group ids and row constants): with a sample covering the
  corpus for both builders, and with a partial sample for the flat one.
  Streaming changes where the rows live, not the result;
- against the JAX package's streaming build: the same key order and the
  same training-sample rows; recall@10 within 0.99x (the k-means init
  draws differ by design, so the builds are held by recall);
- progress reports, ``pipeline_stats``, ``max_partition_size`` and
  ``coarse_init``; ``mesh=`` (four logical CPU shards) builds the
  single-process index, and a mesh that is not a ``parallel.Mesh`` raises.

The chunk sizes force several pipeline iterations and a short last chunk.
"""

import numpy as np
import pytest
import torch

from generators import planted_clusters, random_keys
from gulon_tpu.models import streaming as jstreaming
from gulon_tpu.models.metric import Metric as JaxMetric
from gulon_tpu.ops.pq import PQConfig as JaxPQConfig
from gulon_tpu.utils import eval as jeval
from gulon_tpu.utils import native as jnative
from gulon_tpu_torch.models import streaming as tstreaming
from gulon_tpu_torch.models.build import build_flat_index, build_ivf_index
from gulon_tpu_torch.models.ivf import LimitGroups
from gulon_tpu_torch.models.metric import Metric
from gulon_tpu_torch.ops.pq import PQConfig
from gulon_tpu_torch.utils import eval as teval
from gulon_tpu_torch.utils import native as tnative

torch.set_num_threads(2)

N, D = 3000, 12


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    if not tnative.available():
        pytest.skip("the native parser does not build here (no g++)")
    rng = np.random.default_rng(77)
    x, _, _ = planted_clusters(rng, N, D, 10, scale=0.4)
    keys = random_keys(rng, N)
    path = tmp_path_factory.mktemp("w2v") / "vecs.txt"
    with open(path, "w") as f:
        f.write(f"{N} {D}\n")
        for i in range(N):
            f.write(keys[i] + " " + " ".join(f"{v:.6f}" for v in x[i]))
            if i < N - 1:
                f.write("\n")  # the last line is left unterminated
    with tnative.Word2VecStream(str(path)) as s:
        parsed = s.rows(0, s.num_rows)  # the exact floats the file holds
    return str(path), keys, parsed


def test_stream_rows_and_gather_match_jax(corpus):
    path, keys, x = corpus
    with tnative.Word2VecStream(path) as t, jnative.Word2VecStream(path) as j:
        assert (t.num_rows, t.dim) == (j.num_rows, j.dim) == (N, D)
        assert list(t.keys) == list(j.keys) == list(keys)
        np.testing.assert_array_equal(t.rows(0, N), j.rows(0, N))
        # the last rows cross the unterminated tail line
        np.testing.assert_array_equal(t.rows(N - 5, 5), j.rows(N - 5, 5))
        out = np.full((8, D), np.nan, np.float32)
        assert t.rows(N - 3, 3, out=out) is not None
        np.testing.assert_array_equal(out[:3], x[-3:])
        assert np.isnan(out[3:]).all()
        ids = np.array([N - 1, 0, 1500, 7, 7], np.int64)
        np.testing.assert_array_equal(t.gather(ids), j.gather(ids))
        for call in (lambda s: s.rows(N - 1, 2), lambda s: s.gather([N]),
                     lambda s: s.gather([-1])):
            for s in (t, j):
                with pytest.raises(ValueError):
                    call(s)
        with pytest.raises(ValueError):
            t.rows(0, 4, out=np.zeros((4, D), np.float64))


def test_stream_errors_match_jax(tmp_path):
    if not tnative.available():
        pytest.skip("the native parser does not build here (no g++)")
    bad = tmp_path / "bad.txt"
    bad.write_text("a 1 2 3\nb 1 2 x\nc 4 5 6\n")
    missing = str(tmp_path / "missing.txt")
    for mod in (tnative, jnative):
        with pytest.raises(ValueError, match="cannot open"):
            mod.Word2VecStream(missing)
        with mod.Word2VecStream(str(bad)) as s:
            with pytest.raises(ValueError, match="malformed line at data row 1"):
                s.rows(0, 3)
            np.testing.assert_array_equal(s.gather([2, 0]), [[4, 5, 6], [1, 2, 3]])


@pytest.mark.parametrize("metric,sample", [
    (Metric.COSINE, None), (Metric.L2, None), (Metric.L2, 1000),
])
def test_streaming_flat_equals_in_memory(corpus, metric, sample):
    path, keys, x = corpus
    cfg = PQConfig(num_clusters=16, num_quantizers=4, max_iters=8, train_sample=sample)
    a = build_flat_index(keys, x, metric=metric, pq_config=cfg, device="cpu")
    stats = {}
    b = tstreaming.build_flat_index_streaming(
        path, metric=metric, pq_config=cfg, encode_chunk=700,
        pipeline_stats=stats, device="cpu",
    )
    assert torch.equal(a.pq.codebooks, b.pq.codebooks)
    assert torch.equal(a.codes, b.codes) and b.codes.dtype == torch.uint8
    assert torch.equal(a.recon_norms, b.recon_norms)
    assert list(a.key_index.keys) == list(b.key_index.keys)
    da, ia = a.query_arrays(6, x[5:40])
    db, ib = b.query_arrays(6, x[5:40])
    assert torch.equal(ia, ib) and torch.equal(da, db)
    assert set(stats) == {"wait_s", "consume_s", "wall_s"}
    assert stats["wall_s"] >= stats["consume_s"] >= 0.0


@pytest.mark.parametrize("metric", [Metric.L2, Metric.COSINE])
def test_streaming_ivf_equals_in_memory(corpus, metric):
    path, keys, x = corpus
    cfg = PQConfig(num_clusters=16, num_quantizers=3, max_iters=8)
    kw = dict(metric=metric, pq_config=cfg, num_partitions=8, strategy=LimitGroups(3),
              coarse_max_iters=8, device="cpu")
    a = build_ivf_index(keys, x, **kw)
    b = tstreaming.build_ivf_index_streaming(path, encode_chunk=701, **kw)
    for name in ("centroids", "codes", "group_ids", "row_const"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.pq.codebooks, b.pq.codebooks)
    assert list(a.key_index.keys) == list(b.key_index.keys)
    np.testing.assert_array_equal(a.key_index.group_offsets, b.key_index.group_offsets)
    assert b.strategy == LimitGroups(3)
    da, ia = a.query_arrays(5, x[40:60])
    db, ib = b.query_arrays(5, x[40:60])
    assert torch.equal(ia, ib) and torch.equal(da, db)


def test_streaming_matches_jax_streaming(corpus):
    """The same key order and training rows as the JAX package's streaming
    build; recall@10 of the port's build >= 0.99x the JAX build's."""
    path, keys, x = corpus
    cfg = dict(num_clusters=32, num_quantizers=6, max_iters=12, train_sample=2000)
    with tnative.Word2VecStream(path) as t, jnative.Word2VecStream(path) as j:
        order = np.argsort(t.keys, kind="stable")
        tx, trows = tstreaming._train_sample(t, PQConfig(**cfg), True, order=order)
        jx, jrows = jstreaming._train_sample(j, JaxPQConfig(**cfg), True, order=order)
    np.testing.assert_array_equal(trows, jrows)
    np.testing.assert_array_equal(tx, jx)

    port = tstreaming.build_flat_index_streaming(
        path, metric=Metric.COSINE, pq_config=PQConfig(**cfg), encode_chunk=1000,
        device="cpu",
    )
    ref = jstreaming.build_flat_index_streaming(
        path, metric=JaxMetric.COSINE, pq_config=JaxPQConfig(**cfg), encode_chunk=1000,
    )
    assert list(port.key_index.keys) == list(ref.key_index.keys)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    truth = jeval.sample_ground_truth(keys, xn, num_samples=300, ks=(10,))
    port.scan_strategy = ref.scan_strategy = "decode"
    r_port = teval.recall_of(port, truth, xn, keys)[10].mean
    r_ref = jeval.recall_of(ref, truth, xn, keys)[10].mean
    assert r_port >= 0.99 * r_ref, (r_port, r_ref)


def test_streaming_reports_progress(corpus):
    path, _, _ = corpus
    seen = []
    tstreaming.build_flat_index_streaming(
        path,
        pq_config=PQConfig(num_clusters=8, num_quantizers=2, max_iters=4, train_sample=500),
        encode_chunk=1000, report_fn=seen.append, device="cpu",
    )
    rows = [p.rows_done for p in seen]
    assert rows == [1000, 2000, 3000]
    assert seen[-1].total_rows == N and seen[-1].percentage == 100.0


def test_streaming_ivf_split_and_init_knobs(corpus):
    """``max_partition_size`` bounds every partition and ``coarse_init``
    reaches the coarse k-means; the nearest neighbour of a row is itself
    or lies in its planted cluster."""
    path, keys, x = corpus
    cfg = PQConfig(num_clusters=16, num_quantizers=4, max_iters=8, block_rows=256,
                   train_sample=1024)
    index = tstreaming.build_ivf_index_streaming(
        path, pq_config=cfg, num_partitions=6, strategy=LimitGroups(4),
        coarse_max_iters=8, coarse_init="kmeans++", max_partition_size=200,
        encode_chunk=700, device="cpu",
    )
    assert index.partition_sizes().max() <= 200
    assert index.num_partitions >= N // 200
    row = {k_: i for i, k_ in enumerate(keys)}
    for i, r in enumerate(index.batch_query(1, x[:12])):
        # within a planted cluster E||a-b||^2 ~ 2*d*0.4^2 ~ 3.8, across
        # clusters ~ 2*d ~ 24
        assert float(((x[row[r.keys[0]]] - x[i]) ** 2).sum()) < 10.0
    with pytest.raises(ValueError):
        tstreaming.build_ivf_index_streaming(
            path, pq_config=cfg, num_partitions=4, max_partition_size=0, device="cpu",
        )


@pytest.mark.parametrize("builder", ["flat", "ivf"])
def test_streaming_mesh_raises(corpus, builder):
    """A mesh that is not a ``parallel.Mesh`` raises."""
    path, _, _ = corpus
    fn = getattr(tstreaming, f"build_{builder}_index_streaming")
    with pytest.raises(TypeError, match="parallel.Mesh"):
        fn(path, pq_config=PQConfig(num_clusters=8, num_quantizers=2), mesh=object(),
           device="cpu")


@pytest.mark.parametrize("builder", ["flat", "ivf"])
def test_streaming_mesh_build_equals_single_process(corpus, builder):
    """``mesh=`` trains over the mesh and encodes each chunk over it: the
    same codes as the single-process streaming build."""
    from gulon_tpu_torch.parallel import make_mesh

    path, _, _ = corpus
    fn = getattr(tstreaming, f"build_{builder}_index_streaming")
    args = dict(pq_config=PQConfig(num_clusters=16, num_quantizers=4, max_iters=6,
                                   train_sample=1500), encode_chunk=700, device="cpu")
    if builder == "ivf":
        args.update(num_partitions=6, coarse_max_iters=6)
    one = fn(path, **args)
    mesh = fn(path, mesh=make_mesh(devices=["cpu"] * 4), **args)
    assert torch.equal(mesh.codes, one.codes)
    np.testing.assert_allclose(mesh.pq.codebooks.numpy(), one.pq.codebooks.numpy(), atol=1e-6)
    if builder == "ivf":
        np.testing.assert_array_equal(mesh.partition_sizes(), one.partition_sizes())
