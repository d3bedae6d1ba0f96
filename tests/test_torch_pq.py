"""Port parity: product-quantizer encode and training.

Encode at ``precision="highest"`` gives >= 99.9 % equal codes on the same
codebooks. Training draws its init with ``torch.Generator`` (``jax.random``
cannot be replayed), so a trained quantizer is held to the JAX one by
recall ratio (>= 0.99) on a planted-cluster corpus; with the JAX init
injected the two trainings agree codebook for codebook.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from generators import planted_clusters
from gulon_tpu.ops import kmeans as jkm
from gulon_tpu.ops import pq as jpq
from gulon_tpu.ops import scan as jscan
from gulon_tpu_torch.ops import pq as tpq
from gulon_tpu_torch.ops import scan as tscan

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    x, _, _ = planted_clusters(rng, 4000, 16, 40, scale=0.25)
    return x


def test_encode_highest_matches(corpus):
    cfg = jpq.PQConfig(num_clusters=32, num_quantizers=8, max_iters=6)
    jq = jpq.train_product_quantizer(corpus, cfg)
    tq = tpq.ProductQuantizer(
        torch.from_numpy(np.array(jq.codebooks)), jq.bounds, jq.num_clusters
    )
    cj = np.asarray(jq.encode(corpus, precision="highest"))
    ct = tq.encode(corpus, precision="highest")
    assert ct.dtype == torch.uint8 and ct.shape == cj.shape
    assert np.mean(ct.numpy() == cj) >= 0.999
    # blocked assignment gives the same codes as one block
    np.testing.assert_array_equal(
        tq.encode(corpus, block_rows=333, precision="highest").numpy(), ct.numpy()
    )


@pytest.mark.parametrize("train_sample", [None, 2500])
def test_training_with_injected_init_matches(corpus, train_sample):
    """Same sample (numpy host draw) + the JAX init -> the same codebooks."""
    kw = dict(num_clusters=16, num_quantizers=4, max_iters=8,
              precision="highest", train_sample=train_sample, seed=3)
    jq = jpq.train_product_quantizer(corpus, jpq.PQConfig(**kw))
    n_train = train_sample or len(corpus)
    init = np.asarray(jkm.init_indices(4, n_train, 16, 3))
    tq = tpq.train_product_quantizer(corpus, tpq.PQConfig(**kw), init_indices=init, device="cpu")
    assert tq.bounds == jq.bounds and tq.num_clusters == 16
    np.testing.assert_allclose(
        tq.codebooks.numpy(), np.asarray(jq.codebooks), atol=1e-2, rtol=0
    )
    same = np.mean(
        tq.codebooks.numpy() == np.asarray(jq.codebooks)
    )  # bf16-snapped: most entries are bit-identical
    assert same >= 0.99, same


def _recall_at_10(codebooks, bounds, codes, norms, x, queries, scan):
    """Fraction of each query's exact top-10 that the ADC top-10 holds."""
    d_true = ((queries[:, None, :] - x[None]) ** 2).sum(-1)
    true = np.argsort(d_true, axis=1, kind="stable")[:, :10]
    _, ids = scan(codebooks, codes, norms)
    ids = np.asarray(ids)
    return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(true, ids)])


def test_trained_quantizer_recall_ratio(corpus):
    cfg = dict(num_clusters=64, num_quantizers=8, max_iters=15, seed=0)
    q = corpus[:200]
    jq = jpq.train_product_quantizer(corpus, jpq.PQConfig(**cfg))
    jc = jq.encode(corpus)
    r_j = _recall_at_10(
        jq.codebooks, jq.bounds, jc, jq.reconstruction_norms(jc), corpus, q,
        lambda cb, c, n: jscan.adc_scan_decode(
            jnp.asarray(q), cb, c, n, bounds=jq.bounds, k=10,
            precision="highest", topk_impl="exact",
        ),
    )
    tq = tpq.train_product_quantizer(corpus, tpq.PQConfig(**cfg), device="cpu")
    tc = tq.encode(corpus)
    r_t = _recall_at_10(
        tq.codebooks, tq.bounds, tc, tq.reconstruction_norms(tc), corpus, q,
        lambda cb, c, n: tscan.adc_scan_decode(
            torch.from_numpy(q), cb, c, n, bounds=tq.bounds, k=10,
            precision="highest",
        ),
    )
    assert r_t >= 0.99 * r_j, (r_t, r_j)


def test_bf16_snap_and_properties(corpus):
    tq = tpq.train_product_quantizer(
        corpus[:1000], tpq.PQConfig(num_clusters=8, num_quantizers=5, max_iters=3), device="cpu"
    )
    cb = tq.codebooks
    assert torch.equal(cb, cb.to(torch.bfloat16).to(torch.float32))
    assert tq.num_quantizers == 5 and tq.dimension == 16
    assert tq.pad_width == 4 and tq.code_bits == 3
    assert tq.dtype_codes == torch.uint8
    raw = tpq.train_product_quantizer(
        corpus[:1000],
        tpq.PQConfig(num_clusters=8, num_quantizers=5, max_iters=3, snap_bf16=False), device="cpu",
    )
    assert not torch.equal(
        raw.codebooks, raw.codebooks.to(torch.bfloat16).to(torch.float32)
    )


def test_tensor_input_subsamples_on_device(corpus):
    x = torch.from_numpy(corpus)
    cfg = tpq.PQConfig(num_clusters=8, num_quantizers=4, max_iters=3,
                       train_sample=500)
    a = tpq.train_product_quantizer(x, cfg, device="cpu")
    b = tpq.train_product_quantizer(x, cfg, device="cpu")
    assert torch.equal(a.codebooks, b.codebooks)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tpq.train_product_quantizer(x, cfg, mesh=object(), device="cpu")


@pytest.mark.parametrize("init,sub_parallel", [("sample", 1), ("sample", 2), ("kmeans++", 1)])
def test_mesh_training_equals_single_process(corpus, init, sub_parallel):
    """``mesh=`` trains the codebooks over the mesh (rows over ``rows``,
    subspaces over ``sub``) from the same init: the single-process
    codebooks within 1e-6 and the same codes."""
    from gulon_tpu_torch.parallel import make_mesh

    cfg = tpq.PQConfig(num_clusters=16, num_quantizers=4, max_iters=8, init=init,
                       train_sample=3000)
    one = tpq.train_product_quantizer(corpus, cfg, device="cpu")
    mesh = make_mesh(devices=["cpu"] * 4, sub_parallel=sub_parallel)
    got = tpq.train_product_quantizer(corpus, cfg, mesh=mesh, device="cpu")
    assert got.device == torch.device("cpu")
    np.testing.assert_allclose(got.codebooks.numpy(), one.codebooks.numpy(), atol=1e-6)
    assert torch.equal(got.encode(corpus), one.encode(corpus))


@pytest.mark.parametrize("kind", ["flat", "ivf", "flat-mesh"])
def test_builds_assign_codes_at_full_f32(corpus, monkeypatch, kind):
    """Every build encodes its rows at ``precision="highest"`` (TF32
    would hand a row a codeword farther than its nearest), single-device
    and over a mesh, whatever precision the training takes."""
    import gulon_tpu_torch as gt
    from gulon_tpu_torch.parallel import make_mesh

    seen = []
    assign = tpq._assign_blocked
    monkeypatch.setattr(tpq, "_assign_blocked",
                        lambda *a: seen.append(a[3]) or assign(*a))
    keys = np.array([f"k{i:05d}" for i in range(len(corpus))], dtype=object)
    cfg = gt.PQConfig(num_clusters=16, num_quantizers=4, max_iters=3)
    if kind == "ivf":
        gt.build_ivf_index(keys, corpus, pq_config=cfg, num_partitions=8,
                           coarse_max_iters=3, device="cpu")
    else:
        mesh = make_mesh(devices=["cpu"] * 2) if kind == "flat-mesh" else None
        gt.build_flat_index(keys, corpus, pq_config=cfg, mesh=mesh, device="cpu")
    assert seen and set(seen) == {"highest"}


@pytest.mark.parametrize("kind", ["flat", "ivf", "flat-mesh"])
def test_builds_encode_at_the_configured_precision(corpus, monkeypatch, kind):
    """``PQConfig.encode_precision`` reaches every build's encode,
    single-device and over a mesh, apart from the training's precision."""
    import gulon_tpu_torch as gt
    from gulon_tpu_torch.parallel import make_mesh

    seen = []
    assign = tpq._assign_blocked
    monkeypatch.setattr(tpq, "_assign_blocked",
                        lambda *a: seen.append(a[3]) or assign(*a))
    keys = np.array([f"k{i:05d}" for i in range(len(corpus))], dtype=object)
    cfg = gt.PQConfig(num_clusters=16, num_quantizers=4, max_iters=3,
                      precision="highest", encode_precision="default")
    if kind == "ivf":
        gt.build_ivf_index(keys, corpus, pq_config=cfg, num_partitions=8,
                           coarse_max_iters=3, device="cpu")
    else:
        mesh = make_mesh(devices=["cpu"] * 2) if kind == "flat-mesh" else None
        gt.build_flat_index(keys, corpus, pq_config=cfg, mesh=mesh, device="cpu")
    assert seen and set(seen) == {"default"}
