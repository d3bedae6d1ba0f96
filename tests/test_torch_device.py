"""The port's entry points put their tensors on the CUDA card unless the
caller names another device, and never fall back to the CPU: without a
card a default call raises, as ``torch`` does when a tensor moves to
``cuda``; with one, what it returns lives there. Every other CPU test
passes ``device="cpu"``."""

import inspect

import numpy as np
import pytest
import torch

import gulon_tpu_torch as gt
from gulon_tpu_torch.models.exact import ExactIndex
from gulon_tpu_torch.ops import kmeans as tkm
from gulon_tpu_torch.ops import pq as tpq
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE

N, D = 600, 8
PQ = gt.PQConfig(num_clusters=4, num_quantizers=2, max_iters=2)
KM = tkm.KMeansConfig(k=4, max_iters=2)

ENTRY_POINTS = (
    gt.build_flat_index,
    gt.build_ivf_index,
    gt.build_exact_index,
    ExactIndex.load,
    gt.flat_index_from_numpy,
    gt.ivf_index_from_numpy,
    gt.exact_index_from_numpy,
    gt.from_reference,
    gt.ground_truth_for_queries,
    gt.sample_ground_truth,
)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    keys = np.array([f"k{i:04d}" for i in range(N)], dtype=object)
    return x, keys


@pytest.fixture(scope="module")
def cpu_indices(corpus):
    x, keys = corpus
    flat = gt.build_flat_index(keys, x, pq_config=PQ, device="cpu")
    ivf = gt.build_ivf_index(
        keys, x, pq_config=PQ, num_partitions=3, coarse_max_iters=2, device="cpu"
    )
    exact = gt.build_exact_index(keys, x, device="cpu")
    return flat, ivf, exact


def _default_calls(x, keys, flat, ivf, exact, path):
    """One call of each entry point (and of ``train_product_quantizer`` and
    ``fit_kmeans`` on host input) with no ``device`` argument."""
    exact.save(path)
    pq = flat.pq
    return {
        "build_flat_index": lambda: gt.build_flat_index(keys, x, pq_config=PQ),
        "build_ivf_index": lambda: gt.build_ivf_index(
            keys, x, pq_config=PQ, num_partitions=3, coarse_max_iters=2
        ),
        "build_exact_index": lambda: gt.build_exact_index(keys, x),
        "ExactIndex.load": lambda: ExactIndex.load(path),
        "flat_index_from_numpy": lambda: gt.flat_index_from_numpy(
            flat.key_index.keys, pq.codebooks.numpy(), pq.bounds, pq.num_clusters,
            flat.codes.numpy(), flat.recon_norms.numpy(),
        ),
        "ivf_index_from_numpy": lambda: gt.ivf_index_from_numpy(
            ivf.key_index.keys, ivf.key_index.group_offsets, ivf.pq.codebooks.numpy(),
            ivf.pq.bounds, ivf.pq.num_clusters, ivf.codes.numpy(), ivf.row_const.numpy(),
            ivf.group_ids.numpy(), ivf.centroids.numpy(),
        ),
        "exact_index_from_numpy": lambda: gt.exact_index_from_numpy(keys, x),
        # a port index has the arrays and knobs the adapter reads
        "from_reference": lambda: gt.from_reference(exact),
        "ground_truth_for_queries": lambda: gt.ground_truth_for_queries(x[:4], x, ks=(1,)),
        "sample_ground_truth": lambda: gt.sample_ground_truth(keys, x, num_samples=4, ks=(1,)),
        "train_product_quantizer": lambda: tpq.train_product_quantizer(x, PQ),
        "fit_kmeans": lambda: tkm.fit_kmeans(x, KM).centroids,
    }


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_device_defaults_to_cuda(fn):
    assert DEFAULT_DEVICE == torch.device("cuda")
    assert inspect.signature(fn).parameters["device"].default == torch.device("cuda")


def test_train_product_quantizer_keeps_tensor_input_in_place():
    """``device=None`` means the card for host input and the input's own
    device for a tensor."""
    assert inspect.signature(tpq.train_product_quantizer).parameters["device"].default is None
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(N, D)).astype(np.float32))
    assert tpq.train_product_quantizer(x, PQ).device == torch.device("cpu")


def test_fit_kmeans_keeps_tensor_input_in_place():
    """The same rule for k-means: the card for host input, the input's own
    device for a tensor."""
    assert inspect.signature(tkm.fit_kmeans).parameters["device"].default is None
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(N, D)).astype(np.float32))
    res = tkm.fit_kmeans(x, KM)
    assert res.centroids.device == res.assignments.device == torch.device("cpu")


@pytest.mark.parametrize("name", [
    "build_flat_index", "build_ivf_index", "build_exact_index", "ExactIndex.load",
    "flat_index_from_numpy", "ivf_index_from_numpy", "exact_index_from_numpy",
    "from_reference", "ground_truth_for_queries", "sample_ground_truth",
    "train_product_quantizer", "fit_kmeans",
])
def test_default_call_goes_to_the_card(name, corpus, cpu_indices, tmp_path):
    """Without a card a default call raises; it never builds on the CPU.
    With one, what it returns lives on the card."""
    x, keys = corpus
    call = _default_calls(x, keys, *cpu_indices, tmp_path / "exact.npz")[name]
    if not torch.cuda.is_available():
        # a CPU-only torch asserts it was built without CUDA; a CUDA
        # build on a machine without a card raises a RuntimeError
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA|cuda"):
            call()
        return
    got = call()
    device = getattr(got, "device", None)  # ground truth is host arrays
    assert device is None or device.type == "cuda"
