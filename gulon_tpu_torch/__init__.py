"""gulon_tpu_torch — the PyTorch / CUDA port of ``gulon_tpu``.

The same product-quantization ANN engine, written for an NVIDIA Hopper
GPU: plain tensor code in PyTorch, and the scan kernels written by hand
in CUDA C++ (``csrc/adc_scan.cu``, ``csrc/dense_scan.cu``, built with
``nvcc`` at first use). The JAX package beside it is the reference the
port is tested against; this package imports ``torch`` and never
``jax``. Its modules mirror ``gulon_tpu``'s layout (``ops/``, ``ops/cuda/`` for
``ops/pallas/``, ``models/``, ``utils/``). It imports nothing of
``gulon_tpu``: the host-side numpy modules it needs (``Index``/``Result``,
key indices, ``Metric``, the update helpers, ``SummaryStats``,
``WordVectors``) are its own copies.

Ported so far: the flat main path (build a flat PQ index, answer batched
top-k queries through the fused scan, measure recall), the flat
``cached`` strategy, the exact brute-force index, the IVF residual index
(build, probe strategies, all four scan strategies, probe-limit tuning),
``add``/``remove`` on every index, OPQ rotations and k-means++ seeding,
the reference's protobuf index files (``utils/serde.py``, read and
written without the protobuf library), the word2vec readers and writers,
the command line (``python -m gulon_tpu_torch.cli``) and the line server
(``server.py``), streaming builds from a word2vec text file
(``models/streaming.py``), packed 2- and 4-bit codes
(``FlatIndex.pack_memory``) and ahead-of-time serving plans
(``utils/aot.py``): every name ``gulon_tpu`` exports. Still to come:
sharded serving (``gulon_tpu/parallel``).
"""

__version__ = "0.1.0"

_EXPORTS = {
    "SummaryStats": "gulon_tpu_torch.ops.stats",
    "KMeansConfig": "gulon_tpu_torch.ops.kmeans",
    "fit_kmeans": "gulon_tpu_torch.ops.kmeans",
    "PQConfig": "gulon_tpu_torch.ops.pq",
    "ProductQuantizer": "gulon_tpu_torch.ops.pq",
    "train_product_quantizer": "gulon_tpu_torch.ops.pq",
    "Metric": "gulon_tpu_torch.models.metric",
    "Index": "gulon_tpu_torch.models.index",
    "Result": "gulon_tpu_torch.models.index",
    "FlatIndex": "gulon_tpu_torch.models.flat",
    "build_flat_index": "gulon_tpu_torch.models.build",
    "ExactIndex": "gulon_tpu_torch.models.exact",
    "build_exact_index": "gulon_tpu_torch.models.exact",
    "IVFIndex": "gulon_tpu_torch.models.ivf",
    "LimitGroups": "gulon_tpu_torch.models.ivf",
    "LimitVectors": "gulon_tpu_torch.models.ivf",
    "build_ivf_index": "gulon_tpu_torch.models.build",
    "default_num_partitions": "gulon_tpu_torch.models.build",
    "default_limit": "gulon_tpu_torch.models.build",
    "ivf_index_from_numpy": "gulon_tpu_torch.interop",
    "tune_probe_limit": "gulon_tpu_torch.utils.tune",
    "TuneResult": "gulon_tpu_torch.utils.tune",
    "sample_ground_truth": "gulon_tpu_torch.utils.eval",
    "ground_truth_for_queries": "gulon_tpu_torch.utils.eval",
    "recall_of": "gulon_tpu_torch.utils.eval",
    "format_recall": "gulon_tpu_torch.utils.eval",
    "DEFAULT_KS": "gulon_tpu_torch.utils.eval",
    "flat_index_from_numpy": "gulon_tpu_torch.interop",
    "exact_index_from_numpy": "gulon_tpu_torch.interop",
    "from_reference": "gulon_tpu_torch.interop",
    "build_flat_index_streaming": "gulon_tpu_torch.models.streaming",
    "build_ivf_index_streaming": "gulon_tpu_torch.models.streaming",
    "Word2VecStream": "gulon_tpu_torch.utils.native",
    "export_serving": "gulon_tpu_torch.utils.aot",
    "save_serving": "gulon_tpu_torch.utils.aot",
    "load_serving": "gulon_tpu_torch.utils.aot",
    "AOTServing": "gulon_tpu_torch.utils.aot",
    "train_opq": "gulon_tpu_torch.ops.opq",
    "reconstruction_mse": "gulon_tpu_torch.ops.opq",
    "WordVectors": "gulon_tpu_torch.utils.word2vec",
    "read_word2vec": "gulon_tpu_torch.utils.word2vec",
    "read_word2vec_path": "gulon_tpu_torch.utils.word2vec",
    "write_word2vec": "gulon_tpu_torch.utils.word2vec",
    "read_word2vec_bin": "gulon_tpu_torch.utils.word2vec",
    "write_word2vec_bin": "gulon_tpu_torch.utils.word2vec",
    "sniff_word2vec_binary": "gulon_tpu_torch.utils.word2vec",
    "load_index": "gulon_tpu_torch.utils.serde",
    "save_index": "gulon_tpu_torch.utils.serde",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'gulon_tpu_torch' has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(module), name)


def __dir__():
    return __all__
