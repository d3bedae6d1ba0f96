"""Recall@k evaluation harness (counterpart of ``gulon_tpu/utils/eval.py``,
reference ``Tests.scala``).

Ground truth samples queries from the indexed vectors themselves
(``Tests.scala:76-87``) and records, per k, the exact k-th-nearest
distance (``Tests.scala:89-97``), here through the port's ``exact_scan``
at full f32 on ``device`` (the CUDA card unless the caller names
another). Recall@k counts a returned neighbour iff its exact distance to
the query is within ``(sqrt(true_kth_dist_sq) * (1 + eps))^2``
(``Tests.scala:22-40``), which is robust to ties and duplicate vectors.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gulon_tpu_torch.models.index import Index
from gulon_tpu_torch.ops.stats import SummaryStats
from gulon_tpu_torch.ops.scan import exact_scan
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE

# ``Tests.scala:53``
DEFAULT_KS: Tuple[int, ...] = (1, 2, 3, 5, 10, 25, 50, 100, 500, 1000)


@dataclasses.dataclass(frozen=True)
class GroundTruth:
    """Sampled queries + their exact k-th-nearest squared distances."""

    queries: np.ndarray  # [Q, D] f32
    query_keys: np.ndarray  # [Q] object — the sampled words
    kth_distances: Dict[int, np.ndarray]  # k -> [Q] f32 squared L2
    ks: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class EvalProgress:
    """Mirrors ``Tests.ProgressReport`` (``Tests.scala:55-74``)."""

    completed: int
    total: int
    qps: float


def _normalized(vectors: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(vectors, axis=1, keepdims=True)
    safe = np.where(norms > 0, norms, 1.0)
    return np.where(norms > 0, vectors / safe, vectors)


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def ground_truth_for_queries(
    queries: np.ndarray,
    vectors: np.ndarray,
    ks: Sequence[int] = DEFAULT_KS,
    normalize: bool = False,
    query_keys: Optional[Sequence[str]] = None,
    *,
    device=DEFAULT_DEVICE,
) -> GroundTruth:
    """Ground truth for an explicit query set (``Tests.scala:100-107``).

    ``ks`` entries larger than the corpus are dropped; ``normalize``
    applies the Cosine transform to both sides. The exact scan runs on
    ``device``."""
    vectors = np.asarray(vectors, np.float32)
    queries = np.asarray(queries, np.float32)
    n = len(vectors)
    if normalize:
        vectors = _normalized(vectors)
        queries = _normalized(queries)
    ks = tuple(k for k in ks if k <= n)
    if not ks:
        raise ValueError("corpus smaller than every requested k")
    max_k = max(ks)
    _, ids = exact_scan(
        torch.as_tensor(queries, device=device),
        torch.as_tensor(vectors, device=device),
        k=max_k,
    )
    ids = _host(ids)
    # k-th distances recomputed in the direct sum((a-b)^2) form, so that a
    # duplicate vector sits at exactly 0, as in the reference's protocol
    kth = {
        k: ((vectors[ids[:, k - 1]] - queries) ** 2).sum(axis=1).astype(np.float32)
        for k in ks
    }
    if query_keys is None:
        query_keys = np.array(
            [f"query{i}" for i in range(len(queries))], dtype=object
        )
    return GroundTruth(
        queries=queries,
        query_keys=np.asarray(query_keys, dtype=object),
        kth_distances=kth,
        ks=ks,
    )


def sample_ground_truth(
    keys: Sequence[str],
    vectors: np.ndarray,
    num_samples: int = 1000,
    seed: int = 0,
    ks: Sequence[int] = DEFAULT_KS,
    normalize: bool = False,
    *,
    device=DEFAULT_DEVICE,
) -> GroundTruth:
    """Ground truth from self-queries (``Tests.sample``): ``num_samples``
    rows drawn without replacement with numpy's ``default_rng(seed)``,
    the JAX package's draw."""
    vectors = np.asarray(vectors, np.float32)
    keys = np.asarray(keys, dtype=object)
    n = len(vectors)
    if normalize:
        vectors = _normalized(vectors)
    rng = np.random.default_rng(seed)
    num_samples = min(num_samples, n)
    idx = rng.choice(n, size=num_samples, replace=False)
    return ground_truth_for_queries(
        vectors[idx], vectors, ks=ks, normalize=False, query_keys=keys[idx],
        device=device,
    )


def recall_of(
    index: Index,
    truth: GroundTruth,
    true_vectors: np.ndarray,
    true_keys: Sequence[str],
    epsilon: float = 0.0,
    report_fn: Optional[Callable[[EvalProgress], None]] = None,
    batch_size: int = 256,
) -> Dict[int, SummaryStats]:
    """Recall@k of ``index`` against ``truth`` (``Tests#recallOf``).

    ``true_vectors``/``true_keys`` are the exact source vectors (for a
    Cosine index, the normalized ones)."""
    true_vectors = np.asarray(true_vectors, np.float32)
    max_k = max(truth.ks)
    q_total = len(truth.queries)
    per_k: Dict[int, SummaryStats] = {k: SummaryStats() for k in truth.ks}

    key_to_row = {k: i for i, k in enumerate(true_keys)}
    index_keys = np.asarray(index.key_index.keys, dtype=object)
    try:
        idx_to_eval = np.fromiter(
            (key_to_row[w] for w in index_keys), np.int64, count=len(index_keys)
        )
    except KeyError as e:
        raise ValueError(
            f"index contains key {e.args[0]!r} that is not present "
            "in the evaluation vectors — the index was built from a "
            "different corpus than --vectors"
        ) from None

    start = time.monotonic()
    done = 0
    d = true_vectors.shape[1]
    sub = max(1, int(2e7) // max(max_k * d, 1))
    for b0 in range(0, q_total, batch_size):
        qb = truth.queries[b0 : b0 + batch_size]
        _, ids = index.query_arrays(max_k, qb)
        ids = _host(ids)
        for s0 in range(0, len(qb), sub):
            qs = qb[s0 : s0 + sub]
            ids_s = ids[s0 : s0 + sub]
            nq = len(qs)
            valid = ids_s >= 0  # -1 = padding (k wider than coverage)
            rows = idx_to_eval[np.where(valid, ids_s, 0)]
            diffs = (
                true_vectors[rows.reshape(-1)].reshape(nq, max_k, d)
                - qs[:, None, :]
            )
            exact = np.where(valid, (diffs ** 2).sum(axis=2), np.inf)
            for k in truth.ks:
                true_kth = truth.kth_distances[k][b0 + s0 : b0 + s0 + nq]
                # cutoff = (sqrt(d_k) * (1+eps))^2  (``Tests.scala:33-35``)
                cutoff = true_kth * (1.0 + epsilon) ** 2
                hits = (exact[:, :k] <= cutoff[:, None]).sum(axis=1)
                per_k[k] = per_k[k] + SummaryStats.of(hits / k)
        done += len(qb)
        if report_fn is not None:
            elapsed = max(time.monotonic() - start, 1e-9)
            report_fn(EvalProgress(done, q_total, done / elapsed))
    return per_k


def format_recall(per_k: Dict[int, SummaryStats]) -> str:
    """``R@k: mean +/- stdDev`` lines (``Test.scala:39-43``)."""
    return "\n".join(
        f"R@{k}: {per_k[k].mean:.4f} +/- {per_k[k].stddev:.4f}"
        for k in sorted(per_k)
    )
