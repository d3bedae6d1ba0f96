"""Probe-limit auto-tuning for partitioned indices (counterpart of
``gulon_tpu/utils/tune.py``).

Given a recall target, find the smallest IVF probe limit that meets it on
sampled self-queries, with the reference's distance-cutoff recall
protocol (``Tests.scala:22-40``, ``utils/eval.py``). Recall does not fall
as the limit grows (probing more partitions only adds candidates), so a
binary search needs ``O(log P)`` recall sweeps. The ground truth runs on
the index's device.

Returns a new index with the tuned strategy; the lazy serving layouts
are shared with the input index (they do not depend on the strategy).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from gulon_tpu_torch.models.ivf import IVFIndex, LimitGroups, LimitVectors
from gulon_tpu_torch.utils.eval import recall_of, sample_ground_truth


@dataclasses.dataclass(frozen=True)
class TuneResult:
    index: IVFIndex          # strategy replaced with the tuned limit
    limit: int               # the chosen probe limit
    achieved_recall: float   # measured recall@k at the chosen limit
    target_recall: float
    k: int
    evaluations: int         # recall sweeps the search spent
    met: bool                # False: even the maximum limit fell short


def tune_probe_limit(
    index: IVFIndex,
    vectors,
    keys: Sequence[str],
    *,
    target_recall: float = 0.9,
    k: int = 10,
    num_samples: int = 256,
    seed: int = 0,
    epsilon: float = 0.0,
    report_fn: Optional[Callable[[int, int, float], None]] = None,
) -> TuneResult:
    """Binary-search the smallest probe limit meeting ``target_recall``.

    ``vectors``/``keys`` are the original corpus (the recall protocol needs
    exact distances). ``LimitGroups`` tunes partitions probed (1..P),
    ``LimitVectors`` candidate rows covered (k..N).
    ``report_fn(limit, evals, recall)`` is called after each evaluation.
    """
    if not isinstance(index, IVFIndex):
        raise ValueError(
            f"tune_probe_limit needs a partitioned (IVF) index, got "
            f"{type(index).__name__}"
        )
    if not 0.0 < target_recall <= 1.0:
        raise ValueError(f"target_recall must be in (0, 1], got {target_recall}")
    x = np.asarray(vectors, np.float32)
    keys = np.asarray(keys, dtype=object)
    if index.metric.normalized:
        norms = np.linalg.norm(x, axis=1, keepdims=True)
        x = np.where(norms > 0, x / np.where(norms > 0, norms, 1.0), x)
    truth = sample_ground_truth(
        keys, x, num_samples=num_samples, seed=seed, ks=(k,),
        device=index.device,
    )

    if isinstance(index.strategy, LimitVectors):
        lo, hi = k, index.size
        make = LimitVectors
    else:
        lo, hi = 1, index.num_partitions
        make = LimitGroups

    # build the strategy-independent lazy layouts once on the input index,
    # so every trial (a dataclasses.replace) shares them
    index.query_arrays(min(k, index.size), truth.queries[:1])

    evals = 0

    def recall_at(limit: int) -> float:
        nonlocal evals
        trial = dataclasses.replace(index, strategy=make(limit))
        per_k = recall_of(trial, truth, x, keys, epsilon=epsilon)
        evals += 1
        r = float(per_k[k].mean)
        if report_fn is not None:
            report_fn(limit, evals, r)
        return r

    r_hi = recall_at(hi)
    if r_hi < target_recall:
        # even exhaustive probing misses the target: the code budget, not
        # the probe limit, bounds recall; return the best, flagged
        return TuneResult(
            index=dataclasses.replace(index, strategy=make(hi)),
            limit=hi, achieved_recall=r_hi, target_recall=target_recall,
            k=k, evaluations=evals, met=False,
        )
    best, best_r = hi, r_hi
    while lo < hi:
        mid = (lo + hi) // 2
        r = recall_at(mid)
        if r >= target_recall:
            best, best_r = mid, r
            hi = mid
        else:
            lo = mid + 1
    return TuneResult(
        index=dataclasses.replace(index, strategy=make(best)),
        limit=best, achieved_recall=best_r, target_recall=target_recall,
        k=k, evaluations=evals, met=True,
    )
