"""Shared helpers for incremental index updates (``Index.add`` /
``Index.remove``).

The reference has no update story — an index is built once from a word2vec
file (``BuildIndex.scala:110-121``) and never changes. For production
serving that forces full rebuilds on every corpus change, so the rebuild
adds functional updates as an extra: ``add(keys, vectors)`` encodes new
rows with the *existing* (frozen) codebooks and returns a NEW index;
``remove(keys)`` masks rows out. Both are pure functions of the index —
no mutation, as in the JAX package — and both invalidate the
lazily-built serving layouts so they rebuild on first query.

Frozen-codebook adds are the standard PQ trade: quantization error for
rows far from the training distribution degrades gracefully, and callers
re-train (rebuild) when drift accumulates. A copy of the helpers of
``gulon_tpu/models/update.py`` that the port's indices use.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def validate_add(keys, vectors, dimension: int) -> Tuple[np.ndarray, np.ndarray]:
    """Common ``add()`` argument validation -> (object keys, f32 rows)."""
    x = np.asarray(vectors, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    keys_arr = np.asarray(keys, dtype=object)
    if keys_arr.ndim == 0:
        keys_arr = keys_arr[None]
    if x.ndim != 2 or x.shape[1] != dimension:
        raise ValueError(
            f"vectors must be [n, {dimension}], got {np.shape(vectors)}"
        )
    if len(keys_arr) != len(x):
        raise ValueError(
            f"keys and vectors must have equal length, got "
            f"{len(keys_arr)} vs {len(x)}"
        )
    if len(keys_arr) == 0:
        raise ValueError("add() needs at least one row")
    return keys_arr, x


def removal_mask(index_keys: np.ndarray, keys) -> np.ndarray:
    """Boolean keep-mask over ``index_keys`` with every row whose key is in
    ``keys`` dropped (all occurrences, if the index holds duplicates).

    Raises ``KeyError`` listing requested keys not present, and
    ``ValueError`` if the removal would empty the index (an empty corpus
    has no meaningful scan; rebuild instead).
    """
    keys_arr = np.asarray(keys, dtype=object)
    if keys_arr.ndim == 0:  # a single string key, like add()'s scalar path
        keys_arr = keys_arr[None]
    req = np.asarray(list(dict.fromkeys(keys_arr)), dtype=object)
    if len(req) == 0:
        raise ValueError("remove() needs at least one key")
    # set membership: np.isin sorts object arrays (4 s at 400,000 keys)
    wanted = set(req.tolist())
    drop = np.fromiter(
        (k in wanted for k in index_keys), dtype=bool, count=len(index_keys)
    )
    present = set(index_keys[drop].tolist())
    missing: List[str] = [k for k in req.tolist() if k not in present]
    if missing:
        raise KeyError(f"keys not in index: {missing[:10]}")
    keep = ~drop
    if not keep.any():
        raise ValueError("remove() would leave an empty index")
    return keep


def merge_sorted_order(
    old_keys: np.ndarray, new_keys: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Globally-sorted merge order -> (merged keys, int permutation over
    ``concat(old, new)``). Stable, so equal keys keep old-then-new order
    (the builder's ``argsort(kind="stable")`` semantics)."""
    all_keys = np.concatenate([old_keys, new_keys])
    order = np.argsort(all_keys, kind="stable")
    return all_keys[order], order


def merge_grouped_order(
    old_gids: np.ndarray,
    old_keys: np.ndarray,
    new_gids: np.ndarray,
    new_keys: np.ndarray,
    num_groups: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stable (group, key) merge for grouped indices.

    Returns ``(keys, gids, internal group offsets, permutation)`` over
    ``concat(old, new)`` — the row order the sublinear builder produces
    (``WordVectors.scala:24-58``: stable sort by (cluster, word)), with
    offsets recomputed from group counts. Groups may be empty after
    removals; centroids are kept so group ids stay stable.
    """
    all_gids = np.concatenate(
        [np.asarray(old_gids), np.asarray(new_gids)]
    ).astype(np.int32)
    all_keys = np.concatenate([old_keys, new_keys])
    # two-pass stable sort == lexsort by (gid major, key minor); np.lexsort
    # does not accept object-dtype keys, argsort(kind="stable") does
    o1 = np.argsort(all_keys, kind="stable")
    o2 = np.argsort(all_gids[o1], kind="stable")
    order = o1[o2]
    gids = all_gids[order]
    counts = np.bincount(gids, minlength=num_groups)
    offsets = np.cumsum(counts)[:-1].astype(np.int32)
    return all_keys[order], gids, offsets, order
