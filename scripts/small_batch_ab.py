#!/usr/bin/env python3
"""Host ms of the selection-heavy query paths of one checkout of the port,
for holding two commits against each other on one card.

The paths: an IVF index of 300,000 x 96 standard-normal rows (PQ 12 x
256, 300 partitions, ``LimitGroups(15)``) queried with 1 query through
``gathered``, 8 through ``bucketed`` and 64 through ``masked``, and a flat
index of 400,000 x 100 rows (PQ 8 x 256) queried with 1024 queries
through ``auto`` (K1 and its epilogue on the card). Each path: 3 warm-up
calls, then 30 (flat: 20) timed ones, host clock around ``query_arrays``
ending in ``torch.cuda.synchronize()``. Prints one JSON line: each path's
25th, 50th and 75th percentile ms, and the flat strategy that ran.

Run from the root of a checkout with the directory whose
``gulon_tpu_torch`` is to be timed: unpack the other commit with ``git
archive <commit> | tar -x -C DIR`` into a git-ignored directory, then
``for r in DIR . . DIR; do python3 scripts/small_batch_ab.py $r; done``
(in turns, in one call on one card). ``--cpu`` runs it on the CPU at
20,000 rows (no timings of the card).
"""

import dataclasses
import json
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import gulon_tpu_torch as gt  # noqa: E402

if not gt.__file__.startswith(root):
    raise SystemExit(f"imported {gt.__file__}, not the package under {root}")
cpu = "--cpu" in sys.argv
kw = dict(device="cpu") if cpu else {}


def sync():
    if not cpu:
        torch.cuda.synchronize()


def timed(fn, reps):
    for _ in range(3):
        fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    return [round(float(np.percentile(ts, p)), 4) for p in (25, 50, 75)]


rng = np.random.default_rng(0)
n, d = (20_000 if cpu else 300_000), 96
x = rng.normal(size=(n, d)).astype(np.float32)
keys = np.array([f"w{i}" for i in range(n)], dtype=object)
ivf = gt.build_ivf_index(keys, x, pq_config=gt.PQConfig(num_clusters=256, num_quantizers=12,
                                                        max_iters=4),
                         num_partitions=300, strategy=gt.LimitGroups(15), **kw)
q = x[:64] + 0.05 * rng.normal(size=(64, d)).astype(np.float32)
out = {"root": os.path.basename(root)}
for label, batch, strategy in (("g1", 1, "gathered"), ("b8", 8, "bucketed"),
                               ("m64", 64, "masked")):
    index = dataclasses.replace(ivf, scan_strategy=strategy)
    out[label] = timed(lambda: index.query_arrays(10, q[:batch]), 30)

flat_x = rng.normal(size=(20_000 if cpu else 400_000, 100)).astype(np.float32)
flat = gt.build_flat_index(np.array([f"f{i}" for i in range(len(flat_x))], dtype=object),
                           flat_x, pq_config=gt.PQConfig(num_clusters=256, num_quantizers=8,
                                                         max_iters=4), **kw)
fq = flat_x[:1024] + 0.05 * rng.normal(size=(1024, 100)).astype(np.float32)
out["flat1024"] = timed(lambda: flat.query_arrays(10, fq), 20)
out["flat_strategy"] = flat.resolve_strategy(1024, 10)
print(json.dumps(out), flush=True)
