"""Two processes of the port's sharded layer on localhost (gloo, CPU).

The counterpart of ``tests/test_distributed.py`` for the port: two worker
processes join one ``torch.distributed`` group through
``parallel.distributed_init``, each holds four logical CPU shards of an
eight-shard mesh, and every one of them holds the same full host corpus
and keeps only its own shards. Across both ranks they serve a
``ShardedFlatIndex`` and a ``ShardedIVFIndex`` (masked, fused-kernel and
bucketed scans: per-shard work, then the merge through ``all_gather``),
encode over the mesh and train k-means over it (partial sums through
``all_reduce``). Each rank writes what it got; the test holds both to one
process's eight-shard mesh over the same corpus: ids equal, distances
within 1e-5, codes equal, k-means centroids within 1e-5 (the cross-process sum adds
the two ranks' partials in another order).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from gulon_tpu_torch import parallel as tpar

torch.set_num_threads(2)

_WORKER = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(2)
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import gulon_tpu_torch as gt
from gulon_tpu_torch import parallel as tpar
from gulon_tpu_torch.parallel import ops as tops

tpar.distributed_init(devices=["cpu"], init_method=f"tcp://127.0.0.1:{port}",
                      world_size=2, rank=rank)
mesh = tpar.make_mesh(devices=["cpu"] * 4)
assert mesh.shape == {"rows": 8, "sub": 1} and mesh.group is not None
assert mesh.local_rows == [4 * rank + i for i in range(4)]
from corpus import corpus
keys, x, q = corpus()
results = {}
flat = gt.build_flat_index(keys, x, pq_config=gt.PQConfig(
    num_clusters=16, num_quantizers=4, max_iters=6), device="cpu")
sh = tpar.shard_index(flat, mesh)
assert sum(c is not None for c in sh.codes_sharded) == 4
results["flat"] = sh.query_arrays(5, q)
flat.scan_strategy = "decode"
results["flat_decode"] = tpar.shard_index(flat, mesh).query_arrays(5, q)
ivf = gt.build_ivf_index(keys, x, pq_config=gt.PQConfig(
    num_clusters=16, num_quantizers=4, max_iters=6), num_partitions=12,
    strategy=gt.LimitGroups(4), coarse_max_iters=6, device="cpu")
for s in ("masked", "pallas", "bucketed"):
    ivf.scan_strategy = s
    results["ivf_" + s] = tpar.shard_index(ivf, mesh).query_arrays(5, q)
codes = tops.sharded_encode(flat.pq, x, mesh, chunk=700)
km = tpar.sharded_fit_kmeans(x, gt.KMeansConfig(k=10, max_iters=8, seed=1), mesh)
arrays = {f"{name}_{i}": t.numpy() for name, pair in results.items()
          for i, t in enumerate(pair)}
np.savez(out, codes=codes, km_c=km.centroids.numpy(), km_a=km.assignments.numpy(),
         **arrays)
print(f"rank {rank} OK")
"""

_CORPUS = r"""
import numpy as np


def corpus():
    rng = np.random.default_rng(7)
    cents = rng.normal(0, 1, (10, 16)).astype(np.float32)
    lab = rng.integers(0, 10, 3001)
    x = (cents[lab] + rng.normal(0, 0.08, (3001, 16))).astype(np.float32)
    keys = np.array([f"w{i:05d}" for i in range(3001)], dtype=object)
    q = (x[:16] + rng.normal(0, 0.01, (16, 16))).astype(np.float32)
    return keys, x, q
"""


def _single_process(tmp_path):
    """The same work on one process's eight-shard CPU mesh."""
    sys.path.insert(0, str(tmp_path))
    try:
        from corpus import corpus
    finally:
        sys.path.remove(str(tmp_path))
    import gulon_tpu_torch as gt
    from gulon_tpu_torch.parallel import ops as tops

    keys, x, q = corpus()
    mesh = tpar.make_mesh(devices=["cpu"] * 8)
    want = {}
    flat = gt.build_flat_index(keys, x, pq_config=gt.PQConfig(
        num_clusters=16, num_quantizers=4, max_iters=6), device="cpu")
    want["flat"] = tpar.shard_index(flat, mesh).query_arrays(5, q)
    flat.scan_strategy = "decode"
    want["flat_decode"] = tpar.shard_index(flat, mesh).query_arrays(5, q)
    ivf = gt.build_ivf_index(keys, x, pq_config=gt.PQConfig(
        num_clusters=16, num_quantizers=4, max_iters=6), num_partitions=12,
        strategy=gt.LimitGroups(4), coarse_max_iters=6, device="cpu")
    for s in ("masked", "pallas", "bucketed"):
        ivf.scan_strategy = s
        want["ivf_" + s] = tpar.shard_index(ivf, mesh).query_arrays(5, q)
    codes = tops.sharded_encode(flat.pq, x, mesh, chunk=700)
    km = tpar.sharded_fit_kmeans(x, gt.KMeansConfig(k=10, max_iters=8, seed=1), mesh)
    return want, codes, km


def test_two_process_sharded_serving_and_builds(tmp_path):
    (tmp_path / "worker.py").write_text(_WORKER)
    (tmp_path / "corpus.py").write_text(_CORPUS)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, str(tmp_path)]))
    procs = [
        subprocess.Popen(
            [sys.executable, str(tmp_path / "worker.py"), str(r), str(port),
             str(tmp_path / f"rank{r}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r} OK" in out, out

    want, codes, km = _single_process(tmp_path)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for name, (d, ids) in want.items():
            np.testing.assert_array_equal(got[f"{name}_1"], ids.numpy(), err_msg=name)
            np.testing.assert_allclose(got[f"{name}_0"], d.numpy(), atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(got["codes"], codes)
        np.testing.assert_allclose(got["km_c"], km.centroids.numpy(), atol=1e-5)
        assert np.mean(got["km_a"] == km.assignments.numpy()) >= 0.999
