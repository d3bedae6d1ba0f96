"""Sharded serving and mesh builds (counterpart of ``gulon_tpu/parallel``):
a :class:`~gulon_tpu_torch.parallel.mesh.Mesh` of devices, per-shard
scans with a top-k merge, sharded index classes and distributed k-means.
"""

from gulon_tpu_torch.parallel.mesh import (
    ROWS,
    SUB,
    distributed_init,
    make_mesh,
    replicate,
    shard_rows,
)
from gulon_tpu_torch.parallel.ops import (
    sharded_adc_scan,
    sharded_exact_scan,
    sharded_fit_kmeans,
)
from gulon_tpu_torch.parallel.index import (
    ShardedExactIndex,
    ShardedFlatIndex,
    ShardedIVFIndex,
    shard_index,
)

__all__ = [
    "ROWS",
    "SUB",
    "distributed_init",
    "make_mesh",
    "replicate",
    "shard_rows",
    "sharded_adc_scan",
    "sharded_exact_scan",
    "sharded_fit_kmeans",
    "ShardedExactIndex",
    "ShardedFlatIndex",
    "ShardedIVFIndex",
    "shard_index",
]
