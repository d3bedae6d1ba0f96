"""Port parity: ``add`` / ``remove`` on the flat and IVF indices
(``gulon_tpu_torch/models/flat.py``, ``models/ivf.py``) against the JAX
package on the same ``from_reference`` index.

After ``add`` and after ``remove`` both packages hold the same keys in
the same order, the same codes and group ids, and derived arrays within
f32 summation order; queries return the same ids on the plain route and
on the fused route (the Pallas kernel in interpret mode there, K1's
plain twin here). The fused query after ``add`` runs on an index whose
kernel operand was built before the add, so a stale operand (the old
rows) would show. Rotated (OPQ) and cosine indices rotate and normalize
new rows as the JAX package does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from generators import random_keys
from gulon_tpu.models import ivf as jivf
from gulon_tpu.models.build import build_flat_index as jax_build_flat
from gulon_tpu.models.build import build_ivf_index as jax_build_ivf
from gulon_tpu.models.metric import Metric as JaxMetric
from gulon_tpu.ops.pq import PQConfig as JaxPQConfig
from gulon_tpu_torch import interop

torch.set_num_threads(2)

N, D = 2000, 16
PQ = JaxPQConfig(num_clusters=32, num_quantizers=8, max_iters=6)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    x = rng.normal(size=(N + 300, D)).astype(np.float32)
    keys = random_keys(rng, N + 300)
    rot, _ = np.linalg.qr(rng.normal(size=(D, D)))
    return x, keys, rot.astype(np.float32)


@pytest.fixture(scope="module")
def jax_indices(data):
    x, keys, rot = data
    flat = jax_build_flat(keys[:N], x[:N], pq_config=PQ)
    cosine = jax_build_flat(keys[:N], x[:N], metric=JaxMetric.COSINE, pq_config=PQ)
    ivf = jax_build_ivf(
        keys[:N], x[:N], pq_config=PQ, num_partitions=8,
        strategy=jivf.LimitGroups(3), coarse_max_iters=6,
    )
    return {
        "flat": flat,
        "flat_cosine": cosine,
        "flat_rotated": dataclasses.replace(flat, rotation=rot),
        "ivf": ivf,
        "ivf_rotated": dataclasses.replace(ivf, rotation=rot),
    }


def _is_ivf(index):
    return hasattr(index, "centroids")


# k = 5 keeps the flat fused route inside the kernel's n >= 256 k envelope
K = 5


def _ids_jax(index, q, strategy):
    return np.asarray(dataclasses.replace(index, scan_strategy=strategy).query_arrays(K, q)[1])


def _ids_port(index, q, strategy):
    return dataclasses.replace(index, scan_strategy=strategy).query_arrays(K, q)[1].numpy()


def _warm_fused(port, x):
    """Build the fused route's lazy kernel operand on the old rows."""
    port.scan_strategy = "pallas"
    port.query_arrays(K, x[:8])
    assert port._k1_operands
    assert not _is_ivf(port) or port._pallas_layout is not None


def _same_rows(port, jx):
    assert list(port.key_index.keys) == list(jx.key_index.keys)
    np.testing.assert_array_equal(port.codes.numpy(), np.asarray(jx.codes))
    if _is_ivf(jx):
        np.testing.assert_array_equal(port.group_ids.numpy(), np.asarray(jx.group_ids))
        np.testing.assert_array_equal(
            port.key_index.group_offsets, np.asarray(jx.key_index.group_offsets)
        )
        np.testing.assert_allclose(
            port.row_const.numpy(), np.asarray(jx.row_const), rtol=1e-5, atol=1e-5
        )
    else:
        np.testing.assert_allclose(
            port.recon_norms.numpy(), np.asarray(jx.recon_norms), rtol=1e-5, atol=1e-5
        )


KINDS = ["flat", "flat_cosine", "flat_rotated", "ivf", "ivf_rotated"]


@pytest.mark.parametrize("kind", KINDS)
def test_add_matches_jax(jax_indices, data, kind):
    x, keys, _ = data
    jx = jax_indices[kind]
    port = interop.from_reference(jx, device="cpu")
    _warm_fused(port, x)
    new_keys, new_x = keys[N:], x[N:]
    jadd = jx.add(new_keys, new_x)
    padd = port.add(new_keys, new_x)
    assert padd.size == N + 300 and padd.scan_strategy == "pallas"
    _same_rows(padd, jadd)
    q = np.concatenate([new_x[:12], x[:12]]) + 0.01
    plain = "masked" if _is_ivf(jx) else "decode"
    for strategy in (plain, "pallas"):
        np.testing.assert_array_equal(_ids_port(padd, q, strategy), _ids_jax(jadd, q, strategy))
    # every added key finds itself
    got = padd.batch_query(1, new_x[:50])
    assert [r.keys[0] for r in got] == list(new_keys[:50])


@pytest.mark.parametrize("kind", KINDS)
def test_remove_matches_jax(jax_indices, data, kind):
    x, keys, _ = data
    jx = jax_indices[kind]
    port = interop.from_reference(jx, device="cpu")
    _warm_fused(port, x)
    gone = list(keys[:40]) + list(keys[500:540])
    jrm = jx.remove(gone)
    prm = port.remove(gone)
    _same_rows(prm, jrm)
    q = x[:16] + 0.01
    plain = "masked" if _is_ivf(jx) else "decode"
    for strategy in (plain, "pallas"):
        ids = _ids_port(prm, q, strategy)
        np.testing.assert_array_equal(ids, _ids_jax(jrm, q, strategy))
        found = set(np.asarray(prm.key_index.keys, object)[ids[ids >= 0]])
        assert not found & set(gone)


def test_lazy_operands_start_clear(jax_indices, data):
    """A new index holds none of the old rows' lazy operands."""
    x, keys, _ = data
    flat = interop.from_reference(jax_indices["flat"], device="cpu")
    _warm_fused(flat, x)
    flat.enable_cache()
    flat._code_duplication()
    for new in (flat.add(keys[N:N + 2], x[N:N + 2]), flat.remove([keys[0]])):
        assert new._k1_operands is None and new._cache_aug is None
        assert new.decoded_cache is None and new._auto_dup is None
        assert new._auto_rerank is None
    ivf = interop.from_reference(jax_indices["ivf"], device="cpu")
    for strategy in ("pallas", "gathered"):
        ivf.scan_strategy = strategy
        ivf.query_arrays(10, x[:8])
    ivf.enable_cache()
    for new in (ivf.add(keys[N:N + 2], x[N:N + 2]), ivf.remove([keys[0]])):
        assert new._pallas_layout is None and new._codes_pad is None
        assert new._k1_operands is None
        assert new._row_const_pad is None and new._sizes_dev is None
        assert new.recon_cache is None and new.recon_norms_cache is None


def test_update_errors(jax_indices, data):
    x, keys, _ = data
    port = interop.from_reference(jax_indices["ivf"], device="cpu")
    with pytest.raises(KeyError):
        port.remove(["not-a-key"])
    with pytest.raises(ValueError):
        port.add(keys[:2], x[:2, :3])
    with pytest.raises(ValueError):
        port.remove(list(port.key_index.keys))
    emptied = port.remove(list(port.key_index.keys[: port.partition_sizes()[0]]))
    assert emptied.partition_sizes()[0] == 0
    assert emptied.num_partitions == port.num_partitions
    assert emptied.query_arrays(5, x[:4])[1].shape == (4, 5)
