"""Port parity: index files (``gulon_tpu_torch/utils/serde.py``) and the
wire codec (``gulon_tpu_torch/proto/index_wire.py``), which needs no
protobuf library.

- The codec's bytes equal ``index_pb2``'s for the same flat, IVF and
  rotated indices, and for hand-built messages (negative int32s, empty
  and unknown fields); it reads packed float runs and skips unknown
  fields, as proto2 does; a missing required field raises.
- All 7 goldens of ``tests/golden`` load in the port with the JAX
  package's codes, codebooks, offsets and rotation, serve its ids on the
  decode route and on the fused route (K1's plain twin here, the Pallas
  kernel in interpret mode there), and re-save byte for byte.
- A file saved by either package serves id for id in the other.

Corpora are Gaussian, so rows have distinct codes and no equal-distance
ties.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from generators import random_keys
from gulon_tpu.models import ivf as jivf
from gulon_tpu.models.build import build_flat_index as jax_build_flat
from gulon_tpu.models.build import build_ivf_index as jax_build_ivf
from gulon_tpu.models.metric import Metric as JaxMetric
from gulon_tpu.ops.pq import PQConfig as JaxPQConfig
from gulon_tpu.proto import index_pb2 as pb
from gulon_tpu.utils import serde as jserde
from gulon_tpu_torch import interop
from gulon_tpu_torch.proto import index_wire as wire
from gulon_tpu_torch.utils import serde as tserde

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
GOLDENS = sorted(p.name for p in GOLDEN.glob("*.pb"))
N, D = 2000, 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    x = rng.normal(size=(N, D)).astype(np.float32)
    keys = random_keys(rng, N)
    q = x[:24] + 0.05 * rng.normal(size=(24, D)).astype(np.float32)
    rot, _ = np.linalg.qr(rng.normal(size=(D, D)))
    return x, keys, q, rot.astype(np.float32)


@pytest.fixture(scope="module")
def jax_indices(data):
    """Flat (L2, K=32), flat cosine at K=600 (10-bit codes), IVF with
    LimitGroups and LimitVectors, and rotated copies of flat and IVF."""
    x, keys, _, rot = data
    pq = JaxPQConfig(num_clusters=32, num_quantizers=8, max_iters=6)
    flat = jax_build_flat(keys, x, pq_config=pq)
    cos600 = jax_build_flat(
        keys, x, metric=JaxMetric.COSINE,
        pq_config=JaxPQConfig(num_clusters=600, num_quantizers=4, max_iters=3),
    )
    ivf = jax_build_ivf(
        keys, x, pq_config=pq, num_partitions=8, strategy=jivf.LimitGroups(3),
        coarse_max_iters=6,
    )
    return {
        "flat": flat,
        "flat_cosine_w10": cos600,
        "ivf_groups": ivf,
        "ivf_vectors": dataclasses.replace(ivf, strategy=jivf.LimitVectors(700)),
        "flat_rotated": dataclasses.replace(flat, rotation=rot),
        "ivf_rotated": dataclasses.replace(ivf, rotation=rot),
    }


KINDS = ["flat", "flat_cosine_w10", "ivf_groups", "ivf_vectors", "flat_rotated", "ivf_rotated"]


def _jax_ids(index, q, k, strategy):
    jx = dataclasses.replace(index, scan_strategy=strategy)
    return np.asarray(jx.query_arrays(k, q)[1])


def _port_ids(index, q, k, strategy):
    return dataclasses.replace(index, scan_strategy=strategy).query_arrays(k, q)[1].numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_equal_index_pb2(jax_indices, kind):
    jx = jax_indices[kind]
    port = interop.from_reference(jx, device="cpu")
    ref = jserde.index_to_proto(jx).SerializeToString()
    got = tserde.index_to_proto(port).encode()
    assert got == ref
    # and the codec reads back what protobuf writes, field for field
    back = wire.Index.decode(ref)
    assert back.encode() == ref


def test_wire_scalars_and_oneof_match_pb2():
    """Negative int32s (10-byte varints), empty repeated fields, an empty
    string, an empty codes blob and the grouped member of the oneof."""
    cb = [np.array([1.5, -2.0], np.float32), np.zeros(2, np.float32)]
    ours = wire.Index(grouped=wire.GroupedIndex(
        grouped_words=["", "b"],
        vector_index=wire.PQIndex(
            product_quantizer=wire.ProductQuantizer(
                num_clusters=-7,
                quantizers=[wire.Quantizer(start_index=0, dimension=2,
                                           centroids=[wire.FloatVector(c) for c in cb])],
            ),
            data=wire.EncodedMatrix(code_width=0, length=2, encodings=[b"", b"\x01"]),
        ),
        metric=wire.COSINE, offsets=[1, -1, 2 ** 31 - 1], strategy=wire.LIMIT_VECTORS,
        limit=-3,
    ))
    msg = pb.Index()
    g = msg.grouped
    g.grouped_words.extend(["", "b"])
    g.vector_index.product_quantizer.num_clusters = -7
    qz = g.vector_index.product_quantizer.quantizers.add()
    qz.start_index, qz.dimension = 0, 2
    for c in cb:
        qz.centroids.add().values.extend(c.tolist())
    g.vector_index.data.code_width = 0
    g.vector_index.data.length = 2
    g.vector_index.data.encodings.extend([b"", b"\x01"])
    g.metric = pb.COSINE
    g.offsets.extend([1, -1, 2 ** 31 - 1])
    g.strategy = pb.GroupedIndex.LIMIT_VECTORS
    g.limit = -3
    assert ours.encode() == msg.SerializeToString()
    back = wire.Index.decode(msg.SerializeToString())
    assert back.which() == "grouped" and back.grouped.limit == -3
    assert back.grouped.offsets == [1, -1, 2 ** 31 - 1]
    assert back.grouped.grouped_words == ["", "b"]


def test_wire_reads_packed_floats_and_skips_unknown_fields():
    vals = np.array([0.5, -1.25, 3.0e7, 0.0], np.float32)
    packed = b"\x0a" + bytes([4 * len(vals)]) + vals.tobytes()
    mixed = packed + b"\x0d" + np.float32(9.0).tobytes() + b"\x10\x05"  # + unknown 2
    for blob, want in ((packed, vals), (mixed, np.append(vals, 9.0))):
        np.testing.assert_array_equal(wire.FloatVector.decode(blob).values, want)
        np.testing.assert_array_equal(np.array(pb.FloatVector.FromString(blob).values), want)
    # unknown fields of every wire type inside a SortedIndex
    msg = pb.SortedIndex()
    msg.sorted_words.append("a")
    msg.vector_index.product_quantizer.num_clusters = 2
    msg.vector_index.data.code_width = 2
    msg.vector_index.data.length = 1
    msg.metric = pb.L2
    extra = (
        b"\xa8\x03\x07"  # field 53 varint
        + b"\xb1\x03" + bytes(8)  # field 54 fixed64
        + b"\xba\x03\x03xyz"  # field 55 bytes
        + b"\xc5\x03" + bytes(4)  # field 56 fixed32
    )
    inner = msg.SerializeToString() + extra
    blob = b"\x0a" + bytes([len(inner)]) + inner
    assert pb.Index.FromString(blob).sorted.sorted_words == ["a"]
    got = wire.Index.decode(blob)
    assert got.sorted.sorted_words == ["a"] and got.sorted.metric == 0
    # re-encoded without the unknown fields: the message as written
    assert got.encode() == pb.Index(sorted=msg).SerializeToString()


def test_wire_required_fields_and_bad_bytes():
    with pytest.raises(wire.WireError, match="metric"):
        wire.SortedIndex(vector_index=wire.PQIndex(
            product_quantizer=wire.ProductQuantizer(num_clusters=1),
            data=wire.EncodedMatrix(code_width=0, length=0),
        )).encode()
    msg = pb.EncodedMatrix()
    msg.code_width = 8  # length missing: protobuf's partial serialization
    partial = msg.SerializePartialToString()
    with pytest.raises(wire.WireError, match="length"):
        wire.EncodedMatrix.decode(partial)
    with pytest.raises(wire.WireError):
        wire.Index.decode(b"\x0a\x05ab")  # truncated
    with pytest.raises(wire.WireError):
        wire.Index(sorted=wire.SortedIndex(), grouped=wire.GroupedIndex()).encode()


def _golden_pair(name):
    return jserde.load_index(str(GOLDEN / name)), tserde.load_index(GOLDEN / name, device="cpu")


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_loads_like_jax(name):
    jx, port = _golden_pair(name)
    assert type(port).__name__ == type(jx).__name__
    np.testing.assert_array_equal(port.codes.numpy().astype(np.int64), np.asarray(jx.codes))
    np.testing.assert_array_equal(port.pq.codebooks.numpy(), np.asarray(jx.pq.codebooks))
    assert port.pq.bounds == tuple(tuple(b) for b in jx.pq.bounds)
    assert list(port.key_index.keys) == list(jx.key_index.keys)
    assert port.metric.proto_value == jx.metric.proto_value
    if jx.rotation is None:
        assert port.rotation is None
    else:
        np.testing.assert_array_equal(port.rotation.numpy(), np.asarray(jx.rotation))
    if hasattr(jx, "centroids"):
        np.testing.assert_array_equal(
            port.key_index.group_offsets, np.asarray(jx.key_index.group_offsets)
        )
        np.testing.assert_array_equal(port.centroids.numpy(), np.asarray(jx.centroids))
        np.testing.assert_array_equal(port.group_ids.numpy(), np.asarray(jx.group_ids))
        np.testing.assert_allclose(
            port.row_const.numpy(), np.asarray(jx.row_const), rtol=1e-5, atol=1e-6
        )
        assert (type(port.strategy).__name__, port.strategy.count) == (
            type(jx.strategy).__name__, jx.strategy.count
        )
    else:
        np.testing.assert_allclose(
            port.recon_norms.numpy(), np.asarray(jx.recon_norms), rtol=1e-5, atol=1e-6
        )


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_serves_jax_ids(name):
    jx, port = _golden_pair(name)
    q = np.random.default_rng(len(name)).normal(size=(6, port.dimension)).astype(np.float32)
    k = port.size
    decode = "masked" if hasattr(jx, "centroids") else "decode"
    for strategy in (decode, "pallas"):
        np.testing.assert_array_equal(
            _port_ids(port, q, k, strategy), _jax_ids(jx, q, k, strategy)
        )
    assert port.query(1, q[0]).keys.tolist() == jx.query(1, q[0]).keys.tolist()


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_resaves_byte_identical(name, tmp_path):
    port = tserde.load_index(GOLDEN / name, device="cpu")
    out = tmp_path / name
    tserde.save_index(port, out)
    assert out.read_bytes() == (GOLDEN / name).read_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_blob_saved_by_port_serves_in_jax(jax_indices, data, kind, tmp_path):
    jx = jax_indices[kind]
    _, _, q, _ = data
    port = interop.from_reference(jx, device="cpu")
    path = str(tmp_path / "port.pb")
    tserde.save_index(port, path)
    loaded = jserde.load_index(path)
    strategy = "masked" if hasattr(jx, "centroids") else "decode"
    np.testing.assert_array_equal(
        _jax_ids(loaded, q, 10, strategy), _port_ids(port, q, 10, strategy)
    )


@pytest.mark.parametrize("kind", KINDS)
def test_blob_saved_by_jax_serves_in_port(jax_indices, data, kind, tmp_path):
    jx = jax_indices[kind]
    _, _, q, _ = data
    path = str(tmp_path / "jax.pb")
    jserde.save_index(jx, path)
    port = tserde.load_index(path, device="cpu")
    for strategy in (("masked", "pallas") if hasattr(jx, "centroids") else ("decode", "pallas")):
        np.testing.assert_array_equal(
            _port_ids(port, q, 10, strategy), _jax_ids(jx, q, 10, strategy)
        )


def test_exact_index_files_cross_load(data, tmp_path):
    """``save_index``/``load_index`` of an exact index are npz in both
    packages, told apart from protobuf by their magic bytes."""
    from gulon_tpu.models.exact import build_exact_index as jax_build_exact
    from gulon_tpu_torch.models.exact import ExactIndex

    x, keys, q, _ = data
    jx = jax_build_exact(keys, x)
    path = str(tmp_path / "exact.idx")
    jserde.save_index(jx, path)
    port = tserde.load_index(path, device="cpu")
    assert isinstance(port, ExactIndex)
    tserde.save_index(port, str(tmp_path / "back.idx"))
    back = jserde.load_index(str(tmp_path / "back.idx"))
    np.testing.assert_array_equal(
        port.query_arrays(5, q)[1].numpy(), np.asarray(back.query_arrays(5, q)[1])
    )
