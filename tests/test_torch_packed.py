"""Port parity: packed sub-byte codes (``FlatIndex.pack_memory``,
``ops/scan.py::pack_rows`` / ``unpack_tile``).

- ``pack_rows`` writes the JAX package's bytes and ``unpack_tile`` reads
  them back to the same codes, widths 2 and 4;
- a packed index serves the unpacked index's ids and distances exactly
  (``auto`` stays on ``decode``, even for 4 queries or fewer), decodes the
  same ``lookup`` and measures the same degeneracy statistic;
- ``lut``, ``pallas`` and an uncached ``cached`` raise the JAX package's
  ``ValueError``; a cache built before packing still serves, and its
  exact rescore reads the packed codes;
- ``add`` and ``remove`` return indices packed as before; ``save_index``
  writes the unpacked index's bytes (the JAX package's too), and
  ``from_reference`` carries a packed JAX index's bytes across.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gulon_tpu.models.build import build_flat_index as jax_build
from gulon_tpu.ops import scan as jscan
from gulon_tpu.ops.pq import PQConfig as JaxPQConfig
from gulon_tpu.utils import serde as jserde
from gulon_tpu_torch import interop
from gulon_tpu_torch.models.build import build_flat_index
from gulon_tpu_torch.ops import scan as tscan
from gulon_tpu_torch.ops.pq import PQConfig
from gulon_tpu_torch.utils import serde as tserde

torch.set_num_threads(2)

N, D = 1500, 12


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(55)
    x = rng.normal(size=(N, D)).astype(np.float32)
    keys = np.array([f"p{i:04d}" for i in range(N)], dtype=object)
    return x, keys


def _build(data, clusters, m=6):
    x, keys = data
    return build_flat_index(
        keys, x, pq_config=PQConfig(num_clusters=clusters, num_quantizers=m, max_iters=8),
        device="cpu",
    )


@pytest.mark.parametrize("width,m", [(2, 5), (2, 6), (2, 8), (4, 5), (4, 6), (4, 9)])
def test_pack_rows_and_unpack_tile_match_jax(width, m):
    rng = np.random.default_rng(width * 10 + m)
    codes = rng.integers(0, 1 << width, size=(37, m)).astype(np.uint8)
    packed = tscan.pack_rows(torch.from_numpy(codes), width)
    assert packed.dtype == torch.uint8 and packed.shape == (37, -(-m * width // 8))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jscan.pack_rows(codes, width)))
    back = tscan.unpack_tile(packed, m, width)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jscan.unpack_tile(np.asarray(packed.numpy()), m, width))
    )
    with pytest.raises(ValueError):
        tscan.pack_rows(torch.from_numpy(codes), 3)


@pytest.mark.parametrize("clusters,width,nbytes", [(4, 2, 2), (16, 4, 3)])
def test_packed_index_serves_the_unpacked_results(data, clusters, width, nbytes):
    x, keys = data
    plain = _build(data, clusters)
    packed = dataclasses.replace(plain)
    packed.pack_memory()
    assert packed.packed_width == width and packed.scan_strategy == "decode"
    assert packed.codes.shape == (N, nbytes) and packed.codes.dtype == torch.uint8
    packed.pack_memory()  # packing twice changes nothing
    assert packed.codes.shape == (N, nbytes)
    packed.scan_strategy = "auto"
    decode = dataclasses.replace(plain, scan_strategy="decode")
    for nq in (3, 64):  # auto keeps a packed index on decode, even for 3
        assert packed.resolve_strategy(nq, 7) == "decode"
        dp, ip = packed.query_arrays(7, x[:nq] + 0.01)
        dd, idd = decode.query_arrays(7, x[:nq] + 0.01)
        assert torch.equal(ip, idd) and torch.equal(dp, dd)
    np.testing.assert_array_equal(packed.lookup("p0003"), plain.lookup("p0003"))
    assert packed._code_duplication() == plain._code_duplication()
    assert packed.resolved_rerank_factor() == plain.resolved_rerank_factor()


def test_packed_strategy_errors_match_jax(data):
    x, keys = data
    port = _build(data, 4)
    port.pack_memory()
    ref = jax_build(keys, x, pq_config=JaxPQConfig(num_clusters=4, num_quantizers=6,
                                                   max_iters=8))
    ref.pack_memory()
    for strategy in ("lut", "pallas", "cached"):
        msgs = []
        for idx in (dataclasses.replace(port, scan_strategy=strategy),
                    dataclasses.replace(ref, scan_strategy=strategy)):
            with pytest.raises(ValueError) as err:
                idx.query_arrays(3, x[:8])
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    wide = _build(data, 256)
    with pytest.raises(ValueError, match="<= 4 bits"):
        wide.pack_memory()


def test_cache_built_before_packing_serves_and_rescores(data):
    x, _ = data
    plain = _build(data, 16)
    plain.enable_cache()
    packed = dataclasses.replace(plain)
    packed.pack_memory()
    for idx in (plain, packed):
        idx.scan_strategy, idx.rerank_factor = "cached", 4
    dp, ip = packed.query_arrays(5, x[:32])
    dd, idd = plain.query_arrays(5, x[:32])
    assert torch.equal(ip, idd) and torch.equal(dp, dd)
    packed.decoded_cache = None
    packed.enable_cache()  # rebuilt from the unpacked codes
    assert torch.equal(packed.decoded_cache, plain.decoded_cache)


def test_packed_add_and_remove_stay_packed(data):
    x, keys = data
    plain = _build(data, 16)
    packed = dataclasses.replace(plain)
    packed.pack_memory()
    rng = np.random.default_rng(3)
    new_x = rng.normal(size=(40, D)).astype(np.float32)
    new_keys = [f"n{i:03d}" for i in range(40)]
    grown_p, grown = packed.add(new_keys, new_x), plain.add(new_keys, new_x)
    assert grown_p.packed_width == 4 and grown_p.size == N + 40
    assert torch.equal(grown_p.codes, tscan.pack_rows(grown.codes, 4))
    shrunk_p = grown_p.remove(new_keys[:10] + ["p0001"])
    shrunk = grown.remove(new_keys[:10] + ["p0001"])
    assert shrunk_p.packed_width == 4
    assert torch.equal(shrunk_p.codes, tscan.pack_rows(shrunk.codes, 4))
    q = np.concatenate([new_x[10:20], x[:10]])
    dp, ip = shrunk_p.query_arrays(4, q)
    dd, idd = dataclasses.replace(shrunk, scan_strategy="decode").query_arrays(4, q)
    assert torch.equal(ip, idd) and torch.equal(dp, dd)


def test_packed_save_load_and_from_reference(data, tmp_path):
    x, keys = data
    plain = _build(data, 4)
    packed = dataclasses.replace(plain)
    packed.pack_memory()
    tserde.save_index(plain, tmp_path / "plain.pb")
    tserde.save_index(packed, tmp_path / "packed.pb")
    assert (tmp_path / "plain.pb").read_bytes() == (tmp_path / "packed.pb").read_bytes()
    back = tserde.load_index(tmp_path / "packed.pb", device="cpu")
    assert back.packed_width == 0 and torch.equal(back.codes, plain.codes)

    ref = jax_build(keys, x, pq_config=JaxPQConfig(num_clusters=4, num_quantizers=6,
                                                   max_iters=8))
    jserde.save_index(ref, str(tmp_path / "jax_plain.pb"))
    ref.pack_memory()
    jserde.save_index(ref, str(tmp_path / "jax_packed.pb"))
    port = interop.from_reference(ref, device="cpu")
    assert port.packed_width == 2 and port.scan_strategy == "decode"
    np.testing.assert_array_equal(port.codes.numpy(), np.asarray(ref.codes))
    tserde.save_index(port, tmp_path / "port_of_jax.pb")
    assert ((tmp_path / "port_of_jax.pb").read_bytes()
            == (tmp_path / "jax_packed.pb").read_bytes()
            == (tmp_path / "jax_plain.pb").read_bytes())
    unpacked = interop.from_reference(
        dataclasses.replace(ref, codes=ref._unpacked_codes(), packed_width=0,
                            scan_strategy="decode"),
        device="cpu",
    )
    dp, ip = port.query_arrays(6, x[:16])
    dd, idd = unpacked.query_arrays(6, x[:16])
    assert torch.equal(ip, idd) and torch.equal(dp, dd)
