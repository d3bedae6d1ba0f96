"""The port's line server (``gulon_tpu_torch/server.py``) against a
resident index on the CPU.

Its JSON answers equal ``query_arrays`` of the same index (keys and
distances), alone and through the micro-batcher, for vectors, batches and
words; lookups, info, ping and errors follow the JAX package's protocol,
and the answers equal the JAX server's on the same index. Device work of
concurrent clients runs one batch at a time under the server's lock.
"""

import json
import socket
import threading

import numpy as np
import pytest
import torch

from generators import random_keys
from gulon_tpu.models.build import build_ivf_index as jax_build_ivf
from gulon_tpu.models import ivf as jivf
from gulon_tpu.ops.pq import PQConfig as JaxPQConfig
from gulon_tpu.server import QueryServer as JaxQueryServer
from gulon_tpu_torch import interop
from gulon_tpu_torch.server import QueryServer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def indices():
    rng = np.random.default_rng(81)
    x = rng.normal(size=(1500, 16)).astype(np.float32)
    keys = random_keys(rng, 1500)
    jx = jax_build_ivf(
        keys, x, pq_config=JaxPQConfig(num_clusters=16, num_quantizers=8, max_iters=6),
        num_partitions=6, strategy=jivf.LimitGroups(3), coarse_max_iters=5,
    )
    return jx, interop.from_reference(jx, device="cpu"), keys, x


def _start(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


@pytest.fixture(scope="module", params=[0.0, 3.0], ids=["direct", "microbatch"])
def server(request, indices):
    _, port, _, _ = indices
    srv = QueryServer(port, port=0, micro_batch_window_ms=request.param)
    _start(srv)
    yield srv
    srv.shutdown()
    srv.server_close()


def _rpc(server, *requests):
    host, port = server.address[0], server.address[1]
    with socket.create_connection((host, port), timeout=30) as s:
        f = s.makefile("rwb")
        out = []
        for req in requests:
            f.write((req if isinstance(req, bytes) else json.dumps(req).encode()) + b"\n")
            f.flush()
            out.append(json.loads(f.readline()))
        return out


def _expected(index, keys_all, k, q):
    dists, ids = index.query_arrays(k, q)
    return (
        [[str(w) for w in keys_all[row]] for row in ids.numpy()],
        dists.numpy().tolist(),
    )


def test_answers_equal_query_arrays(server, indices):
    _, port, _, x = indices
    keys_all = np.asarray(port.key_index.keys, object)
    for q, k in ((x[3:4], 5), (x[:8] + 0.01, 3), (x[:200] - 0.02, 10)):
        req = {"k": k, "vector": q[0].tolist()} if len(q) == 1 else {"k": k, "vectors": q.tolist()}
        (resp,) = _rpc(server, req)
        want_keys, want_d = _expected(port, keys_all, k, q)
        assert resp["keys"] == want_keys
        np.testing.assert_array_equal(np.array(resp["distances"], np.float32),
                                      np.array(want_d, np.float32))


def test_words_lookup_info_ping(server, indices):
    _, port, keys, _ = indices
    (resp,) = _rpc(server, {"k": 2, "words": [str(keys[3]), "not-a-word", str(keys[9])]})
    assert resp["keys"][0][0] == str(keys[3]) and resp["keys"][2][0] == str(keys[9])
    assert resp["keys"][1] is None and resp["distances"][1] is None
    vec, miss, info, ping = _rpc(
        server, {"op": "lookup", "word": str(keys[3])}, {"op": "lookup", "word": "nope"},
        {"op": "info"}, {"op": "ping"},
    )
    np.testing.assert_allclose(vec["vector"], port.lookup(str(keys[3])), rtol=1e-6)
    assert miss == {"vector": None} and ping == {"ok": True}
    assert info["type"] == "IVFIndex" and info["size"] == 1500 and info["dimension"] == 16
    assert ("micro_batch" in info) == (server._batcher is not None)


def test_errors_keep_connection_open(server):
    replies = _rpc(
        server, b"not json", {"k": 0, "vector": [1.0]}, {"k": 1, "vector": [1.0, 2.0]},
        {"op": "bogus"}, {"k": 1}, [1, 2], {"op": "ping"},
    )
    frags = ["bad json", "k must be", "queries must be", "unknown op", "query needs",
             "JSON object"]
    for reply, frag in zip(replies, frags):
        assert frag in reply["error"]
    assert replies[-1] == {"ok": True}


def test_answers_equal_jax_server(indices):
    jx, port, _, x = indices
    ours, ref = QueryServer(port, port=0), JaxQueryServer(jx, port=0)
    try:
        for srv in (ours, ref):
            _start(srv)
        req = {"k": 4, "vectors": (x[:16] + 0.03).tolist()}
        (a,), (b,) = _rpc(ours, req), _rpc(ref, req)
        assert a["keys"] == b["keys"]
        np.testing.assert_allclose(a["distances"], b["distances"], rtol=1e-5, atol=1e-5)
    finally:
        for srv in (ours, ref):
            srv.shutdown()
            srv.server_close()


class _CountingIndex:
    """An index whose device work records how many calls overlap."""

    def __init__(self, inner):
        self.inner = inner
        self.active = 0
        self.peak = 0
        self.calls = 0
        self._guard = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _enter(self):
        with self._guard:
            self.active += 1
            self.calls += 1
            self.peak = max(self.peak, self.active)

    def _exit(self):
        with self._guard:
            self.active -= 1

    def query_arrays(self, k, q):
        self._enter()
        try:
            return self.inner.query_arrays(k, q)
        finally:
            self._exit()

    def lookup(self, word):
        self._enter()
        try:
            return self.inner.lookup(word)
        finally:
            self._exit()


@pytest.mark.parametrize("window_ms", [0.0, 2.0])
def test_device_work_is_serialised(indices, window_ms):
    """Sixteen clients at once: never two device calls at a time, and every
    client gets its own rows back."""
    import sys

    _, port, keys, x = indices
    counting = _CountingIndex(port)
    srv = QueryServer(counting, port=0, micro_batch_window_ms=window_ms)
    _start(srv)
    results, errors = {}, []

    def client(i):
        try:
            (r,) = _rpc(srv, {"k": 1, "vectors": x[i * 3:i * 3 + 3].tolist()})
            (w,) = _rpc(srv, {"k": 1, "words": [str(keys[i])]})
            results[i] = (r["keys"], w["keys"])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        srv.shutdown()
        srv.server_close()
    assert not errors and len(results) == 16
    assert counting.peak == 1 and counting.calls >= 16
    keys_all = np.asarray(port.key_index.keys, object)
    for i, (rows, _) in results.items():
        assert rows == _expected(port, keys_all, 1, x[i * 3:i * 3 + 3])[0]
