"""The readers of the program's spans (``query_host_ms.batch``,
``host_syncs.batch``, ``lloyd_ms.build``, ``build_host_s.build``): each is
found by name, reads the program's span aggregates of the latest profiled
session only, and reads nothing where no device work was traced (a CPU
run) or where the program records no spans."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import h100bench_tiny as tiny
from h100bench.spec import Spec

BATCH = ("query_host_ms.batch", "host_syncs.batch")
BUILD = ("lloyd_ms.build", "build_host_s.build")
TRACED = [("kernel", 0, 1000)]  # one device interval: the window traced device work


def _ctx(kernels):
    return SimpleNamespace(view=SimpleNamespace(kernels=kernels, units=1), config={},
                           traffic={}, peaks=None)


def _session(fn):
    """``fn()`` under a CPU profiler, as a new session of the program's spans."""
    from gulon_tpu_torch.utils import tracing

    with tracing.span("gulon.test.off"):  # the profiler is off: the next session starts afresh
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return tracing.snapshot()["spans"]


@pytest.fixture(scope="module")
def readers():
    spec = Spec(tiny.REPO)
    return {name: spec.metric_reader(name) for name in BATCH + BUILD}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6000, 16)).astype(np.float32)
    return np.array([f"w{i:05d}" for i in range(len(x))], dtype=object), x


@pytest.fixture(scope="module")
def flat(corpus):
    import gulon_tpu_torch as gt

    index = gt.build_flat_index(*corpus, pq_config=gt.PQConfig(
        num_clusters=16, num_quantizers=4, max_iters=4), device="cpu")
    index.scan_strategy = "pallas"  # K1's plain twin on the CPU
    index.rerank_factor = 1
    index.query_arrays(10, corpus[1][:64])
    return index


def test_each_reader_is_found_by_name_and_reads_nothing_without_device_work(readers, flat, corpus):
    _session(lambda: flat.query_arrays(10, corpus[1][:64]))
    for name, read in readers.items():
        assert read(_ctx([])) is None, name
    assert {name for name in BATCH if readers[name](_ctx(TRACED)) is not None} == set(BATCH)


def test_the_batch_readers_read_the_latest_session(readers, flat, corpus):
    q = corpus[1][:64]
    _session(lambda: [flat.query_arrays(10, q) for _ in range(4)])
    spans = _session(lambda: flat.query_arrays(10, q))
    query = spans["gulon.query"]
    assert query["count"] == 1
    waits = {k: v for k, v in spans.items() if k.startswith("gulon.wait.")}
    # the index holds K1's operands: a batch waits only on its queries' upload
    assert set(waits) == {"gulon.wait.upload_queries"}
    assert readers["host_syncs.batch"](_ctx(TRACED)) == 1.0
    host = readers["query_host_ms.batch"](_ctx(TRACED))
    wait_s = sum(v["total_s"] for v in waits.values())
    assert host == pytest.approx(1e3 * (query["total_s"] - wait_s))
    assert 0 < host < 1e3 * query["total_s"]
    for name in BUILD:  # no build in the session
        assert readers[name](_ctx(TRACED)) is None


def test_the_build_readers_read_the_latest_session(readers, corpus):
    import gulon_tpu_torch as gt

    def build(iters, report_fn=None):
        return gt.build_flat_index(*corpus, pq_config=gt.PQConfig(
            num_clusters=16, num_quantizers=4, max_iters=iters), report_fn=report_fn,
            device="cpu")

    _session(lambda: build(2))
    seen = []
    spans = _session(lambda: build(12, lambda it, *stats: seen.append(it)))
    it = spans["gulon.kmeans.iter"]
    assert it["count"] == len(seen) > 2
    assert readers["lloyd_ms.build"](_ctx(TRACED)) == pytest.approx(1e3 * it["total_s"] / len(seen))
    assert spans["gulon.build"]["count"] == 1
    assert readers["build_host_s.build"](_ctx(TRACED)) == pytest.approx(
        spans["gulon.build.host"]["total_s"])
    for name in BATCH:  # no query in the session
        assert readers[name](_ctx(TRACED)) is None


def test_a_program_without_spans_reads_nothing(readers, monkeypatch, flat, corpus):
    import gulon_tpu_torch.utils as utils

    _session(lambda: flat.query_arrays(10, corpus[1][:64]))
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "gulon_tpu_torch.utils.tracing", None)
    for name, read in readers.items():
        assert read(_ctx(TRACED)) is None, name
