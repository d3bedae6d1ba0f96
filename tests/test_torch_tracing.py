"""The port's spans and counters (``gulon_tpu_torch/utils/tracing.py``).

With no profiler a span is one shared no-op context that never builds a
``RecordFunction``. Under ``torch.profiler`` each span is a plain host
event (a ``cpu_op``, not a user annotation) on the profiler's clock, the
spans nest as the layers do, and the aggregates keep count, total and
self time for the latest profiled session only. The query and build
paths record the span tree their layers make, one wait span per call
that blocks on the device, and one ``gulon.kmeans.iter`` per Lloyd
iteration. Launch counters live in the same registry; a K1 launch is
counted by the launch plan the kernel picks (held or streamed, codebooks
in shared or global memory, blocks, block decodes, lanes a gather)."""

import ast
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gulon_tpu_torch as gt
from gulon_tpu_torch.ops import kmeans as tkm
from gulon_tpu_torch.ops.cuda import adc as tad
from gulon_tpu_torch.utils import tracing

PKG = pathlib.Path(gt.__file__).parent
N, D, K = 6000, 16, 10
PQ = gt.PQConfig(num_clusters=16, num_quantizers=4, max_iters=6)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(40, D)).astype(np.float32)
    x = centers[rng.integers(0, 40, N)] + 0.1 * rng.normal(size=(N, D)).astype(np.float32)
    keys = np.array([f"w{i:05d}" for i in range(N)], dtype=object)
    return keys, x.astype(np.float32), x[:64].copy()


@pytest.fixture(scope="module")
def flat(corpus):
    keys, x, _ = corpus
    return gt.build_flat_index(keys, x, gt.Metric.COSINE, PQ, device="cpu")


@pytest.fixture(scope="module")
def ivf(corpus):
    keys, x, _ = corpus
    return gt.build_ivf_index(keys, x, pq_config=PQ, num_partitions=12,
                              strategy=gt.LimitGroups(3), coarse_max_iters=6, device="cpu")


def _profiled(fn):
    """``fn()`` under a CPU profiler; returns ``(snapshot spans, profile)``."""
    with tracing.span("gulon.test.off"):  # seen off: the session starts afresh
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return tracing.snapshot()["spans"], prof


def _gulon_events(prof):
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith("gulon.")]


def _tree(prof) -> set:
    """``(span, innermost enclosing span or None)`` of every span event."""
    ev = sorted(_gulon_events(prof), key=lambda e: (e.start_ns(), -e.duration_ns()))
    pairs, open_ = set(), []
    for e in ev:
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        while open_ and open_[-1][1] < t:
            open_.pop()
        pairs.add((e.name(), open_[-1][0] if open_ else None))
        open_.append((e.name(), t))
    return pairs


def _waits(spans) -> int:
    return sum(v["count"] for name, v in spans.items() if name.startswith("gulon.wait."))


def test_span_off_is_one_shared_noop_and_builds_no_record_function(monkeypatch, flat, corpus):
    def refuse(*a, **kw):
        raise AssertionError("a RecordFunction was built with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    tracing.reset()
    a, b = tracing.span("gulon.a"), tracing.span("gulon.b")
    assert a is b
    with a, b:
        pass
    flat.query_arrays(K, corpus[2])
    gt.build_flat_index(corpus[0][:2000], corpus[1][:2000], pq_config=PQ, device="cpu")
    assert tracing.snapshot()["spans"] == {}


def test_spans_nest_with_self_time_and_stay_off_the_device_timeline():
    def work():
        with tracing.span("gulon.outer"):
            time.sleep(0.02)
            with tracing.span("gulon.inner"):
                time.sleep(0.03)
                with tracing.span("gulon.innermost"):
                    pass
            with tracing.span("gulon.inner"):
                pass

    spans, prof = _profiled(work)
    outer, inner, most = spans["gulon.outer"], spans["gulon.inner"], spans["gulon.innermost"]
    assert (outer["count"], inner["count"], most["count"]) == (1, 2, 1)
    assert outer["total_s"] >= 0.05 and inner["total_s"] >= 0.03
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    assert inner["self_s"] == pytest.approx(inner["total_s"] - most["total_s"], abs=1e-9)
    assert most["self_s"] == most["total_s"]
    assert _tree(prof) == {("gulon.outer", None), ("gulon.inner", "gulon.outer"),
                           ("gulon.innermost", "gulon.inner")}
    events = _gulon_events(prof)
    assert len(events) == 4
    for e in events:
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation()


def test_a_thread_the_profiler_does_not_see_leaves_the_session_alone():
    def other():  # the profiler sees the thread that started it only
        with tracing.span("gulon.thread"):
            time.sleep(0.01)

    def work():
        with tracing.span("gulon.before"):
            pass
        with tracing.span("gulon.main"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
        with tracing.span("gulon.after"):
            pass

    spans, _ = _profiled(work)
    assert set(spans) == {"gulon.before", "gulon.main", "gulon.after"}
    assert spans["gulon.main"]["self_s"] == spans["gulon.main"]["total_s"] >= 0.01


QUERY_ROOT = {("gulon.query", None), ("gulon.query.prepare", "gulon.query"),
              ("gulon.wait.upload_queries", "gulon.query.prepare"),
              ("gulon.query.route", "gulon.query")}
# K1's index operands are held by the index: a batch builds its query
# operand alone and waits on nothing past the query upload
K1_PATH = {("gulon.scan.operands", "gulon.query"),
           ("gulon.scan.k1", "gulon.query"), ("gulon.scan.select", "gulon.query")}

# flat: (knobs, spans below the root, wait spans a query); this corpus's
# codes repeat, so the auto rerank factor would add a rescore
FLAT_ROUTES = {
    "pallas": (dict(scan_strategy="pallas", rerank_factor=1), K1_PATH, 1),
    "pallas_rescore": (dict(scan_strategy="pallas", rerank_factor=2),
                       K1_PATH | {("gulon.scan.rescore", "gulon.query")}, 1),
    "decode": (dict(scan_strategy="decode"), {("gulon.scan.decode", "gulon.query")}, 1),
    "lut": (dict(scan_strategy="lut"), {("gulon.scan.lut", "gulon.query")}, 1),
    "cached": (dict(scan_strategy="cached", rerank_factor=1),
               {("gulon.scan.cached", "gulon.query")}, 1),
}


@pytest.mark.parametrize("route", list(FLAT_ROUTES))
def test_a_flat_query_records_its_span_tree(flat, corpus, route):
    import dataclasses

    knobs, below, waits = FLAT_ROUTES[route]
    index = dataclasses.replace(flat, **knobs)
    if route == "cached":
        index.enable_cache()
    q = corpus[2]
    index.query_arrays(K, q)  # lazy operands and memoized knobs, unprofiled
    spans, prof = _profiled(lambda: [index.query_arrays(K, q) for _ in range(3)])
    assert _tree(prof) == QUERY_ROOT | below
    assert spans["gulon.query"]["count"] == 3
    assert _waits(spans) / spans["gulon.query"]["count"] == waits


IVF_ROUTES = {
    "pallas": (dict(scan_strategy="pallas"), K1_PATH, 1),
    "pallas_rescore": (dict(scan_strategy="pallas", pallas_rescore=2),
                       K1_PATH | {("gulon.scan.rescore", "gulon.scan.select")}, 1),
    "masked": (dict(scan_strategy="masked"), {("gulon.scan.masked", "gulon.query")}, 1),
    "gathered": (dict(scan_strategy="gathered"),
                 {("gulon.scan.gathered", "gulon.query"),
                  ("gulon.wait.upload_slices", "gulon.scan.gathered")}, 2),
    "bucketed": (dict(scan_strategy="bucketed"),
                 {("gulon.scan.bucketed", "gulon.query"),
                  ("gulon.wait.probe_ids", "gulon.scan.bucketed"),
                  ("gulon.wait.upload_schedule", "gulon.scan.bucketed")}, 3),
}


@pytest.mark.parametrize("route", list(IVF_ROUTES))
def test_an_ivf_query_records_its_span_tree(ivf, corpus, route):
    import dataclasses

    knobs, below, waits = IVF_ROUTES[route]
    index = dataclasses.replace(ivf, **knobs)
    q = corpus[2]
    index.query_arrays(K, q)
    spans, prof = _profiled(lambda: [index.query_arrays(K, q) for _ in range(2)])
    assert _tree(prof) == QUERY_ROOT | {("gulon.ivf.probe", "gulon.query")} | below
    assert spans["gulon.query"]["count"] == 2
    assert _waits(spans) / spans["gulon.query"]["count"] == waits


def test_a_session_counts_its_own_spans_only(flat, corpus):
    q = corpus[2]
    first, _ = _profiled(lambda: [flat.query_arrays(K, q) for _ in range(3)])
    assert first["gulon.query"]["count"] == 3
    second, _ = _profiled(lambda: flat.query_arrays(K, q))
    assert second["gulon.query"]["count"] == 1
    assert set(second) <= set(first)
    tracing.reset()
    assert tracing.snapshot()["spans"] == {}


def _iterations_and_spans(build):
    """Lloyd iterations that ``report_fn`` saw, and the build's spans."""
    seen = []
    spans, prof = _profiled(lambda: build(lambda it, *stats: seen.append(it)))
    return seen, spans, prof


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_a_build_records_one_span_per_lloyd_iteration(corpus, kind):
    keys, x, _ = corpus
    pq = PQ._replace(max_iters=25)
    if kind == "flat":
        seen, spans, prof = _iterations_and_spans(
            lambda rep: gt.build_flat_index(keys, x, pq_config=pq, report_fn=rep, device="cpu"))
        trainings = 1
    else:
        seen, spans, prof = _iterations_and_spans(
            lambda rep: gt.build_ivf_index(keys, x, pq_config=pq, num_partitions=12,
                                           coarse_max_iters=25, report_fn=rep, device="cpu"))
        trainings = 2  # the coarse k-means, then the residual PQ
    assert sum(1 for it in seen if it == 1) == trainings
    assert spans["gulon.kmeans.iter"]["count"] == len(seen)
    assert spans["gulon.build"]["count"] == 1
    assert spans["gulon.build.train"]["count"] == trainings
    tree = _tree(prof)
    for child in ("gulon.build.host", "gulon.build.train", "gulon.build.encode"):
        assert (child, "gulon.build") in tree
    assert ("gulon.kmeans.iter", "gulon.build.train") in tree
    assert ("gulon.wait.kmeans_done", "gulon.kmeans.iter") in tree
    assert spans["gulon.wait.kmeans_done"]["count"] == len(seen)


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_the_coarse_k_means_has_a_span_of_its_own(corpus, kind):
    """``gulon.build.coarse`` opens once an IVF build, inside its first
    ``gulon.build.train``, around the coarse k-means's iterations (the
    residual PQ's stay directly under ``gulon.build.train``); a flat
    build, which has no coarse k-means, never opens it."""
    keys, x, _ = corpus
    if kind == "flat":
        spans, prof = _profiled(lambda: gt.build_flat_index(keys, x, pq_config=PQ, device="cpu"))
        assert "gulon.build.coarse" not in spans
        return
    spans, prof = _profiled(lambda: gt.build_ivf_index(
        keys, x, pq_config=PQ, num_partitions=12, coarse_max_iters=6, device="cpu"))
    assert spans["gulon.build.coarse"]["count"] == 1
    tree = _tree(prof)
    assert ("gulon.build.coarse", "gulon.build.train") in tree
    assert ("gulon.kmeans.iter", "gulon.build.coarse") in tree
    assert ("gulon.kmeans.iter", "gulon.build.train") in tree
    assert ("gulon.wait.coarse_result", "gulon.build.coarse") in tree


@pytest.mark.parametrize("route", ["pallas", "masked"])
def test_the_ivf_selection_counts_its_sort_keys(ivf, corpus, route):
    """The IVF K1 route (its plain twin on the CPU) counts one selection a
    batch and the keys its selection may read: the batch's queries times
    the winner columns of the probe's ``count`` largest partitions and of
    the padding blocks K1's columns cover, 4 a 128-row block; always on,
    with no profiler. The plain twin launches no kernel. Another route
    counts none."""
    import dataclasses

    index = dataclasses.replace(ivf, scan_strategy=route)
    q = corpus[2]
    index.query_arrays(K, q)
    names = ("ivf.selects", "ivf.select_keys", "ivf.topk.launches")
    before = {c: tracing.counter(c) for c in names}
    for _ in range(3):
        index.query_arrays(K, q)
    n = {c: tracing.counter(c) - v for c, v in before.items()}
    if route == "masked":
        assert n == {"ivf.selects": 0, "ivf.select_keys": 0, "ivf.topk.launches": 0}
        return
    blocks = -(-index.partition_sizes().astype(np.int64) // 128)
    padding = index._k1_operands.codes_t.shape[1] // 128 - int(blocks.sum())
    largest = int(np.sort(blocks)[::-1][: index.strategy.count].sum())
    columns = index.pallas_winners * (largest + padding)
    assert columns < index._k1_operands.codes_t.shape[1] // 128 * index.pallas_winners
    assert n == {"ivf.selects": 3, "ivf.select_keys": 3 * len(q) * columns,
                 "ivf.topk.launches": 0}


@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
def test_fit_kmeans_records_its_iterations(corpus, stacked):
    x = torch.from_numpy(corpus[1][:3000])
    if stacked:
        x = torch.stack([x[:, :8], x[:, 8:]])
    result = None

    def fit():
        nonlocal result
        result = tkm.fit_kmeans(x, tkm.KMeansConfig(k=12, max_iters=30))

    spans, _ = _profiled(fit)
    assert result.iterations >= 2
    assert spans["gulon.kmeans.iter"]["count"] == result.iterations


def test_counters_are_always_on():
    before = tracing.counter("test.launches")
    tracing.count("test.launches")
    tracing.count("test.launches", 2)
    assert tracing.counter("test.launches") == before + 3
    tracing.set_counter("test.launches", 0)
    assert tracing.snapshot()["counters"]["test.launches"] == 0
    assert tracing.counter("test.never") == 0


def test_counts_from_many_threads_are_all_kept():
    threads, each = 16, 5000
    tracing.set_counter("test.threads", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [tracing.count("test.threads")
                                                    for _ in range(each)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    assert tracing.counter("test.threads") == threads * each


def _module_globals(path: pathlib.Path):
    for node in ast.parse(path.read_text()).body:
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else [])
        for t in targets:
            if isinstance(t, ast.Name):
                yield t.id


def test_the_port_counts_launches_in_the_registry_only():
    found = [(p.name, name) for p in PKG.rglob("*.py") for name in _module_globals(p)
             if "launch" in name.lower()]
    assert found == []
    source = (PKG / "utils" / "tracing.py").read_text()
    assert "environ" not in source and "getenv" not in source


K1_PLAN_COUNTERS = ("k1.launches", "k1.launches.streamed", "k1.launches.cb_global",
                    "k1.blocks", "k1.block_decodes", "k1.gather_lanes")


def _k1_counts(fn):
    """What ``fn()`` adds to each of K1's launch counters."""
    before = {c: tracing.counter(c) for c in K1_PLAN_COUNTERS}
    fn()
    return {c: tracing.counter(c) - before[c] for c in K1_PLAN_COUNTERS}


@pytest.mark.parametrize("plan,num_q,expect", [
    (dict(streamed=0, cb_smem=1, lanes=1, qtile=128), 1024, (1, 0, 0, 9248, 9248, 1)),
    (dict(streamed=1, cb_smem=0, lanes=1, qtile=256), 1024, (1, 1, 1, 9248, 4 * 9248, 1)),
    (dict(streamed=1, cb_smem=1, lanes=8, qtile=256), 129, (1, 1, 0, 9248, 9248, 8)),
    (dict(streamed=0, cb_smem=0, lanes=1, qtile=128), 7, (1, 0, 1, 9248, 9248, 1)),
    (dict(streamed=1, cb_smem=0, lanes=8, qtile=256), 257, (1, 1, 1, 9248, 2 * 9248, 8)),
    (dict(streamed=1, cb_smem=1, lanes=8, qtile=128), 1024, (1, 1, 0, 9248, 8 * 9248, 8)),
], ids=["held", "streamed-gist", "streamed-ragged", "held-cb-global", "streamed-two-tiles",
        "streamed-tile128"])
def test_a_k1_launch_is_counted_by_its_plan(plan, num_q, expect):
    """Held decoded, a block is decoded once a launch; streamed, once per
    query tile of the plan's ``qtile`` queries (a ragged last tile counts);
    lanes a gather add up over launches."""
    n = _k1_counts(lambda: tad.count_launch(plan, 9248 * 128, num_q))
    assert tuple(n[c] for c in K1_PLAN_COUNTERS) == expect


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K1 runs only on the card")
    return torch.device("cuda")


# glove100's flat operands (d 100 over 25: dsub 4, centered, one winner)
# and sift128's IVF operands (d 128 over 25: dsub 6, uncentered, 4 winners)
HELD_SHAPES = {"glove100": (8192, 100, 25, 256, 1024, 1, True, None),
               "sift128.ivf": (8192, 128, 25, 256, 1024, 4, False, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(HELD_SHAPES))
def test_the_batch_cells_shapes_launch_k1_held(card, shape):
    import chip_smoke as cs

    case = HELD_SHAPES[shape]
    operands, nblk, _ = cs.k1_operands(torch.Generator(device=card).manual_seed(1), *case,
                                       dev=card)
    n = _k1_counts(lambda: tad.fused_block_scan(*operands, winners=case[5], nblk=nblk))
    assert n["k1.launches"] == 1
    assert n["k1.launches.streamed"] == n["k1.launches.cb_global"] == 0
    assert n["k1.block_decodes"] == n["k1.blocks"] == operands[0].shape[1] // 128
    assert n["k1.gather_lanes"] == 1


# (streamed, codebooks in shared memory, lanes a gather, operand width,
# query tile) of K1_EDGE_CASES' deep shapes, by (D, m, K); 960 over 25 is
# laid out as an index lays it (at 40 lanes a subspace, not 39). Streamed
# plans take 256 queries a tile but where 128 KB of codebooks in shared
# memory leave no room for it (800 over 100 at K = 80).
DEEP_PLANS = {
    (300, 19, 256): (0, 0, 1, 16, 128), (688, 8, 256): (0, 0, 1, 86, 128),
    (768, 96, 256): (1, 0, 8, 8, 256), (1000, 250, 16): (1, 1, 4, 4, 256),
    (800, 100, 1024): (1, 0, 8, 8, 256), (720, 720, 16): (1, 1, 1, 1, 256),
    (900, 90, 64): (1, 1, 2, 10, 256), (960, 25, 256): (1, 0, 8, 40, 256),
    (800, 100, 80): (1, 1, 8, 8, 128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dmk", list(DEEP_PLANS), ids=lambda k: f"d{k[0]}-m{k[1]}-K{k[2]}")
def test_the_plan_the_wrapper_counts_is_the_kernels(card, dmk):
    """At each deep shape of ``K1_EDGE_CASES`` (each case of it): the plan
    the wrapper reads (``k1_plan``, cached) is the one
    ``gulon_adc_scan_plan`` returns, it is the documented one, and the
    launch is counted by it."""
    import ctypes

    import chip_smoke as cs

    cases = [c for c in cs.K1_EDGE_CASES if c[1:4] == dmk]
    assert cases
    for case in cases:
        operands, nblk, _ = cs.k1_operands(torch.Generator(device=card).manual_seed(7), *case,
                                           dev=card)
        m, k_codes, dsub = operands[3].shape
        raw = (ctypes.c_int * len(tad.K1_PLAN_FIELDS))()
        assert tad._kernel().gulon_adc_scan_plan(m * dsub + 4, m, k_codes, dsub, raw) == 0
        plan = tad.k1_plan(m, k_codes, dsub)
        assert plan == dict(zip(tad.K1_PLAN_FIELDS, raw))
        assert (plan["streamed"], plan["cb_smem"], plan["lanes"], plan["width"],
                plan["qtile"]) == DEEP_PLANS[dmk]
        n = _k1_counts(lambda: tad.fused_block_scan(*operands, winners=case[5], nblk=nblk))
        torch.cuda.synchronize()
        blocks = operands[0].shape[1] // 128
        tiles = -(-case[4] // plan["qtile"])
        assert n == {"k1.launches": 1, "k1.launches.streamed": plan["streamed"],
                     "k1.launches.cb_global": 1 - plan["cb_smem"], "k1.blocks": blocks,
                     "k1.block_decodes": blocks * (tiles if plan["streamed"] else 1),
                     "k1.gather_lanes": plan["lanes"]}
