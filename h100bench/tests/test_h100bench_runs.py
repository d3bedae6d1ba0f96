"""Whole runs of each cell at a tiny size on the CPU: the loop each mix
names, the traced run, and ``correct`` coming out false with the timed
path broken underneath (the harness's look for a card is skipped: the
runs go straight to ``run_cell`` on the CPU)."""

import json
import subprocess
import sys

import pytest
import torch

import h100bench_tiny as tiny
from h100bench.reference.control import ControlSystem

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def test_each_mix_drives_the_loop_it_names(root):
    res, _, _ = tiny.run(root, "glove100.batch1024")
    assert res["correct"] and res["attempted"] % 1024 == 0 and res["attempted"] >= 1024
    assert set(res["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    res, notes, _ = tiny.run(root, "sift128.ivf.batch1024")
    assert res["correct"] and res["attempted"] % 1024 == 0
    assert notes == [f"compile_s 0.0 of setup_s {res['metrics']['setup_s']['value']!r}"]
    assert res["checks"]["part_miss"] == {"value": 0.0, "limit": 0.0}
    res, _, _ = tiny.run(root, "glove100.build")
    assert res["correct"] and res["attempted"] >= 1 and set(res["metrics"]) == {"build_vps", "setup_s"}
    assert list(res)[-2:] == ["compile_s", "checks"] and res["compile_s"] == 0.0


def test_traced_runs_report_per_layer_metrics_and_a_breakdown(root):
    res, _, err = tiny.run(root, "glove100.batch1024", trace=True)
    assert res["correct"]
    # no device here: the kernel readers find nothing, the idle share is whole
    assert set(res["metrics"]) == {"device_idle.batch"}
    assert res["device"]["window_s"] > 0 and res["device"]["busy_s"] == 0
    assert res["breakdown"]["idle_gaps"]
    assert err[0].startswith("check dist_err")
    written = sorted(p.name for p in (root / "out").iterdir())
    assert any(n.endswith(".trace.json.gz") for n in written)
    assert any(n.endswith(".profile.txt") for n in written)


@pytest.mark.parametrize("cell", ["gist960.exact.batch1024", "glove100.cached.batch1024"])
def test_a_sound_run_of_each_new_index_kind_is_correct(root, cell):
    res, _, _ = tiny.run(root, cell)
    assert res["correct"] and res["attempted"] % 1024 == 0 and res["attempted"] >= 1024
    assert set(res["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    if cell.startswith("gist960.exact"):
        assert set(res["checks"]) == {"dist_err", "adc_miss", "row_err"}
        assert res["checks"]["row_err"]["value"] == 0.0
        assert res["metrics"]["recall_at_10"]["value"] > 0.99


def test_the_port_builds_each_kind_its_file_states(root):
    """An exact configuration sets the index's fields and exports its rows
    in corpus order; a cached one decodes its cache, so ``auto`` resolves to
    the cached route, and exports as a flat index."""
    import numpy as np

    from h100bench import corpus
    from h100bench.spec import Spec
    from h100bench.systems import PortSystem

    conf = Spec(root).cell("gist960.exact.batch1024").config
    x, _ = corpus.make(conf, "cpu")
    perm = np.random.default_rng(0).permutation(len(x))
    system = PortSystem(dict(conf, index=dict(conf["index"], rescore_factor=3)), "cpu")
    index = system.build(np.asarray(corpus.keys_for(len(x)))[perm], x[perm])
    assert (index.operand, index.rescore_factor, index.exact_rescore) == ("bf16", 3, True)
    state = system.export(index)
    assert state.kind == "exact" and state.codes is None
    assert torch.equal(state.vectors, torch.from_numpy(x))
    assert system.corpus_rows(index).tolist() == list(range(len(x)))

    conf = Spec(root).cell("glove100.cached.batch1024").config
    x, _ = corpus.make(conf, "cpu")
    system = PortSystem(conf, "cpu")
    index = system.build(corpus.keys_for(len(x)), x)
    assert index.decoded_cache is not None and index.resolve_strategy(1024, 10) == "cached"
    state = system.export(index)
    assert state.kind == "flat" and state.norms is not None and state.vectors is None


@pytest.mark.parametrize("exact_rescore", [True, False])
def test_the_programs_own_lower_path_is_the_exact_cells_control(root, monkeypatch, exact_rescore):
    """K2's route (its plain twin here) reports distances within
    ``dist_err``'s limit with the f32 rescore the configuration states, and
    fails it with the distances re-ranked from its bf16 operand:
    ``control.py --program-index``. (At 32 row blocks one winner a block
    misses far more answers than at 7,813, so ``adc_miss`` is not read.)"""
    from h100bench import control

    monkeypatch.setattr(control, "ROOT", root)
    out = control.run("gist960.exact.batch1024", 7, 0.5, "cpu",
                      {"strategy": "pallas", "exact_rescore": exact_rescore})
    dist_err = out["checks"]["dist_err"]
    assert (dist_err["value"] <= dist_err["limit"]) is exact_rescore
    assert exact_rescore or out["correct"] is False


def _patch_query(monkeypatch, fault):
    from gulon_tpu_torch.models.exact import ExactIndex
    from gulon_tpu_torch.models.flat import FlatIndex
    from gulon_tpu_torch.models.ivf import IVFIndex

    for cls in (FlatIndex, IVFIndex, ExactIndex):
        original = cls.query_arrays

        def broken(self, k, vectors, _original=original):
            d, i = _original(self, k, vectors)
            return fault(self, d.clone(), i.clone())

        monkeypatch.setattr(cls, "query_arrays", broken)


def _stale():
    first = {}

    def fault(index, d, i):  # a step that returns its state unchanged
        key = (id(index), d.shape)
        first.setdefault(key, (d, i))
        return first[key]

    return fault


def _half(index, d, i):  # half of the batch left out, the rest copied over
    h = d.shape[0] // 2
    if h:
        d[h:2 * h], i[h:2 * h] = d[:h], i[:h]
    return d, i


def _altered(index, d, i):  # one answer altered where it is produced
    i[0, 0] = (i[0, 0] + 1) % index.size
    return d, i


@pytest.mark.parametrize("cell", ["glove100.batch1024", "sift128.ivf.batch1024",
                                  "gist960.exact.batch1024", "glove100.cached.batch1024"])
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_a_broken_query_path_is_not_correct(root, monkeypatch, cell, fault):
    _patch_query(monkeypatch, {"stale": _stale(), "half": _half, "altered": _altered}[fault])
    res, _, _ = tiny.run(root, cell, seconds=1.0)
    assert res["correct"] is False
    assert res["checks"]["dist_err"]["value"] > res["checks"]["dist_err"]["limit"]


@pytest.mark.parametrize("fault", ["untrained", "half", "altered"])
def test_a_broken_build_is_not_correct(root, monkeypatch, fault):
    import gulon_tpu_torch.models.build as build
    import gulon_tpu_torch.ops.pq as pq

    if fault == "untrained":  # the Lloyd steps return their state unchanged
        original = pq.fit_kmeans
        monkeypatch.setattr(pq, "fit_kmeans",
                            lambda x, cfg, *a, **kw: original(x, cfg._replace(max_iters=0), *a, **kw))
    else:
        original = build._encode_chunked

        def broken(pq_, x, chunk, mesh=None):
            codes = original(pq_, x, chunk, mesh)
            if fault == "half":  # half the rows left unencoded
                codes[codes.shape[0] // 2:] = 0
            else:
                codes[0, 0] = (codes[0, 0] + 1) % pq_.num_clusters
            return codes

        monkeypatch.setattr(build, "_encode_chunked", broken)
    res, _, _ = tiny.run(root, "glove100.build")
    assert res["correct"] is False


def test_rows_in_wrong_partitions_are_not_correct(root, monkeypatch):
    """Every tenth row put in the next partition: the residuals, codes and
    answers follow the wrong partitions consistently, so only the
    partition number sees it."""
    import gulon_tpu_torch.models.build as build

    original = build.fit_kmeans

    def misplaced(x, cfg, *a, **kw):
        res = original(x, cfg, *a, **kw)
        part = res.assignments.clone()
        part[::10] = (part[::10] + 1) % cfg.k
        return res._replace(assignments=part)

    monkeypatch.setattr(build, "fit_kmeans", misplaced)
    res, _, _ = tiny.run(root, "sift128.ivf.batch1024")
    assert res["correct"] is False
    assert res["checks"]["part_miss"]["value"] > 0.05


def test_the_control_is_not_correct_at_a_tiny_size(root):
    """The reference one precision below the configuration's, in the
    program's place, fails the check (at the cell's own size it runs on
    the card: ``h100bench/control.py``)."""
    from h100bench.spec import Spec

    for cell in tiny.CELLS:
        c = Spec(root).cell(cell)
        res, _, _ = tiny.run(
            root, cell, seconds=0.5,
            system_factory=lambda config, dev, c=c: ControlSystem(config, c.checks["control"], dev),
        )
        assert res["correct"] is False, cell


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(tiny.REPO / "h100bench" / "run.py"), "--workload",
         "glove100.batch1024", "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
    )
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card_is_correct():
    """On the card: ``python -m pytest -m cuda h100bench/tests``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(tiny.REPO / "h100bench" / "run.py"), "--workload",
         "glove100.batch1024", "--seed", str(2**31 + 9), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
