"""BENCHMARK.json and the files its names lead to."""

import json
import re
import shutil

import h100bench_tiny as tiny
from h100bench.spec import Spec

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bad_names(bench: dict) -> list:
    """Every name, unit and reduced key of ``bench`` that breaks the
    character rules."""
    bad = []

    def name(v) -> None:
        if not isinstance(v, str) or not NAME_RE.match(v):
            bad.append(repr(v))

    for c in bench.get("configs", []):
        name(c["name"])
        for key in c.get("reduced", []):
            name(key)
    for w in bench.get("workloads", []):
        for key in ("name", "config", "traffic"):
            name(w[key])
    for kind in ("end_to_end", "per_layer"):
        for m in bench.get(kind, []):
            name(m["name"])
            if not UNIT_RE.match(m["unit"]):
                bad.append(repr(m["unit"]))
    return bad

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_pieces_by_name():
    spec = Spec(tiny.REPO)
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["loop"] in ("closed_batch", "build_loop")
        assert cell.checks["numbers"] and cell.checks["control"]
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))


def test_names_and_units_keep_the_character_rules():
    assert bad_names(BENCH) == []
    assert bad_names({"configs": [{"name": "a b", "reduced": ["x/y"]}]}) == ["'a b'", "'x/y'"]
    assert bad_names({"end_to_end": [{"name": "ok", "unit": "tokens per s"}]}) == ["'tokens per s'"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    spec = Spec(tiny.REPO)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        names = {m["name"] for m in spec.metrics_of("end_to_end", w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics_of("per_layer", w["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = {x["name"]: x for x in BENCH["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))


def test_a_cell_added_as_data_is_found(tmp_path):
    """A new configuration, mix, metric and cell: files and entries only."""
    root = tmp_path
    shutil.copy(tiny.REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(tiny.REPO / "h100bench" / "configs", root / "h100bench" / "configs")
    for sub in ("traffic", "checks", "metrics"):
        shutil.copytree(tiny.REPO / "h100bench" / sub, root / "h100bench" / sub)
    h = root / "h100bench"
    (h / "configs" / "tiny-flat.json").write_text(json.dumps(tiny.tiny_config("flat")))
    (h / "traffic" / "batch8.json").write_text(json.dumps({"loop": "closed_batch", "batch": 8, "k": 10}))
    (h / "checks" / "tiny.batch8.json").write_text(json.dumps(
        {"numbers": {"dist_err": {"limit": 1e-5}}, "control": {"scan": "tf32"}}))
    (h / "metrics" / "batches_traced.py").write_text("def read(ctx):\n    return ctx.view.units\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-flat", "source": "test", "reduced": [], "why": "test",
                             "file": "h100bench/configs/tiny-flat.json"})
    bench["workloads"].append({"name": "tiny.batch8", "config": "tiny-flat", "traffic": "batch8",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("tiny.batch8")
    bench["per_layer"].append({"name": "batches_traced", "unit": "batches", "better": "higher",
                               "source": "device_trace", "layer": "device", "moves": "qps",
                               "workloads": ["tiny.batch8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _, _ = tiny.run(root, "tiny.batch8", trace=True)
    assert result["correct"] is True
    assert result["metrics"]["batches_traced"]["value"] >= 1
    result, _, _ = tiny.run(root, "tiny.batch8")
    assert set(result["metrics"]) == {"qps", "setup_s"}
