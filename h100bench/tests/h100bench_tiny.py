"""A tiny copy of the benchmark, for the CPU tests: the real metric
readers, BENCHMARK.json's metrics, and cells of the same names at a size
a test run holds, written as data under a temporary root."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

CELLS = {  # real cell -> (tiny configuration, traffic)
    "glove100.batch1024": ("tiny-flat", "batch1024"),
    "sift128.ivf.batch1024": ("tiny-ivf", "batch1024"),
    "glove100.build": ("tiny-flat", "build.back-to-back"),
    "gist960.exact.batch1024": ("tiny-exact", "batch1024"),
    "glove100.cached.batch1024": ("tiny-cached", "batch1024"),
}
KINDS = ("flat", "ivf", "exact", "cached")
# limits at the tiny size: sound CPU runs read far below them
TINY_LIMITS = {
    "dist_err": 1e-5, "adc_miss": 0.05, "code_gap": 1e-5, "lloyd_gain": 0.01,
    "norm_err": 1e-5, "coarse_gain": 0.01, "part_miss": 0.0, "row_err": 0.0,
}
_INDEX = {
    "flat": {"kind": "flat", "metric": "cosine"},
    "ivf": {"kind": "ivf", "metric": "l2", "partitions": 8, "probe": 2},
    "exact": {"kind": "exact", "metric": "l2", "operand": "bf16", "rescore_factor": 4,
              "exact_rescore": True, "strategy": "auto"},
    "cached": {"kind": "flat", "metric": "cosine", "cache": True},
}


def tiny_config(kind: str) -> dict:
    index = dict(_INDEX[kind])
    if kind != "exact":
        index["pq"] = {"num_clusters": 16, "num_quantizers": 4, "max_iters": 100, "seed": 0}
    return {
        "name": f"tiny-{kind}",
        "dataset": {"n": 4096, "d": 16, "queries": 300, "k": 10},
        "corpus": {"recipe": "low_rank", "intrinsic": 8, "clusters": 50, "noise": 0.05, "seed": 3},
        "index": index,
    }


def make_root(tmp: Path, *, real_limits: bool = False) -> Path:
    """A root with BENCHMARK.json and ``h100bench/`` data for the cells at
    the tiny size, with the real traffic mixes."""
    h = tmp / "h100bench"
    for sub in ("configs", "traffic", "checks"):
        (h / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "h100bench" / "metrics", h / "metrics", dirs_exist_ok=True)
    for kind in KINDS:
        (h / "configs" / f"tiny-{kind}.json").write_text(json.dumps(tiny_config(kind)))
    for _, traffic in CELLS.values():
        shutil.copy(REPO / "h100bench" / "traffic" / f"{traffic}.json", h / "traffic")
    for cell in CELLS:
        checks = json.loads((REPO / "h100bench" / "checks" / f"{cell}.json").read_text())
        if not real_limits:
            for name, entry in checks["numbers"].items():
                entry["limit"] = TINY_LIMITS[name]
        (h / "checks" / f"{cell}.json").write_text(json.dumps(checks))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": f"tiny-{k}", "source": "test", "file": f"h100bench/configs/tiny-{k}.json",
         "reduced": [], "why": "test"} for k in KINDS
    ]
    bench["workloads"] = [
        {"name": cell, "config": conf, "traffic": traffic, "chips": 1, "why": "test"}
        for cell, (conf, traffic) in CELLS.items()
    ]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run(root: Path, cell: str, seed: int = 5, seconds: float = 0.5, trace: bool = False, **kw):
    from h100bench.harness import run_cell

    return run_cell(root, cell, seed, seconds, trace, "cpu", t_start=time.perf_counter(),
                    out_dir=root / "out", **kw)
