"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at ``root``) lists configurations, cells and metrics.
Each piece a cell needs is a file found by its name:

- configuration: the ``file`` its entry names (``configs/<name>.json``);
- traffic mix: ``h100bench/traffic/<traffic>.json``;
- per-layer metric: ``h100bench/metrics/<metric>.py``, whose ``read(ctx)``
  returns the value or ``None`` where it finds nothing to read;
- what the correctness check compares, with each limit and the control:
  ``h100bench/checks/<cell>.json``.

A new cell, configuration, mix or metric is new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import List

HARNESS_DIR = "h100bench"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its pieces loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: List[dict]
    per_layer: List[dict]


class Spec:
    """``BENCHMARK.json`` under ``root``, and the files its names lead to."""

    def __init__(self, root):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for entry in self.bench[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    def _json(self, rel: str) -> dict:
        return json.loads((self.root / rel).read_text())

    def metrics_of(self, kind: str, workload: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
        that list it, and those that list no cells."""
        return [
            m for m in self.bench[kind]
            if workload in m.get("workloads", [workload])
        ]

    def cell(self, workload: str) -> Cell:
        w = self._entry("workloads", workload)
        conf = self._entry("configs", w["config"])
        return Cell(
            name=workload,
            chips=int(w["chips"]),
            config=self._json(conf["file"]),
            traffic=self._json(f"{HARNESS_DIR}/traffic/{w['traffic']}.json"),
            checks=self._json(f"{HARNESS_DIR}/checks/{workload}.json"),
            end_to_end=self.metrics_of("end_to_end", workload),
            per_layer=self.metrics_of("per_layer", workload),
        )

    def metric_reader(self, name: str):
        """``read(ctx)`` of ``h100bench/metrics/<name>.py``."""
        path = self.root / HARNESS_DIR / "metrics" / f"{name}.py"
        mod_spec = importlib.util.spec_from_file_location(
            "h100bench_metric_" + re.sub(r"\W", "_", name), path
        )
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        return module.read

