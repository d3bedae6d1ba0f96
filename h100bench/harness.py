"""One run of one cell, start to result line (``run.py`` is its command).

Order: draw the data from the seed; set up the loop the traffic mix
names (build, warm up); run the window; read the device's peak memory;
export what the check judges and let the program's state go; then the
plain reference computes recall and the check's numbers, and the result
line is assembled. Nothing of the reference runs before the window
closes, and its time is not set-up.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from h100bench import check, corpus
from h100bench.loops import LOOPS, Run
from h100bench.reference import exact
from h100bench.reference.recall import cutoff_hits
from h100bench.roofline import PEAKS
from h100bench.spec import Spec
from h100bench.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "gulon_tpu", "benchmarks")
RECALL_SLACK = 1e-9  # float64 rounding room in the cutoff comparison
_RECALL_BLOCK = 1 << 16


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark must not
    load, compared whole (``gulon_tpu_torch`` is not ``gulon_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def recall_at_k(
    x: torch.Tensor, q: torch.Tensor, query_rows: np.ndarray, rows: np.ndarray, k: int
) -> float:
    """Distance-cutoff recall@k of every answer against the exact k nearest."""
    dev = x.device
    uniq, inverse = np.unique(query_rows, return_inverse=True)
    qu = q[torch.from_numpy(uniq).to(dev)]
    _, nn = exact.topk_smallest(qu, x, k)
    kth = exact.sq_dist_rows(qu, x[nn[:, -1]])
    hits = 0
    for s in range(0, len(rows), _RECALL_BLOCK):
        r = torch.from_numpy(rows[s : s + _RECALL_BLOCK]).to(dev)
        inv = torch.from_numpy(inverse[s : s + _RECALL_BLOCK]).to(dev)
        valid = (r >= 0) & (r < x.shape[0])
        d = exact.sq_dist_rows(qu[inv], x[torch.where(valid, r, 0)])
        hits += int(cutoff_hits(d, valid, kth[inv], RECALL_SLACK).sum())
    return hits / (len(rows) * k)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(
    root: Path,
    workload: str,
    seed: int,
    seconds: float,
    trace: bool,
    device,
    *,
    t_start: float,
    out_dir: Path,
    system_factory=None,
) -> Tuple[dict, List[str], List[str]]:
    """``(result, lines before the result, last lines for standard error)``.

    ``system_factory(config, device)`` stands another system in the
    program's place (the control)."""
    from h100bench.systems import PortSystem

    device = torch.device(device)
    spec = Spec(root)
    cell = spec.cell(workload)
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in cell.per_layer} if trace else {}
    limits = {k: float(v["limit"]) for k, v in cell.checks["numbers"].items()}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    limit_w = power_limit() if device.type == "cuda" else None

    corpus_host, queries_host = corpus.make(cell.config, device)
    system = (system_factory or PortSystem)(cell.config, device)
    tracer = Tracer(trace, out_dir / f"{workload}.{seed}", seconds)
    loop = LOOPS[cell.traffic["loop"]](Run(
        traffic=cell.traffic, seed=seed, seconds=seconds, system=system,
        corpus=corpus_host, queries=queries_host, tracer=tracer,
    ))
    loop.setup()
    _sync(device)
    # what set-up left behind is not scanned again by collections in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    compile_s = system.compile_seconds() if hasattr(system, "compile_seconds") else 0.0
    loop.window()
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    view = tracer.view() if trace else None
    outcome = loop.close()
    del loop, system
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules the benchmark must not load are loaded: {bad}")

    # the reference, from the raw data
    x = torch.from_numpy(corpus_host).to(device, torch.float64)
    q = torch.from_numpy(queries_host).to(device, torch.float64)
    if cell.config["index"]["metric"] == "cosine":
        x, q = exact.normalized(x), exact.normalized(q)
    e2e: Dict[str, float] = dict(outcome.e2e, setup_s=setup_s)
    names = [m["name"] for m in cell.end_to_end]
    if "recall_at_10" in names and outcome.answered is not None:
        e2e["recall_at_10"] = recall_at_k(x, q, *outcome.answered, k=10)
    nums = check.numbers(limits, outcome.state, x, q, outcome.answers)
    correct = outcome.failed == 0 and outcome.attempted > 0 and all(
        nums[n] <= limits[n] for n in limits
    )

    if trace:
        metrics = {}
        for m in cell.per_layer:
            ctx = SimpleNamespace(view=view, config=cell.config, traffic=cell.traffic,
                                  peaks=PEAKS.get(kind))
            value = readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": kind,
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
        "power_limit": limit_w,
    }
    result = {
        "correct": bool(correct),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        result["breakdown"] = view.breakdown
    # the port's kernel builds inside setup_s (0 once the checkout's build
    # cache holds them), apart, so a first run's setup_s can be told apart
    result["compile_s"] = compile_s
    result["checks"] = {n: {"value": nums[n], "limit": limits[n]} for n in limits}
    err = [
        f"check {n} {nums[n]!r} limit {limits[n]!r} {'ok' if nums[n] <= limits[n] else 'FAIL'}"
        for n in limits
    ] + [f"check failed {outcome.failed} of {outcome.attempted} attempted"]
    notes = [f"compile_s {compile_s!r} of setup_s {setup_s!r}"] + outcome.notes
    return result, notes, err

