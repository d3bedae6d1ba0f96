#!/usr/bin/env python3
"""The control of a cell's correctness check, at the cell's own size.

    python3 h100bench/control.py --workload <cell> --seeds 11,12,13 [--seconds 2]

runs the cell with the plain reference in the program's place, one
precision below the one the configuration states (``checks/<cell>.json``,
``control``), and prints the check's numbers beside their limits, one JSON
line a seed: the check must find the control not correct. With
``--program-index '{"exact_rescore": false}'`` the control is instead the
program with its own lower path switched on: the configuration's
``index`` section with those fields changed. The benchmark's runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def run(workload: str, seed: int, seconds: float, device, program_index=None) -> dict:
    from h100bench.harness import run_cell
    from h100bench.reference.control import ControlSystem
    from h100bench.spec import Spec
    from h100bench.systems import PortSystem

    cell = Spec(ROOT).cell(workload)
    if program_index is None:
        control = cell.checks["control"]
        factory = lambda config, dev: ControlSystem(config, control, dev)  # noqa: E731
    else:
        control = {"program_index": program_index}
        factory = lambda config, dev: PortSystem(  # noqa: E731
            dict(config, index=dict(config["index"], **program_index)), dev)
    result, _, _ = run_cell(
        ROOT, workload, seed, seconds, False, device, t_start=time.perf_counter(),
        out_dir=ROOT / "h100bench" / "out", system_factory=factory,
    )
    return {"workload": workload, "seed": seed, "control": control,
            "correct": result["correct"], "checks": result["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--program-index", type=json.loads, default=None)
    a = p.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(run(a.workload, seed, a.seconds, a.device, a.program_index)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
