#!/usr/bin/env python3
"""Run one cell of the H100 benchmark of ``gulon_tpu_torch``.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, on a machine with
as many CUDA cards as the cell asks for (it exits 3 without them). The
last line of standard output is the result, one JSON object; the numbers
the check compared, each with its limit, are the last lines of standard
error. With ``--trace 1`` the metrics are the cell's per-layer ones, and
the profiler's table and Chrome trace land in ``h100bench/out/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "h100bench"
# every build and kernel cache at a fixed place inside the checkout (the
# port's own nvcc builds land in gulon_tpu_torch/_build/)
for var, sub in (
    ("TRITON_CACHE_DIR", "triton"),
    ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
    ("CUDA_CACHE_PATH", "nv"),
):
    os.environ[var] = str(HERE / ".cache" / sub)
# one process on one fixed core (the last it may use; left to the
# scheduler, the driving thread lands on another core in every run), with
# one host thread for tensor work
os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from h100bench.harness import run_cell
    from h100bench.spec import Spec

    chips = Spec(ROOT).cell(a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(
            f"{a.workload} needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 3
    torch.set_num_threads(1)
    try:
        result, notes, err = run_cell(
            ROOT, a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
            t_start=T_START, out_dir=HERE / "out",
        )
    except Exception:  # noqa: BLE001 - a failed run prints no result
        traceback.print_exc()
        return 1
    for line in notes:
        print(line, flush=True)
        print(line, file=sys.stderr)
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
