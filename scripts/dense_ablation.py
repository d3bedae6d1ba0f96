#!/usr/bin/env python3
"""Where the time of the dense kernels K3 and K2 goes, on one CUDA card.

Times the kernels at the exact path's shapes (K3 on 2,000,000 x 320 int8,
K2 on 2,000,000 x 304 bf16, 1024 queries each) with parts of
``csrc/dense_scan.cu`` taken out:

- ``full``: the kernel as it is;
- ``no_pingpong``: the two consumer warpgroups contract side by side
  instead of taking turns at the tensor cores;
- ``no_select``: the block minimum replaced by one accumulator (the
  contraction, the TMA ring and the stores);
- ``no_contract``: no ``wgmma`` (the ring, the selection and the stores);
- ``feed_only``: neither (the ring and the stores).

Run from the root of a checkout: ``python3 scripts/dense_ablation.py
[--variants full,no_select,...] [--rounds 2]``. Each variant is a copy of
``gulon_tpu_torch`` under ``gulon_tpu_torch/_build/ablation/`` with one
edit, built and timed in a process of its own; the variants run in turns,
``--rounds`` times. An edit names the kernel's source text it replaces and
stops the script when that text has changed. Each timing is the card's
time of one call, the median of 10 readings after 3 warm-ups
(``gulon_tpu_torch.probes.median_ms``: back-to-back calls queued behind a
sleep kernel). Prints one JSON line per variant and round, the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "gulon_tpu_torch"

_CONTRACT = """  using namespace hopper;
  const uint64_t desc_b = sw128_desc(rows);
  wgmma_fence();"""
_SELECT = """        pack_rows(acc[t], lane);
        const Acc v0 = block_min<0>(acc[t], lane);
        const Acc v1 = block_min<1>(acc[t], lane);"""
_NO_SELECT = """        const Acc v0 = acc[t][0];
        const Acc v1 = acc[t][2];"""
# the accumulators hold data-dependent values, so no selection is folded
# away; the loops are unrolled, or the accumulators would go to local memory
_NO_CONTRACT = """  using namespace hopper;
  if (step == 0)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[t][i] = static_cast<typename Op::Acc>(i + (rows[0] & 1));
  return;
  const uint64_t desc_b = sw128_desc(rows);
  wgmma_fence();"""
_PINGPONG = "  const bool pingpong = nst >= nch;"

EDITS = {
    "full": [],
    "no_pingpong": [(_PINGPONG, "  const bool pingpong = false;")],
    "no_select": [(_SELECT, _NO_SELECT)],
    "no_contract": [(_CONTRACT, _NO_CONTRACT)],
    "feed_only": [(_CONTRACT, _NO_CONTRACT), (_SELECT, _NO_SELECT)],
}
# variants whose output must still equal the plain version's
EXACT = ("full", "no_pingpong")


def make_variant(name: str) -> Path:
    """A copy of the package with the variant's edits; returns its root."""
    root = ROOT / PKG / "_build" / "ablation" / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / PKG, root / PKG, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / PKG / "csrc" / "dense_scan.cu"
    text = src.read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: the edited code is not in dense_scan.cu")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def worker(root: str, label: str) -> None:
    """Time the kernels of the package under ``root``; print one line."""
    sys.path[:0] = [root, str(ROOT)]
    import torch

    import chip_smoke as cs
    from gulon_tpu_torch.ops.cuda import _build, dense
    from gulon_tpu_torch.probes import median_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"variant": label}
    data, q = cs.k2_operands(gen, 2_000_000, 300, 1024, False, dev="cuda")
    out["k2_2m_304"] = median_ms(lambda: dense.dense_block_scan(data, q))
    del data, q
    data = torch.randint(-127, 128, (2_000_000, 320), generator=gen, device="cuda").to(torch.int8)
    q = torch.randint(-127, 128, (1024, 320), generator=gen, device="cuda").to(torch.int8)
    out["k3_2m_320"] = median_ms(lambda: dense.dense_block_scan_i8(data, q))
    if label in EXACT:
        got = dense.dense_block_scan_i8(data, q)
        out["k3_equal"] = bool(torch.equal(got, dense._dense_block_scan_plain_i8(data, q)))
    out["ptxas_warnings"] = sorted({
        line.strip() for _, report in _build.BUILD_INFO.values()
        for line in report.splitlines() if "C7519" in line or "C7517" in line
    })
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(EDITS))
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--worker", nargs=2, metavar=("ROOT", "LABEL"), help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker(*args.worker)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("dense_ablation: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    roots = {name: make_variant(name) for name in args.variants.split(",")}
    for _ in range(args.rounds):
        for label, root in roots.items():
            subprocess.run([sys.executable, __file__, "--worker", str(root), label], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
