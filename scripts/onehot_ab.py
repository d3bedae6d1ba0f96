"""Time P1 / P2 and their decodes in two checkouts, in turns, on one card.

Each checkout of ``--tree LABEL=DIR`` first builds its
``csrc/adc_probes.cu`` (into its ``gulon_tpu_torch/_build/``, all
checkouts at once) and prints the ptxas report of each kernel
instantiation: registers, spill bytes, and the codes of ptxas's
warnings (C7510-C7515: it serialized every ``wgmma`` of that kernel).
Then for each turn of ``--turns`` (labels, e.g. ``parent,pr,pr,parent``)
a child process imports ``gulon_tpu_torch`` from that checkout and
prints one JSON line:

- at ``chip_smoke.py``'s two probe shapes (glove100, deep768), each
  decode alone (``probe_decode_rows``) and P1 / P2's scan for each decode
  mode, with K1 on the same operands: device ms (``probes.median_ms``)
  and whether the result agrees with its plain version (the decoded rows
  bit for bit but for the sign of a zero; the scans by
  ``chip_smoke.compare_packed``).

On the card (the parent unpacked with ``git archive`` into a directory
that ``.gitignore`` lists)::

    python3 scripts/onehot_ab.py --tree parent=_chip/before --tree pr=. \\
        --turns parent,pr,pr,parent

The lines also go to ``chiprun_out/onehot_ab.jsonl``. The children use
this checkout's ``chip_smoke.py`` helpers for operands and comparisons.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("take", "base", "bf16cmp")
_SERIALIZED = re.compile(r"\((C75\d\d)\).*?function '([^']+)'")


def _demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {n: n for n in names}


def _short(name: str) -> str:
    """``adc_probe_kernel<1, false, false, true>`` from a demangled name."""
    found = re.search(r"(\w+<[^()]*>)\(", name)
    return found.group(1) if found else name


def ptxas_by_kernel(report: str) -> dict:
    """Registers, spill bytes and warning codes of each entry function in
    an ``nvcc -Xptxas -v`` report."""
    kernels, cur, warned = {}, None, []
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            cur = entry.group(1)
            kernels[cur] = dict(registers=None, spill_stores=0, spill_loads=0, warnings=[])
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and cur:
            kernels[cur]["spill_stores"], kernels[cur]["spill_loads"] = map(int, spill.groups())
        regs = re.search(r"Used (\d+) registers", line)
        if regs and cur:
            kernels[cur]["registers"] = int(regs.group(1))
        serial = _SERIALIZED.search(line)
        if serial:
            warned.append(serial.groups())
    for code, fn in warned:
        kernels.setdefault(fn, dict(registers=None, spill_stores=0, spill_loads=0,
                                    warnings=[]))["warnings"].append(code)
    names = _demangle(list(kernels))
    return {_short(names[k]): v for k, v in kernels.items()}


def build_child() -> dict:
    """Build the checkout's ``adc_probes`` library; its ptxas report."""
    from gulon_tpu_torch.ops.cuda import _build

    fresh = not _build.library_path("adc_probes").exists()
    _build.build(["adc_probes"])
    out = dict(fresh_build=fresh)
    if fresh:
        out["ptxas"] = ptxas_by_kernel(_build.BUILD_INFO["adc_probes"][1])
    return out


def child(seed: int) -> dict:
    import torch

    sys.path.append(str(ROOT))  # chip_smoke's helpers; the package comes from the cwd
    import chip_smoke as cs
    from gulon_tpu_torch.ops.cuda import adc
    from gulon_tpu_torch.probes import adc_probes as ap
    from gulon_tpu_torch.probes import median_ms

    ap._kernel()
    out = dict(package=str(Path(ap.__file__).resolve().parents[1]))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for label, (n, d, m, k_codes, q_n) in cs.PROBE_SHAPES.items():
        raw = cs.k1_inputs(gen, n, d, m, k_codes, q_n, dev="cuda")
        raw = dict(raw, codes=adc.pack_codes_t(raw["codes"], k_codes), num_rows=n)
        ops = ap.probe_scan_operands(**raw, center_scores=True)
        codes_t, norms_hl, cb = ops["codes_t"], ops["norms_hl"], ops["cb"]
        width = ops["q_op"].shape[1]
        plain_rows = ap._decode_rows_plain(codes_t, norms_hl, cb, width)
        res = dict(decode={}, p1={}, p2={})
        for mode in MODES:
            def dec(mode=mode):
                return ap.probe_decode_rows(codes_t, norms_hl, cb, width=width, decode_mode=mode)
            rows = dec()
            torch.cuda.synchronize()
            res["decode"][mode] = dict(
                ms=median_ms(dec), decoded_rows_exact=cs.rows_equal_but_zero_sign(rows, plain_rows))
            del rows
        del plain_rows
        for pipe in (False, True):
            for mode in MODES:
                ops = ap.probe_scan_operands(**raw, center_scores=True, decode_mode=mode,
                                             pipe=pipe)
                operands = (ops["codes_t"], ops["norms_hl"], ops["q_op"], ops["cb"])
                ran = ops["modes"]
                kw = dict(winners=1, nblk=ops["nblk"], decode_mode=ran["decode_mode"],
                          natural=ran["natural"], pipe=ran["pipe"])
                got = ap.probe_block_scan(*operands, **kw)
                torch.cuda.synchronize()
                ref = adc._block_scan_plain(*operands, winners=1, nblk=ops["nblk"])
                case = cs.compare_packed(got, ref)
                del got, ref
                res["p2" if ran["pipe"] else "p1"][ran["decode_mode"]] = dict(
                    ok=case["ok"], id_equal=case.get("id_equal"),
                    ms=median_ms(lambda: ap.probe_block_scan(*operands, **kw)),
                    k1_ms=median_ms(lambda: adc.fused_block_scan(*operands, winners=1,
                                                                 nblk=ops["nblk"])),
                    plan={k: ran["plan"][k] for k in ("streamed", "slots", "stages", "lanes",
                                                      "pieces", "resident", "bufs")},
                )
        out[label] = res
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR")
    parser.add_argument("--turns", default="", help="comma-separated labels (default: each tree once)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--child", choices=("build", "time"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        out = build_child() if args.child == "build" else child(args.seed)
        print(json.dumps(out), flush=True)
        return 0
    trees = {k: Path(v).resolve() for k, v in (t.split("=", 1) for t in args.tree)}
    trees = trees or {"this": ROOT}
    turns = args.turns.split(",") if args.turns else list(trees)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    def run(label, what):
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--child", what, "--seed",
             str(args.seed)], cwd=trees[label], env=dict(os.environ, PYTHONPATH=str(trees[label])),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(proc, **line):
        out, err = proc.communicate()
        line.update(card=smi, rc=proc.returncode)
        if proc.returncode == 0:
            line.update(json.loads(out.strip().splitlines()[-1]))
        else:
            line["stderr"] = err[-4000:]
        print(json.dumps(line), flush=True)
        log.write(json.dumps(line) + "\n")
        return proc.returncode == 0

    ok = True
    with open(out_dir / "onehot_ab.jsonl", "a") as log:
        builds = {label: run(label, "build") for label in trees}  # one nvcc each, together
        for label, proc in builds.items():
            ok &= result(proc, label=label, what="build")
        for turn, label in enumerate(turns):
            ok &= result(run(label, "time"), label=label, what="time", turn=turn)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
