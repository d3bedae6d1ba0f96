"""Time P3's variants in two checkouts, in turns, on one card.

Each checkout of ``--tree LABEL=DIR`` first builds its
``csrc/kernel_probe.cu`` and ``csrc/adc_scan.cu`` (into its
``gulon_tpu_torch/_build/``, all checkouts at once) and prints the ptxas
report of each P3 instantiation: registers, spill bytes, and the codes of
ptxas's warnings (C7510-C7515: it serialized every ``wgmma`` of that
kernel). Then for each turn of ``--turns`` (labels, e.g.
``parent,pr,pr,parent``) a child process imports ``gulon_tpu_torch`` from
that checkout and prints one JSON line: at P3's headline shape
(``kernel_probe.shape_from_env({})``: 401,408 rows, m 8, K 256, dsub 13,
mdp 128, 1024 queries, operands from ``--seed``), each variant's device ms
(``probes.median_ms``) and whether it holds its plain version
(``chip_smoke._p3_check``); K1 on the same operands
(``chip_smoke.k1_on_p3_operands``); and the library calls
``chip_smoke.py`` reports beside them: ``torch.matmul`` of the queries
and the decoded rows (the contraction only) and one
``torch.nn.functional.embedding`` over the flattened codebook (the
decode only).

On the card (the parent unpacked with ``git archive`` into a directory
that ``.gitignore`` lists)::

    python3 scripts/p3_ab.py --tree parent=_chip/before --tree pr=. \\
        --turns parent,pr,pr,parent

A tree may also be ``LABEL=ablation:NAME``: a copy of this checkout's
``gulon_tpu_torch`` (under ``gulon_tpu_torch/_build/ablation/NAME/``) with
one edit of ``csrc/kernel_probe.cu`` or ``csrc/onehot_rs.cuh`` (``EDITS``;
an edit names the text it replaces and stops the script when that text
has changed):

- ``no_pingpong``: the consumers issue their groups side by side instead
  of taking turns at the tensor cores;
- ``decode_group4``: four k-steps a decode group, as P1 / P2 run, not
  eight;
- ``all_ksteps``: eight k16 steps (mdp 128), not ceil(m dsub / 16);
- ``free_feed``: the query ring filled once and never refilled (wrong
  scores: what the contraction path costs with no feed);
- ``free_select``: no epilogue after the contraction (nothing written:
  what the scores, the selection and the stores cost);
- ``free_compares``: the int recipe's A registers the raw codes, no
  compare (wrong rows: what the one-hot's compares cost);
- ``free_stores``: decoded lanes never stored (wrong rows: what the
  stores of the accumulators into the tile cost).

P1 / P2 share ``onehot_rs.cuh``; the edits touch what P3 runs.

The lines also go to ``chiprun_out/p3_ab.jsonl``. The children use this
checkout's ``chip_smoke.py`` helpers for operands and comparisons.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT / "scripts"))
from onehot_ab import ptxas_by_kernel  # noqa: E402

PKG = "gulon_tpu_torch"
_TURN_WAIT = "          if (w == 1 || turn > 0) bar_sync(kBarTurn + w, kConsumers);\n"
_TURN_PASS = ("          if (w == 0 || turn + 1 < n_turns) bar_arrive(kBarTurn + 1 - w, "
              "kConsumers);\n")
_FILL = ("            const int st = it % P.nst;\n"
         "            mbar_wait(&empty[st], ((it / P.nst) & 1) ^ 1);\n")
_STORE = ("        if (kch == 0 && js >= 0)\n"
          "          store<kImpl, N>(dst, acc, js, jp, col0, c0, c1, dsub, r0, warp, g, tq, scale);\n")
EDITS = {  # name -> [(file under csrc/ (kernel_probe.cu if omitted), old, new)]
    "no_pingpong": [(_TURN_WAIT, ""), (_TURN_PASS, "")],
    "decode_group4": [("constexpr int kDecodeSteps = 8;", "constexpr int kDecodeSteps = 4;")],
    "all_ksteps": [("  P.ksteps = (md + 15) / 16;", "  P.ksteps = 4 * P.nch;")],
    "free_feed": [(_FILL, "            if (it >= P.nst) continue;\n" + _FILL),
                  ("            mbar_wait(&full[st], (it / P.nst) & 1);",
                   "            mbar_wait(&full[st], 0);")],
    "free_select": [("          if (!real) continue;\n", "          continue;\n")],
    "free_compares": [("onehot_rs.cuh", "                                     : pair_int(code, k);",
                       "                                     : static_cast<uint32_t>(code);")],
    "free_stores": [("onehot_rs.cuh", _STORE, "")],
}


def make_variant(name: str) -> Path:
    """A copy of this checkout's package with the variant's edits; its root."""
    import shutil

    root = ROOT / PKG / "_build" / "ablation" / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / PKG, root / PKG, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for edit in EDITS[name]:
        src = root / PKG / "csrc" / (edit[0] if len(edit) == 3 else "kernel_probe.cu")
        old, new = edit[-2:]
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to replace is not in {src.name} once:\n{old}")
        src.write_text(text.replace(old, new))
    return root


def build_child() -> dict:
    """Build the checkout's P3 and K1 libraries; P3's ptxas report."""
    from gulon_tpu_torch.ops.cuda import _build

    fresh = not _build.library_path("kernel_probe").exists()
    _build.build(["kernel_probe", "adc_scan"])
    out = dict(fresh_build=fresh)
    if fresh:
        out["ptxas"] = ptxas_by_kernel(_build.BUILD_INFO["kernel_probe"][1])
    return out


def child(seed: int, variants) -> dict:
    import torch

    import importlib.util

    # this checkout's chip_smoke helpers; the package comes from the cwd
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from gulon_tpu_torch.ops.cuda import adc
    from gulon_tpu_torch.probes import kernel_probe as kp
    from gulon_tpu_torch.probes import median_ms

    kp._kernel()
    hs = kp.shape_from_env({})
    ops = kp.probe_operands(hs["n"], hs["m"], hs["k_codes"], hs["dsub"], hs["mdp"],
                            hs["num_q"], hs["t"], seed=seed)
    dec = kp.decoded_rows(ops[0], ops[3], hs["mdp"])
    out = dict(package=str(Path(kp.__file__).resolve().parents[2]), p3={})
    for variant in variants or kp.VARIANTS:
        run = kp.make(variant, *ops, tile_rows=hs["t"], query_tile=hs["qt"])
        got = run()
        torch.cuda.synchronize()
        ref = kp.plain(variant, *ops, tile_rows=hs["t"], query_tile=hs["qt"])
        i8 = kp.quantize_codebooks(ops[3]) if kp.spec(variant)[1] == "i8" else None
        vdec = dec if i8 is None else kp.decoded_rows(ops[0], ops[3], hs["mdp"], i8)
        ids = got[1]
        if bool(((ids < 0) | (ids >= ops[0].shape[1])).any()):  # an ablation's garbage ids
            case = dict(ok=False, max_abs_err=float("nan"))
        else:
            case = cs._p3_check(variant, got, ref, vdec, ops[1], ops[2])
        del got, ref, ids
        out["p3"][variant] = dict(ok=case["ok"], max_abs_err=case["max_abs_err"],
                                  ms=median_ms(run))
    k1_ops = cs.k1_on_p3_operands(*ops)
    nblk = hs["t"] // 128
    out["k1_ms"] = median_ms(lambda: adc.fused_block_scan(*k1_ops, winners=1, nblk=nblk))
    out["library_ms"] = dict(
        contraction=median_ms(lambda: torch.matmul(ops[2], dec.T)),
        decode=median_ms(cs.embedding_decode(ops[0], ops[3])),
    )
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR")
    parser.add_argument("--turns", default="", help="comma-separated labels (default: each tree once)")
    parser.add_argument("--variants", default="", help="comma-separated (default: all 26)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--child", choices=("build", "time"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    variants = [v for v in args.variants.split(",") if v]
    if args.child:
        out = build_child() if args.child == "build" else child(args.seed, variants)
        print(json.dumps(out), flush=True)
        return 0
    trees = {k: make_variant(v[len("ablation:"):]) if v.startswith("ablation:")
             else Path(v).resolve() for k, v in (t.split("=", 1) for t in args.tree)}
    trees = trees or {"this": ROOT}
    turns = args.turns.split(",") if args.turns else list(trees)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    def run(label, what):
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--child", what, "--seed",
             str(args.seed), "--variants", args.variants], cwd=trees[label],
            env=dict(os.environ, PYTHONPATH=str(trees[label])),
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
    with open(out_dir / "p3_ab.jsonl", "a") as log:
        builds = {label: run(label, "build") for label in trees}  # one nvcc each, together
        for label, proc in builds.items():
            ok &= result(proc, label=label, what="build")
        for turn, label in enumerate(turns):
            ok &= result(run(label, "time"), label=label, what="time", turn=turn)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
